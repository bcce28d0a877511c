"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here takes the `cuda_device` fixture and skips where no CUDA
card is present: the kernels have no CPU mode. The file imports neither JAX
nor the JAX package, so that it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py -q

(`--noconftest`, because tests/conftest.py sets up JAX for the other tests.)
Inputs are made with numpy from fixed seeds.
"""

import numpy as np
import pytest
import torch

from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.infer import Predictor
from rlt_tpu_torch.ops import attention, lstm

# f32 on both sides. The kernel sums each step's 128-term dot products in
# another order than the plain version's matrix product, and the LSTM
# carries that difference through up to 300 steps of h and c.
LSTM_ATOL = 1e-4
# 64-term dot products and 300-term softmax sums in another order; o is O(1).
ATTN_ATOL = 1e-5
# Cut distributions of the whole model: softmaxes over 300 positions.
DIST_ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lstm_inputs(seed, length, batch, hidden):
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(length, batch, 4 * hidden)).astype(np.float32)
    w_hh_t = (rng.uniform(-1, 1, size=(hidden, 4 * hidden))
              / np.sqrt(hidden)).astype(np.float32)
    return xw, w_hh_t


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


# batches that give the kernel 1, 2 and 4 rows per block, with ragged tails
@pytest.mark.parametrize("length,batch", [(16, 3), (300, 63), (300, 256), (40, 301)])
def test_lstm_kernel_matches_plain_on_card(cuda_device, length, batch):
    xw, w_hh_t = (torch.from_numpy(a).to(cuda_device)
                  for a in _lstm_inputs(7, length, batch, 128))
    before = lstm.LSTM_FWD.launches
    hs, cs = lstm.lstm_fwd(xw, w_hh_t)
    torch.cuda.synchronize()
    assert lstm.LSTM_FWD.launches == before + 1
    want_hs, want_cs = lstm.lstm_recurrence_plain(xw, w_hh_t)
    torch.testing.assert_close(hs, want_hs, rtol=0, atol=LSTM_ATOL)
    torch.testing.assert_close(cs, want_cs, rtol=0, atol=LSTM_ATOL)


@pytest.mark.parametrize("n,length", [(2, 128), (3, 37), (9, 300)])
def test_attention_kernel_matches_plain_on_card(cuda_device, n, length):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(8, (n, length, 256)))
    before = attention.ATTENTION_PACKED_FWD.launches
    o, lse = attention.fused_attention_packed(q, k, v, heads=4, pack=2)
    torch.cuda.synchronize()
    assert attention.ATTENTION_PACKED_FWD.launches == before + 1
    want_o, want_lse = attention.attention_packed_plain(q, k, v, 4, 2)
    torch.testing.assert_close(o, want_o, rtol=0, atol=ATTN_ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=ATTN_ATOL)


def test_kernel_wrappers_reject_on_card(cuda_device):
    q = torch.zeros(1, 8, 256, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        attention.fused_attention_packed(q, q, q, heads=4, pack=2)
    q = torch.zeros(1, 8, 256, device=cuda_device)
    with pytest.raises(ValueError, match="dh = 64"):
        attention.fused_attention_packed(q, q, q, heads=8, pack=8)
    xw = torch.zeros(4, 8, 512, device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        lstm.lstm_fwd(xw, torch.zeros(128, 512, device=cuda_device))


def test_mmoecut_on_card_matches_cpu(cuda_device):
    """MMOECut at robust04 width through both kernels on the card against
    the same seeded model on the CPU (plain versions): distributions within
    DIST_ATOL, cuts equal where the top two positions are further apart."""
    cfg = TrainConfig(model_name="mmoecut", retrieve_data="robust04")
    card = Predictor(cfg, device=cuda_device)
    cpu = Predictor(cfg, device="cpu")
    x = np.random.default_rng(9).normal(
        size=(3, cfg.seq_len, cfg.input_size)).astype(np.float32)
    before = (lstm.LSTM_FWD.launches, attention.ATTENTION_PACKED_FWD.launches)
    ks, dist = card.predict_with_distribution(x)
    assert (lstm.LSTM_FWD.launches - before[0],
            attention.ATTENTION_PACKED_FWD.launches - before[1]) == (4, 1)
    want_ks, want_dist = cpu.predict_with_distribution(x)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=DIST_ATOL)
    top2 = np.sort(want_dist, axis=-1)[:, -2:]
    tied = top2[:, 1] - top2[:, 0] <= DIST_ATOL
    assert np.all((ks == want_ks) | tied)
