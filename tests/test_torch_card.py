"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here takes the `cuda_device` fixture and skips where no CUDA
card is present: the kernels have no CPU mode. The file imports neither JAX
nor the JAX package, so that it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py -q

(`--noconftest`, because tests/conftest.py sets up JAX for the other tests.)
Inputs are made with numpy from fixed seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rlt_tpu_torch.config import TrainConfig, apply_preset
from rlt_tpu_torch.data import synthetic_dataset
from rlt_tpu_torch.infer import Predictor
from rlt_tpu_torch.models import ZERO_GRAD_LEAVES
from rlt_tpu_torch.ops import KERNELS, attention, lstm, plain_ops
from rlt_tpu_torch.train import Trainer, train_step

# f32 on both sides. The kernel sums each step's 128-term dot products in
# another order than the plain version's matrix product, and the LSTM
# carries that difference through up to 300 steps of h and c.
LSTM_ATOL = 1e-4
# 64- or 128-term dot products and 300-term softmax sums in another order;
# o is O(1).
ATTN_ATOL = 1e-5
# Cut distributions of the whole model: softmaxes over 300 positions.
DIST_ATOL = 1e-5
# K2' against the plain loop, relative to the gradient's max abs: the
# backward carries dh and dc through up to 300 steps, and dW_hh^T sums up to
# 76,500 (t, b) terms in another order (split chunks against a per-step sum).
LSTM_BWD_REL = 1e-4
# K6' and K4' against the plain version, relative to the gradient's max abs:
# sums of 300 products of 64- or 128-term dot products, in another order.
ATTN_BWD_REL = 1e-5
# One training step of a model through the kernels against the plain
# versions on the card, same weights and masks: the loss within 1e-5 relative; each
# parameter's gradient within 1e-3 of its max abs (the LSTM's 300-step
# chains, forward and backward, feed every gradient) plus 1e-7: a softmax
# tower's bias (and MtAttnCut's rerank bias, which its hinge cancels) has
# zero gradient by algebra, where both give rounding noise.
STEP_LOSS_REL = 1e-5
STEP_GRAD_REL = 1e-3
STEP_GRAD_FLOOR = 1e-7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lstm_inputs(seed, length, batch, hidden, ndir=1):
    """xw (L, ndir * B, 4H) and W_hh^T (ndir * H, 4H), ndir directions in
    the kernels' layout."""
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(length, ndir * batch, 4 * hidden)).astype(np.float32)
    w_hh_t = (rng.uniform(-1, 1, size=(ndir * hidden, 4 * hidden))
              / np.sqrt(hidden)).astype(np.float32)
    return xw, w_hh_t


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _max_rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _streams(seed, n, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31, size=n, dtype=np.int64)
                            .astype(np.int32)).to(device)


# batches that give the kernel 1, 2 and 4 rows per block, with ragged tails,
# for one direction and for both directions of a BiLSTM layer
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("length,batch", [(16, 3), (300, 63), (300, 256), (40, 301)])
def test_lstm_kernel_matches_plain_on_card(cuda_device, length, batch, ndir):
    xw, w_hh_t = (torch.from_numpy(a).to(cuda_device)
                  for a in _lstm_inputs(7, length, batch, 128, ndir))
    before = lstm.LSTM_FWD.launches
    hs, cs = lstm.lstm_fwd(xw, w_hh_t, ndir)
    torch.cuda.synchronize()
    assert lstm.LSTM_FWD.launches == before + 1
    want_hs, want_cs = lstm.lstm_recurrence_plain(xw, w_hh_t, ndir)
    torch.testing.assert_close(hs, want_hs, rtol=0, atol=LSTM_ATOL)
    torch.testing.assert_close(cs, want_cs, rtol=0, atol=LSTM_ATOL)


# K5' and K6' at ragged and whole 64-row tiles, at the main path's L = 300,
# and at L = 700, beyond what a head's K and V (or Q and dO) held whole in
# shared memory would allow
@pytest.mark.parametrize("n,length", [(2, 128), (3, 37), (9, 300), (3, 64), (2, 700),
                                      (4, 1)])
def test_attention_kernel_matches_plain_on_card(cuda_device, n, length):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(8, (n, length, 256)))
    before = attention.ATTENTION_PACKED_FWD.launches
    o, lse = attention.fused_attention_packed(q, k, v, heads=4, pack=2)
    torch.cuda.synchronize()
    assert attention.ATTENTION_PACKED_FWD.launches == before + 1
    want_o, want_lse = attention.attention_packed_plain(q, k, v, 4, 2)
    torch.testing.assert_close(o, want_o, rtol=0, atol=ATTN_ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=ATTN_ATOL)


def _lstm_bwd_inputs(seed, length, batch, ndir, device):
    xw, w_hh_t = (torch.from_numpy(a).to(device)
                  for a in _lstm_inputs(seed, length, batch, 128, ndir))
    hs, cs = lstm.lstm_recurrence_plain(xw, w_hh_t, ndir)
    dho = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=tuple(hs.shape)).astype(np.float32)).to(device)
    return xw, w_hh_t, hs, cs, dho


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("length,batch", [(16, 3), (300, 63), (300, 256), (40, 301),
                                          (1, 5)])
def test_lstm_bwd_kernel_matches_plain_on_card(cuda_device, length, batch, ndir):
    args = _lstm_bwd_inputs(10, length, batch, ndir, cuda_device)
    before = lstm.LSTM_BWD.launches
    dxw, dw = lstm.lstm_bwd(*args, ndir)
    torch.cuda.synchronize()
    assert lstm.LSTM_BWD.launches == before + 1
    want_dxw, want_dw = lstm.lstm_bwd_plain(*args, ndir)
    assert _max_rel_err(dxw, want_dxw) <= LSTM_BWD_REL
    if length > 1:
        assert _max_rel_err(dw, want_dw) <= LSTM_BWD_REL
    else:
        assert torch.equal(dw, torch.zeros_like(dw))


def test_lstm_bwd_kernel_is_deterministic_on_card(cuda_device):
    """Both directions at the main path's shape: every gradient element is
    summed in a fixed order, with no atomics, so two launches on the same
    inputs give the same bits."""
    args = _lstm_bwd_inputs(32, 300, 63, 2, cuda_device)
    first = lstm.lstm_bwd(*args, 2)
    second = lstm.lstm_bwd(*args, 2)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("members", [2, 4])
def test_member_batched_lstm_kernels_match_plain_on_card(cuda_device, members):
    """K1' and K2' over K population members' BiLSTM layers in one launch
    (ndir = 2K, each direction its own W_hh^T) at the main path's length
    and batch, against the plain versions; two K2' launches bit-equal."""
    ndir = 2 * members
    xw, w_hh_t = (torch.from_numpy(a).to(cuda_device)
                  for a in _lstm_inputs(40 + members, 300, 63, 128, ndir))
    hs, cs = lstm.lstm_fwd(xw, w_hh_t, ndir)
    torch.cuda.synchronize()
    want_hs, want_cs = lstm.lstm_recurrence_plain(xw, w_hh_t, ndir)
    assert (hs - want_hs).abs().max() <= LSTM_ATOL
    assert (cs - want_cs).abs().max() <= LSTM_ATOL
    args = _lstm_bwd_inputs(50 + members, 300, 63, ndir, cuda_device)
    first = lstm.lstm_bwd(*args, ndir)
    second = lstm.lstm_bwd(*args, ndir)
    torch.cuda.synchronize()
    for got, again, want in zip(first, second, lstm.lstm_bwd_plain(*args, ndir)):
        assert torch.equal(got, again)
        assert _max_rel_err(got, want) <= LSTM_BWD_REL


def test_population_step_launches_on_card(cuda_device):
    """One step of a population of three MMOECut members at robust04 width
    (its graph's capture and first replay) launches K1' and K2' twice each
    (one per BiLSTM layer over all members' directions) and K5' and K6' once
    each (all members' experts), not once per member, with a finite loss
    per member."""
    from rlt_tpu_torch.population import Member, Population

    cfg = dataclasses.replace(apply_preset(TrainConfig(model_name="mmoecut",
                                                       retrieve_data="robust04")),
                              synthetic_queries=40, batch_size=8)
    pop = Population(cfg, [Member(seed=s) for s in range(3)], device=cuda_device)
    idx, valid = pop.plans("train")
    kernels = (lstm.LSTM_FWD, lstm.LSTM_BWD, attention.ATTENTION_PACKED_FWD,
               attention.ATTENTION_PACKED_BWD)
    counts = [k.launches for k in kernels]
    out = pop.train_batch(idx[:, 0], valid[:, 0])  # (K, 3): loss, F1, DCG
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == [2, 2, 1, 1]
    assert out.shape == (3, 3) and torch.isfinite(out[:, 0]).all()


@pytest.mark.parametrize("n,length,heads", [(2, 128, 4), (3, 37, 6), (9, 300, 4),
                                            (3, 64, 4), (2, 700, 4), (4, 1, 4)])
def test_attention_dropout_kernel_matches_plain_on_card(cuda_device, n, length, heads):
    """Same streams on both sides: the kernel's keep mask is the plain
    version's, and at rate 0 the streams change nothing."""
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(12, (n, length, heads * 64)))
    streams = _streams(13, n, cuda_device)
    o, lse = attention.fused_attention_packed(q, k, v, heads=heads, pack=2,
                                              dropout_rate=0.1, streams=streams)
    want_o, want_lse = attention.attention_packed_plain(q, k, v, heads, 2, 0.1, streams)
    torch.testing.assert_close(o, want_o, rtol=0, atol=ATTN_ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=ATTN_ATOL)
    o0, _ = attention.fused_attention_packed(q, k, v, heads=heads, pack=2,
                                             dropout_rate=0.0, streams=streams)
    o_none, _ = attention.fused_attention_packed(q, k, v, heads=heads, pack=2)
    assert torch.equal(o0, o_none)
    assert not torch.allclose(o, o_none, atol=1e-3)


# (Not L = 1: there o = v, so dq and dk are zero by algebra and a relative
# check compares noise.)
@pytest.mark.parametrize("n,length,heads,rate", [(2, 128, 4, 0.0), (3, 37, 6, 0.1),
                                                 (9, 300, 4, 0.1), (4, 64, 4, 0.4),
                                                 (3, 64, 4, 0.0), (3, 64, 4, 0.1),
                                                 (2, 700, 4, 0.0), (2, 700, 4, 0.1)])
def test_attention_bwd_kernel_matches_plain_on_card(cuda_device, n, length, heads, rate):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(14, (n, length, heads * 64)))
    streams = _streams(15, n, cuda_device)
    o, lse = attention.attention_packed_plain(q, k, v, heads, 2, rate, streams)
    do = torch.from_numpy(np.random.default_rng(16).normal(
        size=tuple(q.shape)).astype(np.float32)).to(cuda_device)
    before = attention.ATTENTION_PACKED_BWD.launches
    got = attention.attention_packed_bwd(q, k, v, o, lse, do, heads, 2, rate, streams)
    torch.cuda.synchronize()
    assert attention.ATTENTION_PACKED_BWD.launches == before + 1
    want = attention.attention_packed_bwd_plain(q, k, v, o, lse, do, heads, 2, rate,
                                                streams)
    for g, w in zip(got, want):
        assert _max_rel_err(g, w) <= ATTN_BWD_REL


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_packed_attention_at_the_unstacked_rows_on_card(cuda_device, rate):
    """K5' and K6' at AttnCut's and MtAttnCut's shape: the N = B = 63 rows of
    one unstacked encoder at L = 300 (the expert models stack 3 * B)."""
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(40, (63, 300, 256)))
    streams = _streams(41, 63, cuda_device)
    o, lse = attention.fused_attention_packed(q, k, v, heads=4, pack=2,
                                              dropout_rate=rate, streams=streams)
    want_o, want_lse = attention.attention_packed_plain(q, k, v, 4, 2, rate, streams)
    torch.testing.assert_close(o, want_o, rtol=0, atol=ATTN_ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=ATTN_ATOL)
    do = torch.from_numpy(np.random.default_rng(42).normal(
        size=tuple(q.shape)).astype(np.float32)).to(cuda_device)
    got = attention.attention_packed_bwd(q, k, v, want_o, want_lse, do, 4, 2, rate,
                                         streams)
    want = attention.attention_packed_bwd_plain(q, k, v, want_o, want_lse, do, 4, 2,
                                                rate, streams)
    for g, w in zip(got, want):
        assert _max_rel_err(g, w) <= ATTN_BWD_REL


def test_packed_attention_bwd_kernel_is_deterministic_on_card(cuda_device):
    """Every gradient element is summed by one thread in a fixed order, with
    no atomics: two launches on the same inputs give the same bits."""
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(26, (9, 300, 256)))
    streams = _streams(27, 9, cuda_device)
    o, lse = attention.attention_packed_plain(q, k, v, 4, 2, 0.1, streams)
    do = torch.from_numpy(np.random.default_rng(28).normal(
        size=tuple(q.shape)).astype(np.float32)).to(cuda_device)
    first = attention.attention_packed_bwd(q, k, v, o, lse, do, 4, 2, 0.1, streams)
    second = attention.attention_packed_bwd(q, k, v, o, lse, do, 4, 2, 0.1, streams)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K5' and K6' at Choopy's width (D = 128, 8 heads of dh = 16 in one group of
# pack 8): its N = B = 63 rows, a few rows, ragged and whole 64-row tiles,
# the main path's L = 300 and L = 700. (Not L = 1 for the backward: there
# o = v and dq, dk are zero by algebra.)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("length", [37, 128, 300, 700])
@pytest.mark.parametrize("n", [3, 63])
def test_packed_attention_at_dh16_matches_plain_on_card(cuda_device, n, length, rate):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(44, (n, length, 128)))
    streams = _streams(45, n, cuda_device)
    before = attention.ATTENTION_PACKED_FWD.launches
    o, lse = attention.fused_attention_packed(q, k, v, heads=8, pack=8,
                                              dropout_rate=rate, streams=streams)
    torch.cuda.synchronize()
    assert attention.ATTENTION_PACKED_FWD.launches == before + 1
    want_o, want_lse = attention.attention_packed_plain(q, k, v, 8, 8, rate, streams)
    torch.testing.assert_close(o, want_o, rtol=0, atol=ATTN_ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=ATTN_ATOL)
    o_none, _ = attention.fused_attention_packed(q, k, v, heads=8, pack=8)
    assert torch.equal(o, o_none) == (rate == 0.0)
    do = torch.from_numpy(np.random.default_rng(46).normal(
        size=tuple(q.shape)).astype(np.float32)).to(cuda_device)
    before = attention.ATTENTION_PACKED_BWD.launches
    got = attention.attention_packed_bwd(q, k, v, want_o, want_lse, do, 8, 8, rate,
                                         streams)
    torch.cuda.synchronize()
    assert attention.ATTENTION_PACKED_BWD.launches == before + 1
    want = attention.attention_packed_bwd_plain(q, k, v, want_o, want_lse, do, 8, 8,
                                                rate, streams)
    for g, w in zip(got, want):
        assert _max_rel_err(g, w) <= ATTN_BWD_REL


def test_packed_attention_bwd_at_dh16_is_deterministic_on_card(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(47, (63, 300, 128)))
    streams = _streams(48, 63, cuda_device)
    o, lse = attention.attention_packed_plain(q, k, v, 8, 8, 0.1, streams)
    do = torch.from_numpy(np.random.default_rng(49).normal(
        size=tuple(q.shape)).astype(np.float32)).to(cuda_device)
    first = attention.attention_packed_bwd(q, k, v, o, lse, do, 8, 8, 0.1, streams)
    second = attention.attention_packed_bwd(q, k, v, o, lse, do, 8, 8, 0.1, streams)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_packed_attention_rejects_other_head_widths_on_card(cuda_device):
    """The packed kernels have instances for dh = 16 and 64 alone: 8 heads
    of dh = 32 raise, forward and backward, and nothing falls back."""
    q = torch.zeros(2, 8, 256, device=cuda_device)
    lse = torch.zeros(2, 1, 8, 8, device=cuda_device)
    before = (attention.ATTENTION_PACKED_FWD.launches,
              attention.ATTENTION_PACKED_BWD.launches)
    with pytest.raises(ValueError, match="takes dh = 16 or dh = 64, got dh = 32"):
        attention.attention_packed_fwd(q, q, q, 8, 8)
    with pytest.raises(ValueError, match="takes dh = 16 or dh = 64, got dh = 32"):
        attention.attention_packed_bwd(q, q, q, q, lse, q, 8, 8)
    assert (attention.ATTENTION_PACKED_FWD.launches,
            attention.ATTENTION_PACKED_BWD.launches) == before


# K3' and K4' at PLECut's shapes (N = 2 * 3 * 63 and 2 * 3 * 256 slices of
# L = 300, whose last tile of 64 rows is part-filled), at a ragged L, at
# whole tiles, and at an L beyond any one block's shared memory. The
# forward also at L = 1; the backward not: there o = v, so dq and dk are
# zero by algebra and a relative check compares noise.
SLICE_SHAPES = [(63 * 3, 300), (256 * 3, 300), (5, 37), (3, 64), (2, 700)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("batch,length", SLICE_SHAPES + [(4, 1)])
def test_slice_attention_kernel_matches_plain_on_card(cuda_device, batch, length, rate):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(19, (batch, 2, length, 128)))
    streams = _streams(20, 2 * batch, cuda_device)
    before = attention.ATTENTION_FWD.launches
    o, lse = attention.fused_attention(q, k, v, rate, streams)
    torch.cuda.synchronize()
    assert attention.ATTENTION_FWD.launches == before + 1
    want_o, want_lse = attention.attention_plain(q, k, v, rate, streams)
    torch.testing.assert_close(o, want_o, rtol=0, atol=ATTN_ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=ATTN_ATOL)
    if rate == 0.0:
        o_none, _ = attention.fused_attention(q, k, v)
        assert torch.equal(o, o_none)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("batch,length", SLICE_SHAPES)
def test_slice_attention_bwd_kernel_matches_plain_on_card(cuda_device, batch, length,
                                                          rate):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(21, (batch, 2, length, 128)))
    streams = _streams(22, 2 * batch, cuda_device)
    o, lse = attention.attention_plain(q, k, v, rate, streams)
    do = torch.from_numpy(np.random.default_rng(23).normal(
        size=tuple(q.shape)).astype(np.float32)).to(cuda_device)
    before = attention.ATTENTION_BWD.launches
    got = attention.attention_bwd(q, k, v, o, lse, do, rate, streams)
    torch.cuda.synchronize()
    assert attention.ATTENTION_BWD.launches == before + 1
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, rate, streams)
    for g, w in zip(got, want):
        assert _max_rel_err(g, w) <= ATTN_BWD_REL


def test_slice_attention_bwd_kernel_is_deterministic_on_card(cuda_device):
    """Every gradient element is summed by one thread in a fixed order, with
    no atomics: two launches on the same inputs give the same bits."""
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(29, (9, 2, 300, 128)))
    streams = _streams(30, 18, cuda_device)
    o, lse = attention.attention_plain(q, k, v, 0.1, streams)
    do = torch.from_numpy(np.random.default_rng(31).normal(
        size=tuple(q.shape)).astype(np.float32)).to(cuda_device)
    first = attention.attention_bwd(q, k, v, o, lse, do, 0.1, streams)
    second = attention.attention_bwd(q, k, v, o, lse, do, 0.1, streams)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_slice_attention_rejects_on_card(cuda_device):
    q = torch.zeros(1, 2, 8, 64, device=cuda_device)
    with pytest.raises(ValueError, match="dh = 128"):
        attention.fused_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 128, device=cuda_device)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        attention.fused_attention(q, q, q)


# K3'-K6' at a dropout rate per member (`RowDropout`), three members of
# `ROWS_PER_MEMBER` rows each, one at rate 0; bf16 against the plain
# version to 2 bf16 steps of each output's max abs (the kernels round each
# weight against the running max), lse to ATTN_ATOL.
MEMBER_RATES = (0.3, 0.0, 0.1)
ROWS_PER_MEMBER = 5
BF16_STEPS = 2


def _bf16_close(got, want, what):
    step = 2.0 ** (torch.floor(torch.log2(want.float().abs().max())) - 7)
    err = (got.float() - want.float()).abs().max()
    assert err <= BF16_STEPS * step, (what, float(err), float(step))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dh,length", [(16, 300), (64, 300), (128, 300), (64, 37),
                                       (128, 700)])
def test_attention_at_member_rates_matches_plain_on_card(cuda_device, dh, length, dtype):
    """The forward and the backward with a rate per row (packed at dh 16
    and 64, per slice at 128) against their plain versions on the same
    rates and streams; each member's rows bit for bit a launch over its
    rows alone at its rate, the member at rate 0 the rate-0 launch."""
    bf16 = dtype == torch.bfloat16
    suffix = "_bf16" if bf16 else ""
    n = ROWS_PER_MEMBER * len(MEMBER_RATES)
    if dh == 128:
        shape, n_streams, per_s = (n, 2, length, 128), 2 * n, 2 * ROWS_PER_MEMBER
        fwd, bwd = (getattr(attention, f"attention_{p}{suffix}") for p in ("fwd", "bwd"))
        plain_f, plain_b = attention.attention_plain, attention.attention_bwd_plain
    else:
        heads, d = (8, 128) if dh == 16 else (4, 256)
        pack = attention.packed_group_size(d, heads)
        shape, n_streams, per_s = (n, length, d), n, ROWS_PER_MEMBER
        fwd_k, bwd_k = (getattr(attention, f"attention_packed_{p}{suffix}")
                        for p in ("fwd", "bwd"))
        fwd = lambda q, k, v, r, s: fwd_k(q, k, v, heads, pack, r, s)  # noqa: E731
        bwd = lambda q, k, v, o, lse, do, r, s: bwd_k(  # noqa: E731
            q, k, v, o, lse, do, heads, pack, r, s)
        plain_f = lambda q, k, v, r, s: attention.attention_packed_plain(  # noqa: E731
            q, k, v, heads, pack, r, s)
        plain_b = lambda q, k, v, o, lse, do, r, s: (  # noqa: E731
            attention.attention_packed_bwd_plain(q, k, v, o, lse, do, heads, pack, r, s))
    rng = np.random.default_rng(dh + length)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(cuda_device, dtype) for _ in range(4))
    streams = _streams(dh, n_streams, cuda_device)
    rows = attention.row_dropout(MEMBER_RATES, cuda_device).repeat(per_s)
    o, lse = fwd(q, k, v, rows, streams)
    grads = bwd(q, k, v, o, lse, do, rows, streams)
    want_o, want_lse = plain_f(q, k, v, rows, streams)
    want_g = plain_b(q, k, v, o, lse, do, rows, streams)
    torch.cuda.synchronize()
    assert (lse - want_lse).abs().max() <= ATTN_ATOL
    if bf16:
        _bf16_close(o, want_o, "o")
        for g, w in zip(grads, want_g):
            _bf16_close(g, w, "grad")
    else:
        assert (o - want_o).abs().max() <= ATTN_ATOL
        for g, w in zip(grads, want_g):
            assert _max_rel_err(g, w) <= ATTN_BWD_REL
    for m, rate in enumerate(MEMBER_RATES):
        b = slice(m * ROWS_PER_MEMBER, (m + 1) * ROWS_PER_MEMBER)
        s = slice(m * per_s, (m + 1) * per_s)
        lse_m = lse[s] if dh == 128 else lse[b]
        o_m, lse_1 = fwd(q[b], k[b], v[b], rate, streams[s] if rate else None)
        grads_m = bwd(q[b], k[b], v[b], o[b], lse_m, do[b], rate,
                      streams[s] if rate else None)
        torch.cuda.synchronize()
        assert torch.equal(o_m, o[b]) and torch.equal(lse_1, lse_m), (m, rate)
        for g, g_m in zip(grads, grads_m):
            assert torch.equal(g_m, g[b]), (m, rate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_member_scaling_matches_scalar_division_on_card(cuda_device, dtype):
    """A member model's dropout scale (`layers.MemberRates`, one kernel over
    all members) equals each member's own model's x / keep with a Python
    float keep on the card, forward and backward, bit for bit."""
    from rlt_tpu_torch.models import layers

    rates = (0.45, 0.0, 0.1, 0.33)
    member_rates = layers.MemberRates(rates).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(4, 63, 300, 64, generator=gen, device=cuda_device).to(dtype)
    g = torch.randn(x.shape, generator=gen, device=cuda_device).to(dtype)
    xa = x.clone().requires_grad_()
    layers._over_keep(xa, member_rates).backward(g)
    y = layers._over_keep(x, member_rates)
    for m, rate in enumerate(rates):
        xm = x[m].clone().requires_grad_()
        want = xm / (1.0 - rate)
        want.backward(g[m])
        assert torch.equal(y[m], want.detach()) and torch.equal(xa.grad[m], xm.grad), rate


def _step_grads(cfg, x, y, valid, device, seed):
    """Loss and gradients of one train step from the seeded initial weights."""
    trainer = Trainer(cfg, data=synthetic_dataset(num_queries=10, seq_len=cfg.seq_len,
                                                  num_features=cfg.input_size),
                      device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    loss, _, _ = train_step(trainer.model, trainer.optimizer, trainer.criterion,
                            cfg.model_name, x, y, valid, generator)
    return loss, {n: p.grad.clone() for n, p in trainer.model.named_parameters()}


# the BiLSTM's layers, each one K1' and one K2' launch (Choopy's have none)
BILSTM_LAYERS = {"choopy": 0, "mtchoopy": 0}


@pytest.mark.parametrize("model_name,attention_launches", [
    ("mmoecut", [0, 0, 1, 1]), ("mtple", [1, 1, 0, 0]), ("moecut", [0, 0, 1, 1]),
    ("attncut", [0, 0, 1, 1]), ("mtattncut", [0, 0, 1, 1]), ("bicut", [0, 0, 0, 0])])
def test_training_step_on_card_matches_plain(cuda_device, model_name, attention_launches):
    """One training step at robust04 width with the model's drmm_tks dropout
    through the kernels against the same step through the plain versions on
    the card: same weights, batch and generator seed, so the same masks.
    MMOECut, MOECut, AttnCut and MtAttnCut run the packed attention pair
    K5'/K6', PLECut the per-slice pair K3'/K4', BiCut the LSTM pair only."""
    cfg = apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04"))
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(8, cfg.seq_len, cfg.input_size))
                         .astype(np.float32)).to(cuda_device)
    y = torch.from_numpy((rng.random((8, cfg.seq_len)) < 0.2).astype(np.float32)).to(cuda_device)
    valid = torch.ones(8, device=cuda_device)
    kernels = (lstm.LSTM_FWD, lstm.LSTM_BWD, attention.ATTENTION_FWD,
               attention.ATTENTION_BWD, attention.ATTENTION_PACKED_FWD,
               attention.ATTENTION_PACKED_BWD)
    counts = [k.launches for k in kernels]
    loss, grads = _step_grads(cfg, x, y, valid, cuda_device, 18)
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == [2, 2] + attention_launches
    with plain_ops():
        want_loss, want_grads = _step_grads(cfg, x, y, valid, cuda_device, 18)
    assert torch.isfinite(loss) and abs(float(loss - want_loss)) <= STEP_LOSS_REL * abs(float(want_loss))
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        w = want_grads[name]
        assert (g - w).abs().max() <= STEP_GRAD_REL * w.abs().max() + STEP_GRAD_FLOOR, name


# Choopy's and MtChoopy's three post-LN layers of ReLU FFNs: a hidden unit
# whose pre-activation lies within rounding of 0 switches its ReLU between
# two correct runs and moves a whole position's share of one row of
# linear1's gradient. Float32 against float64 on the CPU, at this test's
# batch, moves single elements of MtChoopy's layers_2.linear1.weight
# gradient by 6.6e-3 of its max abs but the whole leaf by 4.1e-4 of its L2
# norm, so these models' step gradients are held leaf by leaf in L2. Their
# leaves whose gradient is zero by algebra (`ZERO_GRAD_LEAVES`: the biases
# under the softmax over positions, the rerank bias under its hinge) read
# rounding noise of the loss's scale on both sides (float32 on the CPU: at
# most 1.9e-6 of the model's largest gradient) and must stay under
# ZERO_GRAD_REL of it.
ZERO_GRAD_REL = 1e-4


@pytest.mark.parametrize("model_name", ["choopy", "mtchoopy"])
def test_choopy_training_step_on_card_matches_plain(cuda_device, model_name):
    """One training step of Choopy or MtChoopy at robust04 width (scores
    only) with the drmm_tks dropout, through the kernels against the plain
    versions on the card, as test_training_step_on_card_matches_plain: no
    LSTM launch, 3 K5' and 3 K6' (one per encoder layer, dh = 16)."""
    cfg = apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04"))
    assert cfg.input_size == 1
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(8, cfg.seq_len, 1)).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy((rng.random((8, cfg.seq_len)) < 0.2).astype(np.float32)).to(cuda_device)
    valid = torch.ones(8, device=cuda_device)
    kernels = (lstm.LSTM_FWD, lstm.LSTM_BWD, attention.ATTENTION_FWD,
               attention.ATTENTION_BWD, attention.ATTENTION_PACKED_FWD,
               attention.ATTENTION_PACKED_BWD)
    counts = [k.launches for k in kernels]
    loss, grads = _step_grads(cfg, x, y, valid, cuda_device, 18)
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == [0, 0, 0, 0, 3, 3]
    with plain_ops():
        want_loss, want_grads = _step_grads(cfg, x, y, valid, cuda_device, 18)
    assert torch.isfinite(loss) and abs(float(loss - want_loss)) <= STEP_LOSS_REL * abs(float(want_loss))
    largest = max(w.abs().max() for w in want_grads.values())
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        w = want_grads[name]
        if name in ZERO_GRAD_LEAVES[model_name]:
            assert max(g.abs().max(), w.abs().max()) <= ZERO_GRAD_REL * largest, name
        else:
            assert (g - w).norm() <= STEP_GRAD_REL * w.norm(), name


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
            attention.ATTENTION_PACKED_FWD.launches - before[1]) == (2, 1)
    want_ks, want_dist = cpu.predict_with_distribution(x)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=DIST_ATOL)
    top2 = np.sort(want_dist, axis=-1)[:, -2:]
    tied = top2[:, 1] - top2[:, 0] <= DIST_ATOL
    assert np.all((ks == want_ks) | tied)


@pytest.mark.parametrize("model_name,attention_launches", [
    ("moecut", 1), ("attncut", 1), ("mtattncut", 1), ("bicut", 0), ("choopy", 3),
    ("mtchoopy", 3)])
def test_zoo_model_on_card_matches_cpu(cuda_device, model_name, attention_launches):
    """A model of the zoo at robust04 width through the kernels on the card
    against the same seeded model on the CPU (plain versions), as
    test_mmoecut_on_card_matches_cpu: distributions within DIST_ATOL, cuts
    equal but where the distribution is tied within DIST_ATOL (BiCut: a
    position whose decision pair is)."""
    cfg = TrainConfig(model_name=model_name, retrieve_data="robust04")
    card = Predictor(cfg, device=cuda_device)
    cpu = Predictor(cfg, device="cpu")
    x = np.random.default_rng(43).normal(
        size=(3, cfg.seq_len, cfg.input_size)).astype(np.float32)
    before = (lstm.LSTM_FWD.launches, attention.ATTENTION_PACKED_FWD.launches)
    ks, dist = card.predict_with_distribution(x)
    assert (lstm.LSTM_FWD.launches - before[0],
            attention.ATTENTION_PACKED_FWD.launches - before[1]) == (
                BILSTM_LAYERS.get(model_name, 2), attention_launches)
    want_ks, want_dist = cpu.predict_with_distribution(x)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=DIST_ATOL)
    if model_name == "bicut":
        tied = np.any(np.abs(want_dist[..., 0] - want_dist[..., 1]) <= DIST_ATOL, axis=-1)
    else:
        top2 = np.sort(want_dist, axis=-1)[:, -2:]
        tied = top2[:, 1] - top2[:, 0] <= DIST_ATOL
    assert np.all((ks == want_ks) | tied)


# ---------------------------------------------------------------------------
# The bf16 instances of K1', K3' and K5' (the bf16 serving lane)
# ---------------------------------------------------------------------------

# tests/test_torch_bf16.py's tolerances: cs is the float32 carry (LSTM_ATOL
# over up to 300 steps, as the float32 instance), hs is bf16 and may round
# one step the other way beyond that; attention's lse is float32
# (ATTN_ATOL) and its bf16 o within 2 bf16 steps of max|o| (the kernels
# round each weight against the running max, the plain versions the
# normalised weight).
O_BF16_STEPS = 2
# Served bf16 distributions through the kernels against the plain versions
# on the card, per batch: RMS within sqrt(2) of d_ref's and max within
# 3 max|d_ref|, d_ref being the plain bf16 run against the plain float32
# one (two roundings of one f32 function; tests/test_torch_bf16.py).
BF16_RMS_OF_REF = 2.0 ** 0.5
BF16_MAX_OF_REF = 3.0


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126))) - 7)


def _assert_bf16_attention(o, lse, want_o, want_lse):
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    limit = O_BF16_STEPS * _bf16_step(want_o.float().abs().max()).item()
    assert (o.float() - want_o.float()).abs().max().item() <= limit
    assert (lse - want_lse).abs().max().item() <= ATTN_ATOL


# The bf16 K1' and K2' (csrc/lstm_bf16_mma.cuh) at every edge of their
# geometry: 1 to 301 rows a direction (a block takes 2, 4 or 8 rows, the
# last block of a direction fewer, and K2''s products take 64-row boxes of
# one step), one step and many, and ndir 8 (the BiLSTM layers of K = 4
# population members, 2 or 8 rows a block).
LSTM_BF16_SHAPES = [(1, 1), (1, 63), (16, 1), (16, 3), (16, 8), (16, 9), (16, 17),
                    (300, 1), (300, 63), (300, 256), (40, 301)]


@pytest.mark.parametrize("ndir", [1, 2, 8])
@pytest.mark.parametrize("length,batch", LSTM_BF16_SHAPES)
def test_lstm_bf16_kernel_matches_plain_on_card(cuda_device, length, batch, ndir):
    xw, w = (torch.from_numpy(a).to(cuda_device).bfloat16()
             for a in _lstm_inputs(150 + batch, length, batch, 128, ndir))
    before = (lstm.LSTM_FWD.launches, lstm.LSTM_FWD_BF16.launches)
    hs, cs = lstm.lstm_fwd_bf16(xw, w, ndir)
    torch.cuda.synchronize()
    assert (lstm.LSTM_FWD.launches, lstm.LSTM_FWD_BF16.launches) == (before[0],
                                                                     before[1] + 1)
    want_hs, want_cs = lstm.lstm_recurrence_plain(xw, w, ndir)
    assert hs.dtype == torch.bfloat16 and cs.dtype == torch.float32
    assert (cs - want_cs).abs().max().item() <= LSTM_ATOL
    beyond = (hs.float() - want_hs.float()).abs() - _bf16_step(want_hs)
    assert beyond.max().item() <= LSTM_ATOL


def test_lstm_bf16_kernel_is_deterministic_on_card(cuda_device):
    xw, w = (torch.from_numpy(a).to(cuda_device).bfloat16()
             for a in _lstm_inputs(155, 300, 63, 128, 2))
    first = lstm.lstm_fwd_bf16(xw, w, 2)
    again = lstm.lstm_fwd_bf16(xw, w, 2)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _assert_repeatable(first, again, without=None):
    """A second launch bit-equal to the first; at rate 0, the call with
    streams bit-equal to the call without (`without`)."""
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    if without is not None:
        assert all(torch.equal(a, b) for a, b in zip(first, without))


# The bf16 forwards of dh = 64 and 128 (attention_bf16_wgmma.cuh) at every
# kind of length: one key, a ragged single tile, one whole tile and one key
# past it, PLECut's and the experts' L = 300, and K/V streams longer than any
# shared-memory residency (700, 2048); and at the population's N = 756 rows
# (K5') and 756 slices (K3'). dh = 16 (attention_bf16_dh16.cuh) at the same
# kinds of length, at Choopy's N = 63 and its serving bucket's 256.
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dh,n,length", [(64, 9, 300), (64, 3, 37), (64, 2, 700),
                                         (64, 4, 1), (64, 3, 64), (64, 3, 65),
                                         (64, 2, 2048), (64, 756, 300),
                                         (16, 63, 300), (16, 3, 37), (16, 2, 700),
                                         (16, 4, 1), (16, 3, 64), (16, 3, 65),
                                         (16, 2, 2048), (16, 256, 300)])
def test_packed_attention_bf16_kernel_matches_plain_on_card(cuda_device, dh, n, length,
                                                            rate):
    d, heads = (256, 4) if dh == 64 else (128, 8)
    pack = attention.packed_group_size(d, heads)
    q, k, v = (torch.from_numpy(a).to(cuda_device).bfloat16()
               for a in _qkv(160 + n, (n, length, d)))
    streams = _streams(161, n, cuda_device)
    before = attention.ATTENTION_PACKED_FWD_BF16.launches
    o, lse = attention.attention_packed_fwd_bf16(q, k, v, heads, pack, rate, streams)
    torch.cuda.synchronize()
    assert attention.ATTENTION_PACKED_FWD_BF16.launches == before + 1
    _assert_bf16_attention(o, lse, *attention.attention_packed_plain(q, k, v, heads, pack,
                                                                     rate, streams))
    _assert_repeatable((o, lse),
                       attention.attention_packed_fwd_bf16(q, k, v, heads, pack, rate,
                                                           streams),
                       attention.attention_packed_fwd_bf16(q, k, v, heads, pack)
                       if rate == 0.0 else None)


# dh = 16 at 16 heads (D = 256): two groups of pack 8, the second on
# group_stream(stream, 1), and two 4-head boxes of each row's 64-column tiles
# in each group.
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_packed_attention_bf16_dh16_two_groups_on_card(cuda_device, rate):
    n, length, d, heads = 5, 130, 256, 16
    pack = attention.packed_group_size(d, heads)
    assert (pack, heads // pack) == (8, 2)
    q, k, v = (torch.from_numpy(a).to(cuda_device).bfloat16()
               for a in _qkv(165, (n, length, d)))
    streams = _streams(166, n, cuda_device)
    o, lse = attention.attention_packed_fwd_bf16(q, k, v, heads, pack, rate, streams)
    torch.cuda.synchronize()
    _assert_bf16_attention(o, lse, *attention.attention_packed_plain(q, k, v, heads, pack,
                                                                     rate, streams))
    _assert_repeatable((o, lse),
                       attention.attention_packed_fwd_bf16(q, k, v, heads, pack, rate,
                                                           streams),
                       attention.attention_packed_fwd_bf16(q, k, v, heads, pack)
                       if rate == 0.0 else None)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("batch,length", SLICE_SHAPES + [(4, 1), (3, 65), (1, 2048),
                                                         (378, 300)])
def test_slice_attention_bf16_kernel_matches_plain_on_card(cuda_device, batch, length,
                                                           rate):
    q, k, v = (torch.from_numpy(a).to(cuda_device).bfloat16()
               for a in _qkv(170 + batch, (batch, 2, length, 128)))
    streams = _streams(171, batch * 2, cuda_device)
    before = attention.ATTENTION_FWD_BF16.launches
    o, lse = attention.attention_fwd_bf16(q, k, v, rate, streams)
    torch.cuda.synchronize()
    assert attention.ATTENTION_FWD_BF16.launches == before + 1
    _assert_bf16_attention(o, lse, *attention.attention_plain(q, k, v, rate, streams))
    _assert_repeatable((o, lse), attention.attention_fwd_bf16(q, k, v, rate, streams),
                       attention.attention_fwd_bf16(q, k, v) if rate == 0.0 else None)


def test_bf16_wrappers_reject_on_card(cuda_device):
    q = torch.zeros(1, 8, 256, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        attention.attention_packed_fwd_bf16(q, q, q, 4, 2)
    with pytest.raises(TypeError, match="attention_packed_fwd_bf16"):
        attention.attention_packed_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16(), 4, 2)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="dh = 16 or dh = 64"):
        attention.attention_packed_fwd_bf16(qb, qb, qb, 2, 2)
    xw = torch.zeros(4, 8, 512, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="lstm_fwd_bf16"):
        lstm.lstm_fwd(xw, torch.zeros(128, 512, device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bf16"):
        lstm.lstm_fwd_bf16(xw, torch.zeros(128, 512, device=cuda_device))


@pytest.mark.parametrize("model_name", ["mmoecut", "mtple", "bicut", "choopy"])
def test_bf16_predictor_on_card_matches_plain(cuda_device, model_name):
    """A bf16 Predictor at robust04 width through the bf16 kernels (and no
    float32 kernel) against the same bf16 model through the plain versions
    on the card, within the bounds of d_ref (the plain bf16 run against
    the plain float32 one); cuts equal where the top two are further apart
    than the max bound."""
    cfg = TrainConfig(model_name=model_name, retrieve_data="robust04",
                      compute_dtype="bfloat16")
    card = Predictor(cfg, device=cuda_device)
    # the references run through the plain versions, so eager: a graph
    # replays the kernels it captured
    plain = Predictor(cfg, state_dict=card.model.state_dict(), device=cuda_device,
                      graphs=False)
    ref32 = Predictor(TrainConfig(model_name=model_name, retrieve_data="robust04"),
                      state_dict=card.model.state_dict(), device=cuda_device, graphs=False)
    x = np.random.default_rng(180).normal(
        size=(4, cfg.seq_len, cfg.input_size)).astype(np.float32)
    before = {name: k.launches for name, k in KERNELS.items()}
    ks, dist = card.predict_with_distribution(x)
    used = {name for name, k in KERNELS.items() if k.launches != before[name]}
    assert used and all(name.endswith("_bf16") for name in used), used
    with plain_ops():
        want_ks, want_dist = plain.predict_with_distribution(x)
        dist32 = ref32.predict_with_distribution(x)[1]
    assert dist.dtype == np.float32 and np.all(np.isfinite(dist))
    d_ref = want_dist - dist32
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))  # noqa: E731
    assert rms(dist - want_dist) <= BF16_RMS_OF_REF * rms(d_ref)
    limit = BF16_MAX_OF_REF * np.abs(d_ref).max()
    assert np.abs(dist - want_dist).max() <= limit
    if model_name == "bicut":
        tied = np.any(np.abs(want_dist[..., 0] - want_dist[..., 1]) <= limit, axis=-1)
    else:
        top2 = np.sort(want_dist, axis=-1)[:, -2:]
        tied = top2[:, 1] - top2[:, 0] <= limit
    assert np.all((ks == want_ks) | tied)


# ---------------------------------------------------------------------------
# The bf16 backward instances (K2', K4', K6' in bf16) against their plain
# versions, which round what the JAX kernels round. K2''s dxw is rounded from
# f32 dgates whose sums run in another order: within one bf16 step of the
# plain dxw beyond LSTM_BWD_REL of its max abs; its dW_hh^T is f32, as in
# f32 (LSTM_BWD_REL). The attention gradients are bf16 sums of the same
# rounded ds and pd in another order: within 2 bf16 steps of each one's max
# abs (tests/test_torch_bf16_train_ops.py holds the plain versions to the
# JAX kernels at that bound).
# ---------------------------------------------------------------------------

GRAD_BF16_STEPS = 2


def _lstm_bwd_bf16_inputs(seed, length, batch, ndir, device):
    xw, w = (torch.from_numpy(a).to(device).bfloat16()
             for a in _lstm_inputs(seed, length, batch, 128, ndir))
    hs, cs = lstm.lstm_recurrence_plain(xw, w, ndir)
    dho = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=tuple(hs.shape)).astype(np.float32)).to(device).bfloat16()
    return xw, w, hs, cs, dho


@pytest.mark.parametrize("ndir", [1, 2, 8])
@pytest.mark.parametrize("length,batch", LSTM_BF16_SHAPES)
def test_lstm_bwd_bf16_kernel_matches_plain_on_card(cuda_device, length, batch, ndir):
    args = _lstm_bwd_bf16_inputs(190 + batch, length, batch, ndir, cuda_device)
    before = (lstm.LSTM_BWD.launches, lstm.LSTM_BWD_BF16.launches)
    dxw, dw = lstm.lstm_bwd_bf16(*args, ndir)
    torch.cuda.synchronize()
    assert (lstm.LSTM_BWD.launches, lstm.LSTM_BWD_BF16.launches) == (before[0],
                                                                     before[1] + 1)
    want_dxw, want_dw = lstm.lstm_bwd_plain(*args, ndir)
    assert dxw.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert torch.isfinite(dxw.float()).all() and torch.isfinite(dw).all()
    beyond = ((dxw.float() - want_dxw.float()).abs() - _bf16_step(want_dxw)).max().item()
    assert beyond <= LSTM_BWD_REL * want_dxw.float().abs().max().item()
    assert _max_rel_err(dw, want_dw) <= LSTM_BWD_REL


def test_lstm_bwd_bf16_kernel_is_deterministic_on_card(cuda_device):
    args = _lstm_bwd_bf16_inputs(195, 300, 63, 2, cuda_device)
    first = lstm.lstm_bwd_bf16(*args, 2)
    again = lstm.lstm_bwd_bf16(*args, 2)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _assert_bf16_grads(got, want, floors=(0.0, 0.0, 0.0)):
    for g, w, floor in zip(got, want, floors):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        limit = max(GRAD_BF16_STEPS * _bf16_step(w.float().abs().max()).item(), floor)
        assert (g.float() - w.float()).abs().max().item() <= limit


def _single_key_floors(q, k, o, do, dh):
    """dq's and dk's bounds at L = 1, where they are 0 in exact arithmetic:
    every probability is 1 and o = v, so dp = do v^T and delta = rowsum(do o)
    are one sum of dh products taken two ways, and each version returns the
    f32 rounding of dp - delta, |ds| <= 2 dh 2^-24 scale max rowsum |do o|,
    times k (dq) or q (dk); the two versions differ by at most twice that.
    (A bound relative to the plain version's max abs, which is that rounding
    too, says nothing here.) dv = do is held as everywhere."""
    terms = (do.float() * o.float()).abs().unflatten(-1, (-1, dh)).sum(-1).max().item()
    ds = 4 * dh * 2.0 ** -24 * dh ** -0.5 * terms
    return ds * k.float().abs().max().item(), ds * q.float().abs().max().item(), 0.0


# The backwards fed o and lse from the plain forward and from the bf16
# forward kernel (whose lse layout and dropout bits they read); dh = 64 and
# 128 (attention_bf16_bwd_wgmma.cuh) at every kind of length: one key, a
# ragged single tile, one whole tile and one key past it, the experts' and
# PLECut's L = 300, and streams longer than any shared-memory residency (700,
# 2048), up to N = 768 rows (1536 slices); dh = 16 (attention_bf16_dh16.cuh)
# at the same kinds of length, at Choopy's N = 63 and 256; at rate 0 the
# call with streams bit-equal to the call without.
@pytest.mark.parametrize("forward", ["plain", "kernel"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dh,n,length", [(64, 9, 300), (64, 3, 37), (64, 2, 700),
                                         (64, 4, 1), (64, 3, 64), (64, 3, 65),
                                         (64, 2, 2048), (64, 768, 300),
                                         (16, 63, 300), (16, 3, 37), (16, 2, 700),
                                         (16, 4, 1), (16, 3, 64), (16, 3, 65),
                                         (16, 2, 2048), (16, 256, 300)])
def test_packed_attention_bwd_bf16_kernel_matches_plain_on_card(cuda_device, dh, n,
                                                                length, rate, forward):
    d, heads = (256, 4) if dh == 64 else (128, 8)
    pack = attention.packed_group_size(d, heads)
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).bfloat16()
                   for a in _qkv(200 + n, (n, length, d)) + _qkv(201, (n, length, d))[:1])
    streams = _streams(202, n, cuda_device)
    fwd = (attention.attention_packed_plain if forward == "plain"
           else attention.attention_packed_fwd_bf16)
    o, lse = fwd(q, k, v, heads, pack, rate, streams)
    before = (attention.ATTENTION_PACKED_BWD.launches,
              attention.ATTENTION_PACKED_BWD_BF16.launches)
    got = attention.attention_packed_bwd_bf16(q, k, v, o, lse, do, heads, pack, rate,
                                              streams)
    torch.cuda.synchronize()
    assert (attention.ATTENTION_PACKED_BWD.launches,
            attention.ATTENTION_PACKED_BWD_BF16.launches) == (before[0], before[1] + 1)
    floors = _single_key_floors(q, k, o, do, dh) if length == 1 else (0.0, 0.0, 0.0)
    _assert_bf16_grads(got, attention.attention_packed_bwd_plain(
        q, k, v, o, lse, do, heads, pack, rate, streams), floors)
    if rate == 0.0:
        _assert_repeatable(got, attention.attention_packed_bwd_bf16(q, k, v, o, lse, do,
                                                                    heads, pack))


# dh = 16 at 16 heads (two groups of pack 8), as the forward's case.
@pytest.mark.parametrize("forward", ["plain", "kernel"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_packed_attention_bwd_bf16_dh16_two_groups_on_card(cuda_device, rate, forward):
    n, length, d, heads = 5, 130, 256, 16
    pack = attention.packed_group_size(d, heads)
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).bfloat16()
                   for a in _qkv(205, (n, length, d)) + _qkv(206, (n, length, d))[:1])
    streams = _streams(207, n, cuda_device)
    fwd = (attention.attention_packed_plain if forward == "plain"
           else attention.attention_packed_fwd_bf16)
    o, lse = fwd(q, k, v, heads, pack, rate, streams)
    got = attention.attention_packed_bwd_bf16(q, k, v, o, lse, do, heads, pack, rate,
                                              streams)
    torch.cuda.synchronize()
    _assert_bf16_grads(got, attention.attention_packed_bwd_plain(
        q, k, v, o, lse, do, heads, pack, rate, streams))
    if rate == 0.0:
        _assert_repeatable(got, attention.attention_packed_bwd_bf16(q, k, v, o, lse, do,
                                                                    heads, pack))


# dh = 16's backward at Choopy's shape and dropout: two launches on the same
# inputs bit-equal (every element summed by one thread in a fixed order).
def test_packed_attention_bwd_bf16_dh16_is_deterministic_on_card(cuda_device):
    n, length, d, heads = 63, 300, 128, 8
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).bfloat16()
                   for a in _qkv(208, (n, length, d)) + _qkv(209, (n, length, d))[:1])
    streams = _streams(210, n, cuda_device)
    o, lse = attention.attention_packed_fwd_bf16(q, k, v, heads, 8, 0.1, streams)
    first = attention.attention_packed_bwd_bf16(q, k, v, o, lse, do, heads, 8, 0.1, streams)
    _assert_repeatable(first, attention.attention_packed_bwd_bf16(q, k, v, o, lse, do,
                                                                  heads, 8, 0.1, streams))


@pytest.mark.parametrize("forward", ["plain", "kernel"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("batch,length", SLICE_SHAPES + [(4, 1), (3, 65), (1, 2048)])
def test_slice_attention_bwd_bf16_kernel_matches_plain_on_card(cuda_device, batch, length,
                                                               rate, forward):
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).bfloat16()
                   for a in _qkv(210 + batch, (batch, 2, length, 128))
                   + _qkv(211, (batch, 2, length, 128))[:1])
    streams = _streams(212, batch * 2, cuda_device)
    fwd = attention.attention_plain if forward == "plain" else attention.attention_fwd_bf16
    o, lse = fwd(q, k, v, rate, streams)
    before = (attention.ATTENTION_BWD.launches, attention.ATTENTION_BWD_BF16.launches)
    got = attention.attention_bwd_bf16(q, k, v, o, lse, do, rate, streams)
    torch.cuda.synchronize()
    assert (attention.ATTENTION_BWD.launches,
            attention.ATTENTION_BWD_BF16.launches) == (before[0], before[1] + 1)
    floors = _single_key_floors(q, k, o, do, 128) if length == 1 else (0.0, 0.0, 0.0)
    _assert_bf16_grads(got, attention.attention_bwd_plain(q, k, v, o, lse, do, rate,
                                                          streams), floors)
    if rate == 0.0:
        _assert_repeatable(got, attention.attention_bwd_bf16(q, k, v, o, lse, do))


def test_attention_bwd_bf16_kernels_are_deterministic_on_card(cuda_device):
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).bfloat16()
                   for a in _qkv(220, (9, 300, 256)) + _qkv(221, (9, 300, 256))[:1])
    streams = _streams(222, 9, cuda_device)
    o, lse = attention.attention_packed_fwd_bf16(q, k, v, 4, 2, 0.1, streams)
    first = attention.attention_packed_bwd_bf16(q, k, v, o, lse, do, 4, 2, 0.1, streams)
    again = attention.attention_packed_bwd_bf16(q, k, v, o, lse, do, 4, 2, 0.1, streams)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    qs, ks, vs, dos = (torch.from_numpy(a).to(cuda_device).bfloat16()
                       for a in _qkv(224, (9, 2, 300, 128)) + _qkv(225, (9, 2, 300, 128))[:1])
    streams = _streams(223, 18, cuda_device)
    o, lse = attention.attention_fwd_bf16(qs, ks, vs, 0.1, streams)
    first = attention.attention_bwd_bf16(qs, ks, vs, o, lse, dos, 0.1, streams)
    again = attention.attention_bwd_bf16(qs, ks, vs, o, lse, dos, 0.1, streams)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_bf16_bwd_wrappers_reject_on_card(cuda_device):
    q = torch.zeros(1, 8, 256, device=cuda_device)
    lse = torch.zeros(1, 2, 8, 2, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        attention.attention_packed_bwd_bf16(q, q, q, q, lse, q, 4, 2)
    qb = q.bfloat16()
    with pytest.raises(TypeError, match="attention_packed_bwd_bf16"):
        attention.attention_packed_bwd(qb, qb, qb, qb, lse, qb, 4, 2)
    with pytest.raises(TypeError, match="float32 lse"):
        attention.attention_packed_bwd_bf16(qb, qb, qb, qb, lse.bfloat16(), qb, 4, 2)
    s = qb.reshape(1, 2, 8, 128)
    with pytest.raises(TypeError, match="attention_bwd_bf16"):
        attention.attention_bwd(s, s, s, s, torch.zeros(2, 1, 8, device=cuda_device), s)
    xw = torch.zeros(4, 8, 512, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(128, 512, device=cuda_device, dtype=torch.bfloat16)
    hs = torch.zeros(4, 8, 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="lstm_bwd_bf16"):
        lstm.lstm_bwd(xw, w, hs, hs.float(), hs)
    with pytest.raises(TypeError, match="float32 cs"):
        lstm.lstm_bwd_bf16(xw, w, hs, hs, hs)


# The bf16 train step through the bf16 kernels against the same bf16 step
# through the plain versions on the card, with d_ref the plain bf16 step
# against the plain float32 one (chip_smoke.py's bounds, and why): the
# kernels' bf16 attention forwards round each weight at another point than
# the plain versions, so the two bf16 steps are two independent roundings,
# about sqrt(2) of d_ref apart on average. Per leaf the yardstick is the
# larger of RMS(d_ref) and rho times the leaf's RMS, rho the median relative
# d_ref of the model's leaves; the median leaf within 2 of it, every leaf
# within 4. The leaves zero by algebra are rounding noise on both sides (up
# to 3.7e-2 of the model's largest gradient, Choopy's decision bias), each
# within 0.1 of it. The loss within 3 |d_ref| plus one bf16 step of it.


def _bf16_train_grads(cfg, x, y, valid, device, seed):
    """The loss and gradients of one train step in cfg's compute dtype from
    the seeded initial weights."""
    trainer = Trainer(cfg, data=synthetic_dataset(num_queries=10, seq_len=cfg.seq_len,
                                                  num_features=cfg.input_size),
                      device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    loss, _, _ = train_step(trainer.model, trainer.optimizer, trainer.criterion,
                            cfg.model_name, x, y, valid, generator, trainer.dtype)
    return float(loss), {n: p.grad.clone() for n, p in trainer.model.named_parameters()}


def _without_key_bias(name, t):
    if not name.endswith("self_attn.in_proj_bias"):
        return t
    d = t.shape[-1] // 3
    return torch.cat([t[..., :d], t[..., 2 * d:]], dim=-1)


@pytest.mark.parametrize("model_name", list(ZERO_GRAD_LEAVES))
def test_bf16_training_step_on_card_matches_plain(cuda_device, model_name):
    cfg = apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04",
                                   compute_dtype="bfloat16"))
    rng = np.random.default_rng(230)
    x = torch.from_numpy(rng.normal(size=(8, cfg.seq_len, cfg.input_size))
                         .astype(np.float32)).to(cuda_device)
    y = torch.from_numpy((rng.random((8, cfg.seq_len)) < 0.2).astype(np.float32)).to(cuda_device)
    valid = torch.ones(8, device=cuda_device)
    before = {name: k.launches for name, k in KERNELS.items()}
    loss, grads = _bf16_train_grads(cfg, x, y, valid, cuda_device, 231)
    torch.cuda.synchronize()
    used = {name for name, k in KERNELS.items() if k.launches != before[name]}
    assert used and all(name.endswith("_bf16") for name in used), used
    assert (model_name in ("choopy", "mtchoopy")) == ("lstm_bwd_bf16" not in used)
    with plain_ops():
        want_loss, want = _bf16_train_grads(cfg, x, y, valid, cuda_device, 231)
        loss32, want32 = _bf16_train_grads(
            dataclasses.replace(cfg, compute_dtype="float32"), x, y, valid, cuda_device, 231)
    step = _bf16_step(torch.tensor(want_loss)).item()
    assert abs(loss - want_loss) <= 3 * abs(want_loss - loss32) + step
    rms = lambda t: t.double().pow(2).mean().sqrt().item()  # noqa: E731
    largest = max(g.abs().max().item() for g in want.values())
    stats = {}
    for name, g in grads.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        if name in ZERO_GRAD_LEAVES[model_name]:
            assert g.abs().max().item() <= 0.1 * largest, name
            continue
        k, p, p32 = (_without_key_bias(name, t[name]) for t in (grads, want, want32))
        stats[name] = (rms(k - p), rms(p - p32), rms(p))
    rho = float(np.median([d / max(r, 1e-30) for _, d, r in stats.values()]))
    ratio = {n: e / max(d, rho * r, 1e-30) for n, (e, d, r) in stats.items()}
    assert np.median(list(ratio.values())) <= 2.0, ratio
    assert max(ratio.values()) <= 4.0, ratio



# K5' and K6' at ProbeBase's N = 2 * 63 = 126 rows (its two experts stacked
# over the B = 63 lists of the probe_base preset), f32 on the verify_probe
# path and bf16 beside it, at rates 0 and 0.1.
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_packed_attention_at_the_probe_rows_on_card(cuda_device, dtype, rate):
    n = 126
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).to(dtype)
                   for a in _qkv(250, (n, 300, 256)) + [_qkv(251, (n, 300, 256))[0]])
    streams = _streams(252, n, cuda_device)
    want_o, want_lse = attention.attention_packed_plain(q, k, v, 4, 2, rate, streams)
    want = attention.attention_packed_bwd_plain(q, k, v, want_o, want_lse, do, 4, 2, rate,
                                                streams)
    if dtype == torch.float32:
        o, lse = attention.attention_packed_fwd(q, k, v, 4, 2, rate, streams)
        torch.testing.assert_close(o, want_o, rtol=0, atol=ATTN_ATOL)
        torch.testing.assert_close(lse, want_lse, rtol=0, atol=ATTN_ATOL)
        got = attention.attention_packed_bwd(q, k, v, want_o, want_lse, do, 4, 2, rate,
                                             streams)
        for g, w in zip(got, want):
            assert _max_rel_err(g, w) <= ATTN_BWD_REL
    else:
        _assert_bf16_attention(*attention.attention_packed_fwd_bf16(q, k, v, 4, 2, rate,
                                                                    streams),
                               want_o, want_lse)
        got = attention.attention_packed_bwd_bf16(q, k, v, want_o, want_lse, do, 4, 2, rate,
                                                  streams)
        _assert_bf16_grads(got, want)
    again = (attention.attention_packed_bwd if dtype == torch.float32
             else attention.attention_packed_bwd_bf16)(q, k, v, want_o, want_lse, do, 4, 2,
                                                       rate, streams)
    _assert_repeatable(got, again)


def test_graphed_probe_trainer_steps_equal_eager_on_card(cuda_device):
    """verify_probe's steps as CUDA graphs against the same steps eager, from
    the same seed, dropout on: three base steps (results, parameters, Adam's
    state) and three probe steps (the six metrics, the towers), bit for bit,
    each replay launching what an eager step does."""
    from rlt_tpu_torch.verify_probe import ProbeTrainer

    cfg = apply_preset(TrainConfig(model_name="probe_base", synthetic_queries=40))
    assert (cfg.batch_size, cfg.dropout) == (63, 0.1)
    graphed, eager = (ProbeTrainer(cfg, epochs_base=1, epochs_probe=1, device=cuda_device,
                                   graphs=g) for g in (True, False))
    idx, valid = graphed.data.plan(graphed.generator, "train")
    eager.data.plan(eager.generator, "train")
    for s in range(3):
        got, want = [], []
        for t, out in ((graphed, got), (eager, want)):
            before = {name: k.launches for name, k in KERNELS.items()}
            out.append(t.base_batch("train", idx[s % len(idx)], valid[s % len(idx)]))
            torch.cuda.synchronize()
            out.append({name: k.launches - before[name] for name, k in KERNELS.items()})
        assert got[1] == want[1] and got[1]["attention_packed_bwd"] == 1
        assert torch.equal(got[0], want[0]), s
    for module in ("base", "probe"):
        pairs = zip(getattr(graphed, module).parameters(), getattr(eager, module).parameters())
        assert all(torch.equal(p, q) for p, q in pairs), module
    for p, q in zip(graphed.base.parameters(), eager.base.parameters()):
        for key, value in graphed.base_optimizer.state[p].items():
            assert torch.equal(value, eager.base_optimizer.state[q][key]), key
    for s in range(3):
        got = graphed.probe_batch(idx[s % len(idx)], valid[s % len(idx)])
        want = eager.probe_batch(idx[s % len(idx)], valid[s % len(idx)])
        assert torch.equal(got, want), s
    assert all(torch.equal(p, q) for p, q in zip(graphed.probe.parameters(),
                                                  eager.probe.parameters()))


@pytest.mark.parametrize("trained_first", [False, True], ids=["fresh", "captured"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_resume_equals_the_uninterrupted_run_on_card(cuda_device, tmp_path, dtype,
                                                             trained_first):
    """`--resume` under CUDA graphs: 3 epochs, then 2 more in a new Trainer,
    equal 5 uninterrupted ones bit for bit (step losses, metrics,
    parameters, Adam's state, generator), whether the state is restored
    before the first capture (`fresh`, as the CLI does) or into a Trainer
    whose graphs an epoch has captured already (`captured`)."""
    cfg = dataclasses.replace(
        apply_preset(TrainConfig(model_name="mmoecut", synthetic_queries=160,
                                 compute_dtype=dtype)),
        dropout=0.1, epochs=5, model_persist=True, save_path=str(tmp_path / "whole"))
    whole = Trainer(cfg, device=cuda_device)
    whole.run()
    split = dataclasses.replace(cfg, save_path=str(tmp_path / "split"))
    Trainer(dataclasses.replace(split, epochs=3), device=cuda_device).run()
    resumed = Trainer(split, device=cuda_device)
    assert resumed.graphs
    if trained_first:
        resumed.run_epoch()
    summary = resumed.run(resume=True)
    assert len(resumed.history) == 2
    for epoch in (3, 4):
        assert resumed.history[epoch - 3] == whole.history[epoch], epoch
    for p, q in zip(resumed.model.parameters(), whole.model.parameters()):
        assert torch.equal(p, q)
        for key, value in whole.optimizer.state[q].items():
            assert torch.equal(resumed.optimizer.state[p][key], value), key
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
    assert summary == whole.summary()
