"""PLECut and the per-slice attention op of the port against the JAX package.

The plain versions of K3' (`attention_fwd`) and K4' (`attention_bwd`)
against the JAX package's `_fwd_pallas` / `_bwd_pallas` in interpret mode;
the dropout streams of stacked experts; PLECut's heads and gradients on
weights copied with `params_from_jax`; its criterion; and its training CLI.
The port runs on the CPU, where its kernels' plain versions run; inputs are
made with numpy from fixed seeds and handed to both packages.
tests/test_torch_card.py holds the CUDA kernels to the plain versions.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlt_tpu.ops.attention as jax_attention
from rlt_tpu import config as jax_config
from rlt_tpu import train as jax_train
from rlt_tpu.models import build_model as jax_build_model
from rlt_tpu.models import layers as jax_layers
from rlt_tpu_torch import train
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.infer import decode_ks
from rlt_tpu_torch.models import build_model
from rlt_tpu_torch.ops import attention
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

# f32, dh = 128: 128-term dot products and L-term softmax sums taken in
# another order on the two sides; o is O(1), lse O(log L).
ATTN_ATOL = 1e-5
# The backward's dq, dk, dv: sums of L products of 128-term dot products
# in another order (tests/test_torch_ops.py's ATTN_BWD_ATOL).
ATTN_BWD_ATOL = 2e-5
# Heads of the whole model: probabilities in [0, 1]; the gates contract
# 2 * 128 * L BiLSTM outputs in another order, and flax's LayerNorm takes the
# variance as E[x^2] - E[x]^2 (tests/test_torch_models.py's HEAD_ATOL).
HEAD_ATOL = 1e-5
# Step-1 gradients, relative to each gradient's max abs, plus a floor for
# the softmax towers' biases, whose gradient is zero by algebra and rounding
# noise on both sides (tests/test_torch_train.py's GRAD_REL, GRAD_FLOOR).
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-7


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _features(seed, batch, seq_len):
    return np.random.default_rng(seed).normal(size=(batch, seq_len, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# K3' and K4' (plain versions) against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

SEED = 2**31 - 3  # the streams of slices 3 and up wrap past int32


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("length", [128, 37])
def test_attention_fwd_matches_jax_kernel(length, rate):
    q, k, v, _ = _qkv(30, (2, 2, length, 128))
    want_o, want_lse = jax_attention._fwd_pallas(
        rate, True, *map(jnp.asarray, (q, k, v)), jnp.asarray([SEED], jnp.int32))
    o, lse = attention.attention_fwd(*map(torch.from_numpy, (q, k, v)), rate,
                                     attention._streams(SEED, 4).to(torch.int32))
    assert o.shape == (2, 2, length, 128) and lse.shape == (4, 1, length)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("length", [128, 37])
def test_attention_bwd_matches_jax_kernel(length, rate):
    """The plain K4' against `_bwd_pallas(rate, True, ...)`, both fed the
    JAX forward's o and lse and the same seed."""
    q, k, v, do = _qkv(31, (2, 2, length, 128))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jseed = jnp.asarray([SEED], jnp.int32)
    jax_o, jax_lse = jax_attention._fwd_pallas(rate, True, jq, jk, jv, jseed)
    want = jax_attention._bwd_pallas(rate, True, jq, jk, jv, jax_o, jax_lse, jdo, jseed)
    got = attention.attention_bwd(
        *map(torch.from_numpy, (q, k, v, np.array(jax_o), np.array(jax_lse), do)),
        rate, attention._streams(SEED, 4).to(torch.int32))
    for g, w in zip(got, want):
        assert g.shape == (2, 2, length, 128)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATTN_BWD_ATOL)


def test_fused_attention_grads_match_jax():
    """Gradients of a weighted sum of o through the port's Attention
    Function against jax.grad through the JAX custom_vjp (interpret mode),
    with dropout."""
    q, k, v, w = _qkv(32, (1, 2, 40, 128))
    seed = jnp.asarray([5], jnp.int32)

    def jax_loss(a, b, c):
        return jnp.sum(jax_attention.fused_attention(a, b, c, 0.1, seed,
                                                     interpret=True) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = attention.fused_attention(tq, tk, tv, 0.1,
                                       attention._streams(5, 2).to(torch.int32))
    assert not lse.requires_grad
    (o * torch.from_numpy(w)).sum().backward()
    for g, want_g in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=0,
                                   atol=ATTN_BWD_ATOL)


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_attention_gradcheck(rate):
    """float64 finite differences against the plain backward, tiny shapes,
    with and without the dropout mask (a fixed function of the streams)."""
    rng = np.random.default_rng(33)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 5, 8))).requires_grad_()
               for _ in range(3))
    streams = torch.tensor([3, 2**31 - 1, -7, 0], dtype=torch.int32)

    def fn(q, k, v):
        return attention.fused_attention(q, k, v, rate, streams)[0]

    assert torch.autograd.gradcheck(fn, (q, k, v))


# ---------------------------------------------------------------------------
# Streams of stacked experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeds", [(0, 12345, 99), (2**31 - 1, 2**31 - 2, 7)])
def test_expert_streams_match_jax_per_slice_streams(seeds):
    """Row e * B * H + b * H + h of `expert_streams(seeds, B * H)` is JAX's
    `_streams(seed_e, B * H)[b * H + h]`, int32 wrap included, and the
    slice's keep mask is JAX's `keep_mask` on that stream."""
    slices, length, rate = 4 * 2, 6, 0.3
    got = attention.expert_streams(torch.tensor(seeds), slices)
    want = np.concatenate([np.asarray(jax_attention._streams(s, slices)).reshape(-1)
                           for s in seeds])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_mask = np.stack([np.asarray(jax_attention.keep_mask(jnp.int32(s), (length, length),
                                                             rate)) for s in want])
    np.testing.assert_array_equal(
        attention.slice_keep_mask(got, length, rate).numpy(), want_mask)


def test_stacked_experts_match_jax_per_expert_kernels():
    """Two experts' slices stacked as (E * B, H, L, dh) on the streams of
    `expert_streams` against the JAX kernel run once per expert on its own
    seed, as its `nn.vmap` over experts runs it."""
    experts, batch, heads, length, rate = 2, 2, 2, 24, 0.4
    q, k, v, _ = _qkv(34, (experts, batch, heads, length, 128))
    seeds = (2**31 - 2, 11)
    want = np.stack([np.asarray(jax_attention._fwd_pallas(
        rate, True, jnp.asarray(q[e]), jnp.asarray(k[e]), jnp.asarray(v[e]),
        jnp.asarray([seeds[e]], jnp.int32))[0]) for e in range(experts)])
    flat = (experts * batch, heads, length, 128)
    o, _ = attention.fused_attention(
        *(torch.from_numpy(a.reshape(flat)) for a in (q, k, v)), rate,
        attention.expert_streams(torch.tensor(seeds), batch * heads))
    np.testing.assert_allclose(o.numpy().reshape(want.shape), want, rtol=0,
                               atol=ATTN_ATOL)


# ---------------------------------------------------------------------------
# PLECut on copied weights
# ---------------------------------------------------------------------------

def _jax_plecut(seq_len, use_pallas, dropout=0.1, seed=0):
    model = jax_build_model("mtple", seq_len=seq_len, input_size=3, dropout=dropout,
                            use_pallas=use_pallas)
    key = jax.random.PRNGKey(seed)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((1, seq_len, 3), jnp.float32))["params"]
    return model, params


@pytest.fixture(scope="module")
def jax_plecut16():
    return _jax_plecut(16, use_pallas=False)


def _port_plecut(seq_len, params, dropout=0.1):
    model = build_model("mtple", seq_len=seq_len, input_size=3, dropout=dropout)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    return model


def _compare_heads(jax_model, params, x):
    want = jax_model.apply({"params": params}, jnp.asarray(x), deterministic=True)
    port = _port_plecut(x.shape[1], params).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=HEAD_ATOL)
    np.testing.assert_array_equal(decode_ks("mtple", got).numpy(),
                                  np.asarray(jax_train.decode_ks("mtple", want)))


def test_params_from_jax_covers_every_plecut_leaf(jax_plecut16):
    _, params = jax_plecut16
    leaves = {"/".join(k.key for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    state = params_from_jax(_np_tree(params))
    port_state = build_model("mtple", seq_len=16, input_size=3, dropout=0.1).state_dict()
    assert set(state) == set(port_state)
    assert len(state) == len(leaves)
    for name, tensor in state.items():
        assert tuple(tensor.shape) == tuple(port_state[name].shape), name
    assert [tuple(state[f"w_gate_{t}"].shape) for t in range(3)] == [
        (2 * 128 * 16, 2), (2 * 128 * 16, 2), (2 * 128 * 16, 3)]
    key = "experts.attention_layer.layers_0.self_attn.in_proj_weight"
    assert tuple(state[key].shape) == (3, 768, 256)


def test_plecut_matches_jax_plain_path(jax_plecut16):
    jax_model, params = jax_plecut16
    _compare_heads(jax_model, params, _features(35, 3, 16))


def test_plecut_matches_jax_kernel_path(monkeypatch):
    """The JAX forward through its Pallas kernels (interpret mode): L = 128
    reaches PALLAS_MIN_SEQ_LEN, so the fused LSTM and the per-slice
    attention kernel K3 run (PLECut's dh = 128 has no head packing)."""
    monkeypatch.setattr(jax_layers, "fused_lstm",
                        functools.partial(jax_layers.fused_lstm, interpret=True))
    monkeypatch.setattr(jax_attention, "fused_attention",
                        functools.partial(jax_attention.fused_attention, interpret=True))
    seq_len = 128
    assert seq_len >= jax_attention.PALLAS_MIN_SEQ_LEN
    assert jax_attention.packed_group_size(256, 2) is None
    jax_model, params = _jax_plecut(seq_len, use_pallas=True, seed=1)
    _compare_heads(jax_model, params, _features(36, 2, seq_len))


def test_plecut_training_grads_match_jax():
    """Training-mode heads and the gradient of PLECut's criterion for every
    parameter against jax.value_and_grad, on copied weights at dropout 0."""
    jax_model, params = _jax_plecut(16, use_pallas=False, dropout=0.0, seed=4)
    rng = np.random.default_rng(37)
    x = _features(38, 3, 16)
    y = (rng.random((3, 16)) < 0.3).astype(np.float32)
    y[:, 0] = 1.0
    valid = np.array([1, 1, 0], np.float32)
    jax_crit = jax_train.make_criterion(jax_config.TrainConfig(model_name="mtple",
                                                               criterion="dcg"))

    def jax_loss(p):
        out = jax_model.apply({"params": p}, jnp.asarray(x), deterministic=False)
        return jax_crit(out, jnp.asarray(y), valid=jnp.asarray(valid)), out

    (want_loss, want_heads), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    model = _port_plecut(16, params, dropout=0.0).train()
    heads = model(torch.from_numpy(x))
    for g, w in zip(heads, want_heads):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=HEAD_ATOL)
    loss = train.make_criterion(TrainConfig(model_name="mtple", criterion="dcg"))(
        heads, torch.from_numpy(y), valid=torch.from_numpy(valid))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    want = params_from_jax(_np_tree(want_grads))
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + GRAD_FLOOR, name


def test_plecut_criterion_matches_jax():
    """PLECut's criterion keeps its three tasks and 0.5/0.5 whatever the
    config's num_tasks, as the JAX package's `make_criterion` does."""
    port = train.make_criterion(TrainConfig(model_name="mtple", num_tasks=2.1))
    want = jax_train.make_criterion(jax_config.TrainConfig(model_name="mtple",
                                                           num_tasks=2.1))
    assert port.keywords == dict(metric="dcg", rerank_weight=0.5, classi_weight=0.5,
                                 num_tasks=3)
    assert port.keywords == want.keywords


def test_plecut_serves_the_cut_tower():
    """`TruncationService` with `--model-name mtple` answers with the cuts
    decoded from PLECut's last head, the cut tower, clamped to each list's
    length."""
    from rlt_tpu_torch.serve import TruncationService

    svc = TruncationService(TrainConfig(model_name="mtple", seq_len_override=16),
                            max_batch=4, device="cpu")
    rng = np.random.default_rng(40)
    lengths = (16, 9, 12)
    feats = [rng.normal(size=(n, 3)).astype(np.float32) for n in lengths]
    out = svc.truncate({"features": [f.tolist() for f in feats],
                        "return_distribution": True})
    x = np.zeros((4, 16, 3), np.float32)  # the bucket of 4, zero-padded
    for i, f in enumerate(feats):
        x[i, :len(f)] = f
    with torch.no_grad():
        heads = svc.predictor.model(torch.from_numpy(x))
    want = np.minimum(decode_ks("mtple", heads).numpy()[:3], lengths)
    assert out["k"] == want.tolist()
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(out["distribution"][i], heads[-1][i, :n, 0].numpy(),
                                   rtol=0, atol=1e-7)


def test_plecut_train_cli_on_cpu(tmp_path):
    """`python -m rlt_tpu_torch.train --model-name mtple --device cpu` trains
    two epochs with the mtple preset, writes the best weights, and the
    Predictor serves them, decoding the cut tower."""
    out = tmp_path / "summary.json"
    cmd = [sys.executable, "-m", "rlt_tpu_torch.train", "--model-name", "mtple",
           "--device", "cpu", "--retrieve-data", "mq2007", "--synthetic-queries", "24",
           "--batch-size", "8", "--epochs", "2", "--model-persist", "1",
           "--save-path", str(tmp_path), "--out", str(out)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=ONE_THREAD_ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["device"] == "cpu"
    assert np.isfinite(summary["best_f1"]) and np.isfinite(summary["best5_dcg"])
    saved = json.loads(out.read_text())
    assert saved["config"]["model_name"] == "mtple"
    assert (saved["config"]["dropout"], saved["config"]["lr"],
            saved["config"]["weight_decay"]) == (0.1, 3e-5, 0.0)
    from rlt_tpu_torch.infer import Predictor

    cfg = TrainConfig(model_name="mtple", retrieve_data="mq2007",
                      model_path=str(tmp_path / "mtple.pt"))
    predictor = Predictor(cfg, device="cpu")
    x = np.random.default_rng(39).normal(size=(2, 40, 47)).astype(np.float32)
    ks, dist = predictor.predict_with_distribution(x)
    assert ks.shape == (2,) and dist.shape == (2, 40)
    np.testing.assert_allclose(dist.sum(-1), 1.0, rtol=1e-5)
    with torch.no_grad():
        heads = predictor.model(torch.from_numpy(x))
    np.testing.assert_array_equal(dist, heads[-1][..., 0].numpy())
