"""The port's bf16 serving lane against the JAX package, on the CPU.

The bf16 forms of the three forward kernels (through their plain versions,
which the wrappers run on a CPU tensor) against the JAX kernels on bf16
operands in interpret mode: K1' (`lstm_fwd_bf16`) against `_fwd_pallas`
at ndir 1 and 2, K5' (`attention_packed_fwd_bf16`) against `_fwd_packed`
at dh 64 and 16, K3' (`attention_fwd_bf16`) against the per-slice
`_fwd_pallas` at dh 128. The CUDA kernels stream their keys and round the
softmax weights against the running max, where the JAX kernels (and the
plain versions) round the normalised weights; that order of rounding is
emulated in numpy at L = 300 and held to the JAX kernels at the same
tolerances. Then the eight models cast to bf16 against the JAX package's
Predictor-equivalent bf16 forward (f32 parameters and features cast to
bf16, outputs cast back to f32) through its kernels in interpret mode at
L = 128, on copied weights, and the Predictor, CLI and service in bf16.
Inputs are made with numpy from fixed seeds; bf16 values are the
round-to-nearest-even casts of the same float32 arrays on both sides.
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
from rlt_tpu.models import build_model as jax_build_model
from rlt_tpu.models import layers as jax_layers
from rlt_tpu.ops import lstm as jax_lstm
from rlt_tpu.train import decode_ks as jax_decode_ks
from rlt_tpu_torch import ops
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.infer import Predictor
from rlt_tpu_torch.models import build_model, is_multi_head
from rlt_tpu_torch.ops import attention, lstm
from rlt_tpu_torch.serve import TruncationService
from rlt_tpu_torch.train import Trainer
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
# K1': cs is float32 carried through every step, so only the order of the
# 128-term f32 sums differs (as the float32 tests' 1e-5); hs is stored in
# bf16, so a sum that lands within that order's noise of a rounding
# boundary may round the other way: one bf16 ulp of each element.
CS_ATOL = 1e-5
HS_ULPS = 1
# K3' and K5': lse is float32 from float32 sums of exact products (1e-5, as
# in float32); o is bf16 whose weights were rounded to bf16: within 2 bf16
# ulps of max|o| (the rounding of o itself, and of the weights that sum into
# it in another order or at another step).
LSE_ATOL = 1e-5
O_ULPS_OF_MAX = 2
# Whole models, per head: d_ref = JAX bf16 - JAX f32, bf16's own effect on
# that head. Every op of the lane was held to the JAX op on the same bf16
# inputs while it was built: each agrees to the order of its f32 sums, which
# flips a bf16 rounding now and then (0.003% of a product's outputs, 0.05%
# of an attention's o), and the out_proj after each attention spreads a
# flipped element over its row; through Choopy's three encoder layers the
# flips compound (0.14% of a layer's outputs on its own inputs, 27% after
# three). So the two bf16 runs part as two roundings of the same f32
# function: their difference has an RMS at most sqrt(2) of d_ref's (two
# independent errors of d_ref's size; 0.1-1.04 of it measured over eight
# models and four weight seeds), and its max, a noisier statistic (up to
# 2.1 max|d_ref| measured), stays within 3 max|d_ref|. A wrong rounding
# (a bf16 carry in the LSTM, scores rounded before the softmax) moves
# every element, and the RMS with it.
RMS_OF_REF = 2.0 ** 0.5
MAX_OF_REF = 3.0


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 values (ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _both(x: np.ndarray):
    """One float32 array as a JAX bf16 array and a torch bf16 tensor."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def assert_o_close(got: np.ndarray, want: np.ndarray) -> None:
    limit = O_ULPS_OF_MAX * bf16_ulp(np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= limit, f"o max abs err {err} > {limit}"


# ---------------------------------------------------------------------------
# (a) K1' bf16
# ---------------------------------------------------------------------------

def _lstm_inputs(seed: int, ndir: int, length: int = 37, batch: int = 3,
                 hidden: int = 128):
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(length, ndir * batch, 4 * hidden)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(ndir * hidden, 4 * hidden)) / np.sqrt(hidden)
         ).astype(np.float32)
    return xw, w


def _rounded_carry(xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One direction whose carried h is the rounded bf16 hs: another
    function, which the cs tolerance must tell apart."""
    hidden = w.shape[0]
    h = torch.zeros(xw.shape[1], hidden)
    c = torch.zeros(xw.shape[1], hidden)
    cs = []
    for t in range(xw.shape[0]):
        i, f, g, o = (xw[t].float() + h @ w.float()).split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).bfloat16().float()
        cs.append(c)
    return torch.stack(cs)


@pytest.mark.parametrize("ndir", [1, 2])
def test_lstm_fwd_bf16_matches_jax_kernel(ndir):
    xw, w = _lstm_inputs(70 + ndir, ndir)
    (jxw, txw), (jw, tw) = _both(xw), _both(w)
    want_hs, want_cs = jax_lstm._fwd_pallas(True, ndir, jxw, jw)
    assert want_hs.dtype == jnp.bfloat16 and want_cs.dtype == jnp.float32
    hs, cs = lstm.lstm_fwd_bf16(txw, tw, ndir)
    assert hs.dtype == torch.bfloat16 and cs.dtype == torch.float32
    np.testing.assert_allclose(cs.numpy(), np.asarray(want_cs), rtol=0, atol=CS_ATOL)
    want = _f32(want_hs)
    assert np.all(np.abs(hs.float().numpy() - want) <= HS_ULPS * bf16_ulp(want))
    if ndir == 1:  # the f32 carry is what makes cs agree
        rounded = _rounded_carry(txw, tw).numpy()
        assert np.abs(rounded - np.asarray(want_cs)).max() > CS_ATOL


def test_lstm_wrappers_keep_their_dtypes():
    xw, w = _lstm_inputs(72, 1, length=3, hidden=64)
    with pytest.raises(TypeError, match="lstm_fwd_bf16"):
        lstm.lstm_fwd(*(torch.from_numpy(a).bfloat16() for a in (xw, w)))
    with pytest.raises(TypeError, match="bf16"):
        lstm.lstm_fwd_bf16(torch.from_numpy(xw), torch.from_numpy(w))
    before = {name: k.launches for name, k in ops.KERNELS.items()}
    hs = lstm.fused_lstm(*(torch.from_numpy(a).bfloat16() for a in (xw, w)))
    assert hs.dtype == torch.bfloat16
    assert {name: k.launches for name, k in ops.KERNELS.items()} == before


# ---------------------------------------------------------------------------
# (b), (c) K5' and K3' bf16
# ---------------------------------------------------------------------------

PACKED_WIDTHS = {64: (256, 4, 2), 16: (128, 8, 8)}  # dh: (D, heads, pack)


def _seed_streams(n: int, seed: int = 11):
    return (jnp.full((1,), seed, jnp.int32),
            attention._streams(torch.tensor(seed), n).to(torch.int32))


@pytest.mark.parametrize("dh,length,rate", [(64, 128, 0.0), (64, 37, 0.0), (16, 128, 0.0),
                                            (16, 37, 0.0), (64, 128, 0.1), (16, 37, 0.1)])
def test_attention_packed_fwd_bf16_matches_jax_kernel(dh, length, rate):
    d, heads, pack = PACKED_WIDTHS[dh]
    rng = np.random.default_rng(80 + dh + length)
    n = 2
    qkv = [rng.normal(size=(n, length, d)).astype(np.float32) for _ in range(3)]
    (jq, tq), (jk, tk), (jv, tv) = map(_both, qkv)
    seed, streams = _seed_streams(n)
    want_o, want_lse = jax_attention._fwd_packed(rate, True, heads, pack, jq, jk, jv, seed)
    o, lse = attention.attention_packed_fwd_bf16(tq, tk, tv, heads, pack, rate, streams)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert want_o.dtype == jnp.bfloat16 and tuple(lse.shape) == want_lse.shape
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0, atol=LSE_ATOL)
    assert_o_close(o.float().numpy(), _f32(want_o))


@pytest.mark.parametrize("length,rate", [(128, 0.0), (37, 0.0), (128, 0.1)])
def test_attention_fwd_bf16_matches_jax_kernel(length, rate):
    rng = np.random.default_rng(90 + length)
    batch, heads = 2, 2
    qkv = [rng.normal(size=(batch, heads, length, 128)).astype(np.float32)
           for _ in range(3)]
    (jq, tq), (jk, tk), (jv, tv) = map(_both, qkv)
    seed, streams = _seed_streams(batch * heads)
    want_o, want_lse = jax_attention._fwd_pallas(rate, True, jq, jk, jv, seed)
    o, lse = attention.attention_fwd_bf16(tq, tk, tv, rate, streams)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0, atol=LSE_ATOL)
    assert_o_close(o.float().numpy(), _f32(want_o))


def test_attention_wrappers_keep_their_dtypes():
    rng = np.random.default_rng(95)
    q = torch.from_numpy(rng.normal(size=(1, 8, 256)).astype(np.float32))
    with pytest.raises(TypeError, match="attention_packed_fwd_bf16"):
        attention.attention_packed_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16(), 4, 2)
    with pytest.raises(TypeError, match="bf16"):
        attention.attention_packed_fwd_bf16(q, q, q, 4, 2)
    s = q.reshape(1, 2, 8, 128)
    with pytest.raises(TypeError, match="attention_fwd_bf16"):
        attention.attention_fwd(s.bfloat16(), s.bfloat16(), s.bfloat16())
    with pytest.raises(TypeError, match="bf16"):
        attention.attention_fwd_bf16(s, s, s)
    before = {name: k.launches for name, k in ops.KERNELS.items()}
    o, _ = attention.fused_attention_packed(q.bfloat16(), q.bfloat16(), q.bfloat16(), 4, 2)
    o2, _ = attention.fused_attention(s.bfloat16(), s.bfloat16(), s.bfloat16())
    assert o.dtype == o2.dtype == torch.bfloat16
    assert {name: k.launches for name, k in ops.KERNELS.items()} == before


# ---------------------------------------------------------------------------
# (d) the CUDA kernels' order of rounding, emulated at L = 300
# ---------------------------------------------------------------------------

def streamed_bf16(q, k, v, scale, keep=None, rate=0.0, tile=64):
    """One head as the bf16 kernels compute it (attention_bf16_wgmma.cuh at
    dh 64 and 128, attention_bf16_dh16.cuh at dh 16): q, k, v (L, dh)
    float32 holding bf16 values; `tile`-key tiles, the max of the raw
    scores m, each weight exp2(fma(s, c, -m c)) with c = scale log2(e) (the
    fma's one rounding from the exact product in float64), summed in f32
    and rounded to bf16 (dropped and scaled first where `keep` says) for
    P V, the running O rescaled by exp2((m_old - m_new) c), o = O / sum
    rounded to bf16, lse = m scale + log(sum). The f32 sums run in numpy's
    order, not the kernels' (per thread, then across the four threads of a
    row)."""
    length = q.shape[0]
    m = np.full(length, -np.inf, np.float32)
    total = np.zeros(length, np.float32)
    acc = np.zeros((length, v.shape[1]), np.float32)
    c = np.float32(scale) * np.float32(np.log2(np.e))
    for t0 in range(0, length, tile):
        s = q @ k[t0:t0 + tile].T
        m_new = np.maximum(m, s.max(axis=1))
        corr = np.exp2((m - m_new) * c)
        mc = m_new * c
        w = np.exp2((s.astype(np.float64) * np.float64(c)
                     - mc[:, None].astype(np.float64)).astype(np.float32))
        total, acc, m = total * corr, acc * corr[:, None], m_new
        total = total + w.sum(axis=1, dtype=np.float32)
        if keep is not None:
            w = np.where(keep[:, t0:t0 + tile], w * np.float32(1.0 / (1.0 - rate)), 0.0)
        acc = acc + to_bf16(w) @ v[t0:t0 + tile]
    lse = m * np.float32(scale) + np.log(total)
    return to_bf16(acc / total[:, None]), lse


# dh = 64 in attention_bf16_wgmma.cuh's order, dh = 16 in attention_bf16_dh16.cuh's
# (the same order)
@pytest.mark.parametrize("dh,rate", [(64, 0.0), (16, 0.0), (64, 0.1), (16, 0.1)])
def test_streamed_rounding_meets_the_packed_tolerances(dh, rate):
    d, heads, pack = PACKED_WIDTHS[dh]
    length, n = 300, 1
    rng = np.random.default_rng(100 + dh)
    qkv = [to_bf16(rng.normal(size=(n, length, d)).astype(np.float32)) for _ in range(3)]
    seed, streams = _seed_streams(n)
    want_o, want_lse = jax_attention._fwd_packed(
        rate, True, heads, pack, *(jnp.asarray(a, jnp.bfloat16) for a in qkv), seed)
    keep = (attention.head_keep_mask(streams, heads, pack, length, rate).numpy()
            if rate > 0.0 else None)
    o = np.zeros((n, length, d), np.float32)
    lse = np.zeros((n, heads, length), np.float32)
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        o[0, :, cols], lse[0, h] = streamed_bf16(
            *(a[0, :, cols] for a in qkv), 1.0 / np.sqrt(dh),
            None if keep is None else keep[0, h], rate)
    want_lse = np.asarray(want_lse).transpose(0, 1, 3, 2).reshape(n, heads, length)
    np.testing.assert_allclose(lse, want_lse, rtol=0, atol=LSE_ATOL)
    assert_o_close(o, _f32(want_o))


def test_streamed_rounding_meets_the_slice_tolerances():
    length = 300
    rng = np.random.default_rng(110)
    qkv = [to_bf16(rng.normal(size=(1, 2, length, 128)).astype(np.float32))
           for _ in range(3)]
    want_o, want_lse = jax_attention._fwd_pallas(
        0.0, True, *(jnp.asarray(a, jnp.bfloat16) for a in qkv), jnp.zeros((1,), jnp.int32))
    for h in range(2):
        o, lse = streamed_bf16(*(a[0, h] for a in qkv), 1.0 / np.sqrt(128))
        np.testing.assert_allclose(lse, np.asarray(want_lse)[h, 0], rtol=0, atol=LSE_ATOL)
        assert_o_close(o, _f32(want_o)[0, h])


# ---------------------------------------------------------------------------
# The layers whose bf16 rounding the port writes out: LayerNorm, softmax,
# sigmoid, each against flax / jax.nn on the same bf16 values, under jit
# ---------------------------------------------------------------------------

def _max_steps(got: torch.Tensor, want) -> float:
    """max |got - want| in bf16 steps of |want|, elementwise."""
    want = _f32(want)
    return float((np.abs(got.float().numpy() - want) / bf16_ulp(want)).max())


@pytest.mark.parametrize("experts", [None, 3])
def test_layernorm_bf16_matches_flax(experts):
    """`LayerNorm` on bf16 against flax's on bf16 (statistics and affine
    in f32, one rounding), fed the residual sum as the encoder layers feed
    it: the port's f32 sum of two bf16 tensors, XLA's fused one. Within one
    bf16 step (the f32 sums run in another order), nearly all equal."""
    import flax.linen as flax_nn

    from rlt_tpu_torch.models import layers

    rng = np.random.default_rng(140)
    lead = () if experts is None else (experts,)
    x, y = (rng.normal(size=lead + (2, 16, 256)).astype(np.float32) * 2 + 0.5
            for _ in range(2))
    scale = (1 + 0.1 * rng.normal(size=lead + (256,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=lead + (256,))).astype(np.float32)
    (jx, tx), (jy, ty) = _both(x), _both(y)
    norm = flax_nn.LayerNorm(epsilon=1e-5)
    apply = jax.jit(lambda s, b, x, y: norm.apply(
        {"params": {"scale": s, "bias": b}}, x + y))
    if experts is not None:
        apply = jax.vmap(apply)
    want = apply(jnp.asarray(scale, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16), jx, jy)
    ln = layers.LayerNorm(256, experts)
    ln.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = ln.to(torch.bfloat16)(layers.residual(tx, ty))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _max_steps(got, want) <= 1
    assert np.mean(got.float().numpy() == _f32(want)) > 0.999


def test_softmax_and_sigmoid_bf16_match_jax():
    """The heads' softmax and sigmoid on bf16 logits against jax.nn's
    under jit, intermediate (rounded to bf16) and final (the quotient left
    in f32 where the Predictor widens it at once)."""
    from rlt_tpu_torch.models import layers

    x = (np.random.default_rng(141).normal(size=(4, 128, 1)) * 3).astype(np.float32)
    jx, tx = _both(x)
    cases = [(jax.jit(lambda a: jax.nn.softmax(a, axis=1)),
              layers.softmax(tx, dim=1)),
             (jax.jit(lambda a: jax.nn.softmax(a, axis=1).astype(jnp.float32)),
              layers.softmax(tx, dim=1, final=True)),
             (jax.jit(jax.nn.sigmoid), layers.sigmoid(tx)),
             (jax.jit(lambda a: jax.nn.sigmoid(a).astype(jnp.float32)),
              layers.sigmoid(tx, final=True))]
    for fn, got in cases:
        want = fn(jx)
        assert got.dtype == (torch.float32 if want.dtype == jnp.float32 else torch.bfloat16)
        assert _max_steps(got, want) <= 1


# ---------------------------------------------------------------------------
# (e) the eight models in bf16 against the JAX kernel path
# ---------------------------------------------------------------------------

MODELS = ("mmoecut", "moecut", "mtple", "attncut", "mtattncut", "bicut", "choopy",
          "mtchoopy")
SEQ_LEN = 128  # PALLAS_MIN_SEQ_LEN: the JAX models take their kernels


def _input_size(name: str) -> int:
    return 1 if name in ("choopy", "mtchoopy") else 3


def _heads(output) -> list:
    return list(output) if isinstance(output, (list, tuple)) else [output]


@pytest.fixture(scope="module", params=MODELS)
def jax_bf16_run(request):
    """One JAX model per family at L = 128 on seeded weights, its
    Predictor-equivalent bf16 forward through the kernels in interpret
    mode (with the bf16 eval route to XLA attention off; the two BiLSTM
    directions fused) and its float32
    forward on the same path: (name, params, x, bf16 heads, f32 heads)."""
    name = request.param
    features = _input_size(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RLT_ATTN_XLA_EVAL", "0")
        # both directions of a BiLSTM layer in one kernel, as the port runs
        # them: the same function per direction, half the kernels to compile
        mp.setenv("RLT_LSTM_FUSE_BIDIR", "1")
        for fn in ("fused_lstm", "fused_lstm_bidir"):
            mp.setattr(jax_layers, fn,
                       functools.partial(getattr(jax_layers, fn), interpret=True))
        for fn in ("fused_attention_packed", "fused_attention"):
            mp.setattr(jax_attention, fn,
                       functools.partial(getattr(jax_attention, fn), interpret=True))
        model = jax_build_model(name, seq_len=SEQ_LEN, input_size=features, dropout=0.1,
                                use_pallas=True)
        key = jax.random.PRNGKey(3)
        params = model.init({"params": key, "dropout": key},
                            jnp.zeros((1, SEQ_LEN, features), jnp.float32))["params"]
        x = np.random.default_rng(120).normal(size=(2, SEQ_LEN, features)).astype(np.float32)

        def forward(params, x, bf16: bool):  # as rlt_tpu/infer.py's _predict
            if bf16:
                params = jax.tree.map(
                    lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
                    params)
                x = x.astype(jnp.bfloat16)
            out = model.apply({"params": params}, x, deterministic=True)
            return [o.astype(jnp.float32) for o in _heads(out)]

        runs = [[np.asarray(o) for o in jax.jit(functools.partial(forward, bf16=b))(
            params, jnp.asarray(x))] for b in (True, False)]
    return name, jax.tree.map(np.asarray, params), x, *runs


def test_models_bf16_match_jax_kernel_path(jax_bf16_run):
    name, params, x, want, want_f32 = jax_bf16_run
    cfg = TrainConfig(model_name=name, seq_len_override=SEQ_LEN,
                      input_size_override=_input_size(name), compute_dtype="bfloat16")
    predictor = Predictor(cfg, state_dict=params_from_jax(params), device="cpu")
    assert next(predictor.net.parameters()).dtype == torch.bfloat16
    assert next(predictor.model.parameters()).dtype == torch.float32
    with torch.inference_mode():
        got = _heads(predictor.net(torch.from_numpy(x).bfloat16()))
    assert len(got) == len(want)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))  # noqa: E731
    for g, w, w32 in zip(got, want, want_f32):
        g = g.float().numpy()
        assert g.shape == w.shape
        assert rms(g - w) <= RMS_OF_REF * rms(w - w32)
        assert np.abs(g - w).max() <= MAX_OF_REF * np.abs(w - w32).max()
    ks, dist = predictor.predict_with_distribution(x)
    want_ks = np.asarray(jax_decode_ks(name, want if is_multi_head(name) else want[0]))
    cut = want[-1]
    bound = MAX_OF_REF * np.abs(cut - want_f32[-1]).max()
    if name == "bicut":  # a position's {truncate, continue} pair may tie
        tied = np.any(np.abs(cut[..., 0] - cut[..., 1]) <= bound, axis=-1)
    else:
        top2 = np.sort(cut[..., 0], axis=-1)[:, -2:]
        tied = top2[:, 1] - top2[:, 0] <= bound
    assert np.all((ks == want_ks) | tied), (ks, want_ks)
    assert dist.dtype == np.float32


# ---------------------------------------------------------------------------
# (f) Predictor, CLI, service and Trainer in bf16
# ---------------------------------------------------------------------------

def _tiny(name: str = "mmoecut", **kw) -> TrainConfig:
    return TrainConfig(model_name=name, seq_len_override=16,
                       input_size_override=_input_size(name), **kw)


def test_predictor_serves_bf16_with_float32_outputs():
    f32 = Predictor(_tiny(seed=5), device="cpu")
    bf16 = Predictor(_tiny(seed=5, compute_dtype="bfloat16"), device="cpu")
    assert bf16.model.state_dict().keys() == f32.model.state_dict().keys()
    for key, t in bf16.model.state_dict().items():  # the f32 master is untouched
        assert t.dtype == torch.float32 and torch.equal(t, f32.model.state_dict()[key])
    x = np.random.default_rng(130).normal(size=(3, 16, 3)).astype(np.float32)
    ks, dist = bf16.predict_with_distribution(x)
    ks32, dist32 = f32.predict_with_distribution(x)
    assert ks.dtype == ks32.dtype == np.int32 and dist.dtype == np.float32
    assert dist.shape == dist32.shape and np.all(np.isfinite(dist))
    assert 0 < np.abs(dist - dist32).max() < 0.05
    with pytest.raises(ValueError, match="compute_dtype"):
        Predictor(_tiny(compute_dtype="float16"), device="cpu")


def test_service_reports_and_serves_bf16():
    svc = TruncationService(_tiny("choopy", compute_dtype="bfloat16"), max_batch=4,
                            device="cpu")
    try:
        assert svc.health()["compute_dtype"] == "bfloat16"
        out = svc.truncate({"scores": [[0.9, 0.5, 0.1], [0.3] * 16],
                            "return_distribution": True})
    finally:
        svc.close()
    assert len(out["k"]) == 2 and 1 <= out["k"][0] <= 3
    assert len(out["distribution"][1]) == 16


def test_trainer_refuses_bf16():
    """The Trainer builds in bf16 (its steps, tests/test_torch_bf16_train.py)
    on f32 master parameters, and refuses a dtype the port has no kernels
    for."""
    trainer = Trainer(_tiny(compute_dtype="bfloat16"), device="cpu")
    assert trainer.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(_tiny(compute_dtype="float16"), device="cpu")


def test_infer_cli_takes_compute_dtype(tmp_path):
    out = tmp_path / "cuts.json"
    proc = subprocess.run(
        [sys.executable, "-m", "rlt_tpu_torch.infer", "--model-name", "bicut",
         "--retrieve-data", "mq2007", "--device", "cpu", "--compute-dtype", "bfloat16",
         "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=ONE_THREAD_ENV)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["compute_dtype"] == "bfloat16" and summary["n_lists"] > 0
    assert np.isfinite(summary["test_f1"])
    assert json.loads(out.read_text())["compute_dtype"] == "bfloat16"


def test_serve_cli_takes_compute_dtype():
    from rlt_tpu_torch import serve

    with pytest.raises(SystemExit):  # argparse refuses a dtype it does not know
        serve.main(["--compute-dtype", "float16"])
    proc = subprocess.run([sys.executable, "-m", "rlt_tpu_torch.serve", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=ONE_THREAD_ENV)
    assert proc.returncode == 0 and "--compute-dtype" in proc.stdout
