"""The ops of the port's bf16 training lane against the JAX package, on the CPU.

The bf16 forms of the three backward kernels, through their plain versions
(which the wrappers run on a CPU tensor), against the JAX kernels on bf16
operands in interpret mode: K2' (`lstm_bwd_bf16`) against `_bwd_pallas` at
ndir 1 and 2, K6' (`attention_packed_bwd_bf16`) against `_bwd_packed` at dh
64 and 16, K4' (`attention_bwd_bf16`) against the per-slice `_bwd_pallas`
at dh 128, each at L 37 and 128 (K2' at 37), rates 0 and 0.1; then the
bf16 softmax and sigmoid backwards against `jax.vjp` of `jax.nn.softmax`
and `jax.nn.sigmoid` on bf16 under jit (the softmax's sum of its bf16 terms
as XLA sums them, and as the port does), and the output head (LayerNorm,
Linear, softmax over positions) against JAX's.

The CUDA kernels' order of work: K2''s bf16 instance takes the carried dh
and dW_hh^T from dgates' three bf16 parts (hi + mid + lo, exact) on the
tensor cores, each part's product an f32 sum, dW_hh^T over chunks of
64-row boxes of (t, b) rows summed in order; that order is emulated at L =
300 below and held to the JAX kernel at (a)'s tolerances. K4' and K6' round exactly the values the
plain versions round (ds and pd from f32 p, dp and delta; dq, dk and dv from
f32 sums), and differ from them only in the order of those f32 sums (the
tensor cores' accumulation, 64 keys or queries a tile): f32 noise of about
1e-7 of each sum against a tolerance of 2 bf16 steps (2^-7 of the max
abs), so that order is not emulated; tests/test_torch_card.py holds the
kernels to the plain versions at L = 300 at the same tolerance.

Inputs are made with numpy from fixed seeds; bf16 values are the
round-to-nearest-even casts of the same float32 arrays on both sides.
"""

import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlt_tpu.ops.attention as jax_attention
from rlt_tpu import config as jax_config
from rlt_tpu import train as jax_train
from rlt_tpu.ops import lstm as jax_lstm
from rlt_tpu_torch import train
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.models import layers
from rlt_tpu_torch.ops import attention, lstm
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

# (a) K2': dxw is the f32 dgates rounded to bf16; the plain loop's f32 sums
# (the gates' 128-term products, the carried dh's 512-term contraction) run
# in another order than the JAX kernel's, so a dgate that lands within that
# order's noise of a rounding boundary may round the other way: one bf16
# ulp of each element, beyond the f32 order noise itself (DW_REL of the max
# abs), which a dgate made small by cancellation (dc (1 - g^2) near g = 1)
# carries at many of its own ulps. dW_hh^T is f32 from the f32 dgates: 1e-5
# of its max abs, as in float32.
DXW_ULPS = 1
DW_REL = 1e-5
# (b), (c) K6' and K4': dq, dk and dv are bf16 sums of products of the same
# rounded ds and pd; a sum in another order may round the other way, and a
# ds or pd within f32 noise of a rounding boundary may too: within 2 bf16
# steps of each one's max abs (the bf16 forward's o tolerance,
# tests/test_torch_bf16.py). Rounding
# what the JAX kernels round leaves nearly every element bit-equal (99.95%
# or more measured; 58% with ds and pd left in f32): at least EQUAL_FRAC.
GRAD_ULPS_OF_MAX = 2
EQUAL_FRAC = 0.99


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
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(np.ascontiguousarray(x)).bfloat16()


def _to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype (bf16 or f32)."""
    t = torch.from_numpy(_f32(a).copy())
    return t.bfloat16() if a.dtype == jnp.bfloat16 else t


# ---------------------------------------------------------------------------
# (a) K2' bf16
# ---------------------------------------------------------------------------

def _lstm_bwd_inputs(seed: int, ndir: int, length: int, batch: int = 3,
                     hidden: int = 128):
    """bf16 xw, W_hh^T and dho, and the JAX kernel's bf16 hs and f32 cs
    from them, as JAX arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(length, ndir * batch, 4 * hidden)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(ndir * hidden, 4 * hidden)) / np.sqrt(hidden)
         ).astype(np.float32)
    dho = rng.normal(size=(length, ndir * batch, hidden)).astype(np.float32)
    (jxw, txw), (jw, tw), (jdho, tdho) = _both(xw), _both(w), _both(dho)
    jhs, jcs = jax_lstm._fwd_pallas(True, ndir, jxw, jw)
    jax_args = (jxw, jw, jhs, jcs, jdho)
    return jax_args, (txw, tw, _to_torch(jhs), _to_torch(jcs), tdho)


def _assert_dxw(got: torch.Tensor, want) -> None:
    want = _f32(want)
    assert got.dtype == torch.bfloat16
    limit = DXW_ULPS * bf16_ulp(want) + DW_REL * np.abs(want).max()
    assert np.all(np.abs(got.float().numpy() - want) <= limit)


def _dw_err(got: np.ndarray, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("ndir", [1, 2])
def test_lstm_bwd_bf16_matches_jax_kernel(ndir):
    jax_args, args = _lstm_bwd_inputs(300 + ndir, ndir, 37)
    want_dxw, want_dw = jax_lstm._bwd_pallas(True, ndir, *jax_args)
    assert want_dxw.dtype == jnp.bfloat16 and want_dw.dtype == jnp.float32
    dxw, dw = lstm.lstm_bwd_bf16(*args, ndir)
    assert dw.dtype == torch.float32
    _assert_dxw(dxw, want_dxw)
    assert _dw_err(dw.numpy(), want_dw) <= DW_REL
    # dW_hh^T taken from the rounded dxw (the f32 instance's in-place read of
    # dgates, done on a bf16 dxw) computes another function: it misses
    _, _, hs, _, _ = args
    rounded = torch.cat([h.float().reshape(-1, 128).T @ d.float().reshape(-1, 512)
                         for h, d in zip(hs[:-1].chunk(ndir, dim=1),
                                         dxw[1:].chunk(ndir, dim=1))])
    assert _dw_err(rounded.numpy(), want_dw) > DW_REL


def _per_dir(a: torch.Tensor, ndir: int, axis: int = 0) -> tuple:
    return a.split(a.shape[axis] // ndir, dim=axis)


def _parts(x: torch.Tensor) -> tuple:
    """The bf16 kernels' split of an f32 x into hi + mid + lo, each a bf16
    value (as f32), each difference taken in f32."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, ((x - hi) - mid).bfloat16().float()


def k2_bf16_emulated(xw, w_hh_t, hs, cs, dho, ndir):
    """K2''s bf16 instance in its order of work, from bf16 xw, W_hh^T, hs
    and dho (f32 cs): the gates of every step from the rounded h_{t-1} and
    the widened weights; the chain's f32 dgates, its carried dh the product
    of dgates' three bf16 parts with W_hh, one f32 sum a part, summed as
    (hi + lo) + mid; dxw their rounding (hi); dW_hh^T from the three parts
    over chunks of the 64-row boxes (`lstm.dw_boxes`), summed in order."""
    length, rows, gates4 = xw.shape
    hidden = gates4 // 4
    batch = rows // ndir
    xw, w_hh_t, hs, dho = (t.float() for t in (xw, w_hh_t, hs, dho))
    w_dirs = _per_dir(w_hh_t, ndir)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
    gates = xw + torch.cat([h @ w for h, w in zip(_per_dir(h_prev, ndir, 1), w_dirs)], dim=1)
    i, f, g, o = gates.split(hidden, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    tanh_c = torch.tanh(cs)
    coef = [g * (i * (1 - i)), c_prev * (f * (1 - f)), i * (1 - g * g),
            tanh_c * (o * (1 - o))]
    gam = o * (1 - tanh_c * tanh_c)
    dg = torch.empty_like(xw)
    dh_carry = dc_carry = torch.zeros(rows, hidden)
    for t in range(length - 1, -1, -1):
        dh = dho[t] + dh_carry
        dc = dc_carry + dh * gam[t]
        dc_carry = dc * f[t]
        dgates = torch.cat([dc * coef[0][t], dc * coef[1][t], dc * coef[2][t],
                            dh * coef[3][t]], dim=-1)
        dg[t] = dgates
        hi, mid, lo = (torch.cat([d @ w.T for d, w in zip(_per_dir(p, ndir), w_dirs)])
                       for p in _parts(dgates))
        dh_carry = (hi + lo) + mid
    splits = lstm.dw_splits_bf16(length, batch)
    rows, steps, _ = lstm.dw_boxes(batch)
    boxes = [(t, b0) for t in range(1, length, steps) for b0 in range(0, batch, 64)]
    chunk = -(-len(boxes) // splits)
    dws = []
    for a, b in zip(_per_dir(hs, ndir, 1), _per_dir(dg, ndir, 1)):
        dw = torch.zeros(hidden, gates4)
        for s in range(splits):
            part = torch.zeros(hidden, gates4)
            for t, b0 in boxes[s * chunk:(s + 1) * chunk]:
                h_box = a[t - 1:t - 1 + steps, b0:b0 + rows][:length - t].reshape(-1, hidden)
                for p in _parts(b[t:t + steps, b0:b0 + rows].reshape(-1, gates4)):
                    part = part + h_box.T @ p
            dw = dw + part
        dws.append(dw)
    return dg.bfloat16(), torch.cat(dws)


def test_k2_bf16_order_of_work_meets_the_jax_tolerances():
    """At the main paths' L = 300 (B = 4 per direction, both directions):
    K2''s bf16 order emulated against the JAX kernel, at (a)'s tolerances."""
    jax_args, args = _lstm_bwd_inputs(310, 2, 300, batch=4)
    want_dxw, want_dw = jax_lstm._bwd_pallas(True, 2, *jax_args)
    dxw, dw = k2_bf16_emulated(*args, 2)
    _assert_dxw(dxw, want_dxw)
    assert _dw_err(dw.numpy(), want_dw) <= DW_REL


# ---------------------------------------------------------------------------
# (b), (c) K6' and K4' bf16
# ---------------------------------------------------------------------------

PACKED_WIDTHS = {64: (256, 4, 2), 16: (128, 8, 8)}  # dh: (D, heads, pack)


def _seed_streams(n: int, seed: int = 13):
    return (jnp.full((1,), seed, jnp.int32),
            attention._streams(torch.tensor(seed), n).to(torch.int32))


def _assert_grads(got, want) -> None:
    for g, w in zip(got, want):
        w = _f32(w)
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        limit = GRAD_ULPS_OF_MAX * bf16_ulp(np.abs(w).max())
        err = np.abs(g.float().numpy() - w).max()
        assert err <= limit, f"max abs err {err} > {limit}"
        assert np.mean(g.float().numpy() == w) >= EQUAL_FRAC


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dh,length", [(64, 37), (64, 128), (16, 37), (16, 128)])
def test_attention_packed_bwd_bf16_matches_jax_kernel(dh, length, rate):
    d, heads, pack = PACKED_WIDTHS[dh]
    rng = np.random.default_rng(320 + dh + length)
    n = 2
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _both(rng.normal(size=(n, length, d)).astype(np.float32)) for _ in range(4))
    seed, streams = _seed_streams(n)
    jo, jlse = jax_attention._fwd_packed(rate, True, heads, pack, jq, jk, jv, seed)
    want = jax_attention._bwd_packed(rate, True, heads, pack, jq, jk, jv, jo, jlse, jdo,
                                     seed)
    assert all(w.dtype == jnp.bfloat16 for w in want)
    got = attention.attention_packed_bwd_bf16(tq, tk, tv, _to_torch(jo), _to_torch(jlse),
                                              tdo, heads, pack, rate, streams)
    _assert_grads(got, want)


@pytest.mark.parametrize("length,rate", [(37, 0.0), (128, 0.0), (37, 0.1), (128, 0.1)])
def test_attention_bwd_bf16_matches_jax_kernel(length, rate):
    rng = np.random.default_rng(340 + length)
    batch, heads = 2, 2
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _both(rng.normal(size=(batch, heads, length, 128)).astype(np.float32))
        for _ in range(4))
    seed, streams = _seed_streams(batch * heads)
    jo, jlse = jax_attention._fwd_pallas(rate, True, jq, jk, jv, seed)
    want = jax_attention._bwd_pallas(rate, True, jq, jk, jv, jo, jlse, jdo, seed)
    got = attention.attention_bwd_bf16(tq, tk, tv, _to_torch(jo), _to_torch(jlse), tdo,
                                       rate, streams)
    _assert_grads(got, want)


def test_attention_bwd_bf16_rounds_ds_and_pd():
    """The rounding of ds and pd before the products is what the JAX kernel
    does: the same backward with them left in f32 (and its results rounded)
    leaves far fewer elements bit-equal to JAX's."""
    rng = np.random.default_rng(350)
    d, heads, pack = PACKED_WIDTHS[64]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _both(rng.normal(size=(2, 128, d)).astype(np.float32)) for _ in range(4))
    seed, _ = _seed_streams(2)
    jo, jlse = jax_attention._fwd_packed(0.0, True, heads, pack, jq, jk, jv, seed)
    want = jax_attention._bwd_packed(0.0, True, heads, pack, jq, jk, jv, jo, jlse, jdo, seed)
    unrounded = attention.attention_packed_bwd_plain(
        *(t.float() for t in (tq, tk, tv, _to_torch(jo))), _to_torch(jlse), tdo.float(),
        heads, pack)
    assert all(np.mean(to_bf16(g.numpy()) == _f32(w)) < EQUAL_FRAC
               for g, w in zip(unrounded, want))


def test_bf16_bwd_wrappers_keep_their_dtypes():
    jax_args, args = _lstm_bwd_inputs(360, 1, 3)
    xw, w, hs, cs, dho = args
    with pytest.raises(TypeError, match="lstm_bwd_bf16"):
        lstm.lstm_bwd(*args)
    with pytest.raises(TypeError, match="bf16"):
        lstm.lstm_bwd_bf16(xw.float(), w.float(), hs.float(), cs, dho.float())
    q = torch.zeros(1, 8, 256, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8, 2)
    with pytest.raises(TypeError, match="attention_packed_bwd_bf16"):
        attention.attention_packed_bwd(q, q, q, q, lse, q, 4, 2)
    with pytest.raises(TypeError, match="bf16"):
        attention.attention_packed_bwd_bf16(*(t.float() for t in (q, q, q, q)), lse,
                                            q.float(), 4, 2)
    s = q.reshape(1, 2, 8, 128)
    with pytest.raises(TypeError, match="attention_bwd_bf16"):
        attention.attention_bwd(s, s, s, s, torch.zeros(2, 1, 8), s)


def test_lstm_recurrence_returns_the_f32_weight_gradient_unrounded():
    """Trouble 1: the LSTM op given an f32 W_hh^T beside bf16 xw rounds it for
    the kernels and returns K2''s f32 dW_hh^T, which matches the JAX
    custom_vjp's f32 gradient to f32 precision and is not bf16-rounded; given
    a bf16 W_hh^T, autograd rounds the same gradient to bf16."""
    rng = np.random.default_rng(370)
    xw = rng.normal(size=(37, 6, 512)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(256, 512)) / np.sqrt(128)).astype(np.float32)
    g = rng.normal(size=(37, 6, 128)).astype(np.float32)

    def jax_loss(w32):
        hs = jax_lstm._fused_lstm(True, 2, jnp.asarray(xw, jnp.bfloat16),
                                  w32.astype(jnp.bfloat16))
        return jnp.sum(hs.astype(jnp.float32) * jnp.asarray(to_bf16(g)))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(w)))
    master = torch.from_numpy(w).requires_grad_()
    hs = lstm.LSTMRecurrence.apply(torch.from_numpy(xw).bfloat16(), master, 2)
    hs.float().backward(torch.from_numpy(to_bf16(g)))
    got = master.grad.numpy()
    assert master.grad.dtype == torch.float32
    assert _dw_err(got, want) <= DW_REL
    assert np.mean(to_bf16(got) != got) > 0.9  # bits below bf16 precision
    cast = torch.from_numpy(w).requires_grad_()
    hs = lstm.LSTMRecurrence.apply(torch.from_numpy(xw).bfloat16(), cast.bfloat16(), 2)
    hs.float().backward(torch.from_numpy(to_bf16(g)))
    assert np.all(to_bf16(cast.grad.numpy()) == cast.grad.numpy())


# ---------------------------------------------------------------------------
# (e) the bf16 softmax and sigmoid backwards against jax.vjp
#
# XLA on the CPU evaluates these backwards with no excess precision: every op
# rounds to bf16 (the forward's rule, that a bf16 op widened at once by the
# JAX code stays f32, finds no such widening here), a final head's f32
# cotangent is rounded to bf16 at the transpose of its convert, and
# jax.nn.softmax (the quotient exp(x - max) / sum, which JAX differentiates
# op by op) sums its bf16 terms in windows of 32 with every add rounded
# (`_xla_bf16_sum` below). The port rounds every op the same but sums those
# terms in f32 and rounds once (`layers._sum_bf16`: one reduction on the
# card, not the windows' ~40 dependent adds): with the windowed sum put in
# its place the port's backwards agree with JAX's bit for bit, and with its
# own sum the two are two roundings of the exact backward, the port's error
# within SOFTMAX_ERR_OF_JAX of JAX's own (RMS and max against the float64
# backward of the same bf16 inputs; 1.26 and 1.31 read at L = 300, where
# the sums part most).
# ---------------------------------------------------------------------------

SOFTMAX_ERR_OF_JAX = 1.5
# a gradient zero by algebra, rounding noise on both sides: within this
# share of the largest gradient (tests/test_torch_bf16_train.py)
ZERO_GRAD_REL = 0.1


def _xla_bf16_sum(z: torch.Tensor, dim: int, window: int = 32) -> torch.Tensor:
    """The sum over `dim` of bf16 values z (held in f32) as XLA on the CPU
    reduces a bf16 array: past 32 elements in windows of 32 (the axis padded
    with zeros, half before and half after), each window summed in order,
    then the window sums in order, every add rounded to bf16. Returned in
    f32, with `dim` kept."""
    z = z.to(torch.bfloat16).movedim(dim, -1)
    n = z.shape[-1]
    if n > window:
        nw = -(-n // window)
        lo = (nw * window - n) // 2
        z = torch.nn.functional.pad(z, (lo, nw * window - n - lo))
        z = z.reshape(*z.shape[:-1], nw, window)
        acc = z[..., 0]
        for i in range(1, window):
            acc = acc + z[..., i]
        z = acc
    acc = z[..., 0]
    for i in range(1, z.shape[-1]):
        acc = acc + z[..., i]
    return acc.float().unsqueeze(-1).movedim(-1, dim)


@pytest.fixture
def xla_sum(monkeypatch):
    """The port's bf16 softmax backward with XLA's windowed sum."""
    monkeypatch.setattr(layers, "_sum_bf16", _xla_bf16_sum)


def _softmax_vjp_f64(x: torch.Tensor, g: torch.Tensor, axis: int) -> np.ndarray:
    """The exact softmax backward, y (g - sum(y g)), of the bf16 x and the
    cotangent as the backward reads it (a final head's rounded to bf16), in
    float64."""
    x, g = x.double().numpy(), g.bfloat16().double().numpy()
    y = np.exp(x - x.max(axis=axis, keepdims=True))
    y /= y.sum(axis=axis, keepdims=True)
    return y * (g - (y * g).sum(axis=axis, keepdims=True))


def _jax_vjp(fn, x, g, final: bool):
    def run(a, gg):
        _, f = jax.vjp(lambda t: fn(t).astype(jnp.float32) if final else fn(t), a)
        return f(gg)[0]
    return _f32(jax.jit(run)(x, g))


def _port_vjp(fn, x: torch.Tensor, g: torch.Tensor) -> np.ndarray:
    x = x.clone().requires_grad_()
    fn(x).backward(g)
    assert x.grad.dtype == torch.bfloat16
    return x.grad.float().numpy()


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("shape,axis", [((4, 300, 1), 1), ((3, 37, 1), 1),
                                        ((2, 128, 1), 1), ((63, 3), -1), ((5, 2), -1)])
def test_softmax_bf16_backward_matches_jax(shape, axis, final, monkeypatch):
    rng = np.random.default_rng(380 + shape[1])
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    g = (rng.normal(size=shape) * 0.01).astype(np.float32)
    jx, tx = _both(x)
    jg = jnp.asarray(g, jnp.float32 if final else jnp.bfloat16)
    tg = torch.from_numpy(g) if final else torch.from_numpy(g).bfloat16()
    want = _jax_vjp(lambda t: jax.nn.softmax(t, axis=axis), jx, jg, final)
    got = _port_vjp(lambda t: layers.softmax(t, dim=axis, final=final), tx, tg)
    exact = _softmax_vjp_f64(tx, tg, axis)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))  # noqa: E731
    assert rms(got - exact) <= SOFTMAX_ERR_OF_JAX * rms(want - exact)
    assert np.abs(got - exact).max() <= SOFTMAX_ERR_OF_JAX * np.abs(want - exact).max()
    monkeypatch.setattr(layers, "_sum_bf16", _xla_bf16_sum)
    got = _port_vjp(lambda t: layers.softmax(t, dim=axis, final=final), tx, tg)
    np.testing.assert_array_equal(got, want)


def test_softmax_bf16_backward_needs_the_windowed_sum():
    """With the bf16 terms summed in f32 and rounded once, as the port sums
    them, the softmax backward over 300 positions does not match JAX's bit
    for bit: that needs XLA's windowed sum."""
    rng = np.random.default_rng(390)
    x = (rng.normal(size=(4, 300, 1)) * 3).astype(np.float32)
    g = (rng.normal(size=(4, 300, 1)) * 0.01).astype(np.float32)
    jx, tx = _both(x)
    want = _jax_vjp(lambda t: jax.nn.softmax(t, axis=1), jx, jnp.asarray(g, jnp.bfloat16),
                    False)
    got = _port_vjp(lambda t: layers.softmax(t, dim=1), tx, torch.from_numpy(g).bfloat16())
    assert np.mean(got != want) > 0.05


def test_softmax_bf16_backward_residual_is_rounding(xla_sum):
    """The residual sum_i dx_i of the bf16 softmax backward, zero in exact
    arithmetic, is a rounding of JAX's own; the port's equals it on the same
    inputs (with XLA's windowed sum), and an input one bf16 step away moves
    it by a rounding step. This is why the whole models' leaves fed by that
    residual (a decision head's weight, the last LayerNorm's) part from
    JAX's as two independent roundings (tests/test_torch_bf16_train.py)."""
    rng = np.random.default_rng(391)
    x = (rng.normal(size=(2, 128, 1)) * 3).astype(np.float32)
    g = (rng.normal(size=(2, 128, 1)) * 0.01).astype(np.float32)
    jx, tx = _both(x)
    want = _jax_vjp(lambda t: jax.nn.softmax(t, axis=1), jx, jnp.asarray(g), True)
    got = _port_vjp(lambda t: layers.softmax(t, dim=1, final=True), tx, torch.from_numpy(g))
    residual = want.sum(axis=1)
    assert np.all(residual != 0.0)
    np.testing.assert_array_equal(got.sum(axis=1), residual)
    x2 = to_bf16(x)
    x2[:, 7] = x2[:, 7] + bf16_ulp(x2[:, 7])  # one element one bf16 step up
    moved = _jax_vjp(lambda t: jax.nn.softmax(t, axis=1), jnp.asarray(x2, jnp.bfloat16),
                     jnp.asarray(g), True).sum(axis=1)
    assert np.any(moved != residual)


@pytest.mark.parametrize("final", [False, True])
def test_sigmoid_bf16_backward_matches_jax(final):
    rng = np.random.default_rng(392)
    x = (rng.normal(size=(4, 128, 1)) * 3).astype(np.float32)
    g = (rng.normal(size=(4, 128, 1)) * 0.01).astype(np.float32)
    jx, tx = _both(x)
    jg = jnp.asarray(g, jnp.float32 if final else jnp.bfloat16)
    tg = torch.from_numpy(g) if final else torch.from_numpy(g).bfloat16()
    want = _jax_vjp(jax.nn.sigmoid, jx, jg, final)
    got = _port_vjp(lambda t: layers.sigmoid(t, final=final), tx, tg)
    np.testing.assert_array_equal(got, want)


def test_output_head_bf16_backward_matches_jax():
    """LayerNorm on a residual sum, a decision Linear and the softmax over
    positions of a final head, under AttnCut's criterion, differentiated in
    bf16 against JAX (flax's LayerNorm, its TorchLinear, jax.nn.softmax and
    its loss): each input's and parameter's gradient within its own d_ref
    (JAX bf16 - JAX f32), as the whole models' leaves, but the LayerNorm
    bias, which is zero by algebra (it shifts every logit alike) and holds
    only the softmax backward's residual, another draw of which the port's
    own sum makes: within ZERO_GRAD_REL of the largest gradient, as the
    whole models' zero-by-algebra leaves."""
    _output_head_check(xla_windows=False)


def test_output_head_bf16_backward_with_xla_sum_matches_jax(xla_sum):
    """The same with XLA's windowed sum in the port's softmax backward:
    every leaf within its d_ref, the LayerNorm bias too."""
    _output_head_check(xla_windows=True)


def _output_head_check(xla_windows: bool) -> None:
    rng = np.random.default_rng(393)
    batch, length, d = 2, 128, 256
    x, y2 = (rng.normal(size=(batch, length, d)).astype(np.float32) for _ in range(2))
    scale = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(1, d)) / 16).astype(np.float32)
    b = np.array([0.03], np.float32)
    labels = (rng.random((batch, length)) < 0.3).astype(np.float32)
    labels[:, 0] = 1.0
    valid = np.ones(batch, np.float32)
    jax_crit = jax_train.make_criterion(jax_config.TrainConfig(model_name="attncut"))
    norm = flax_nn.LayerNorm(epsilon=1e-5)

    def jax_loss(args, dtype):
        x, y2, scale, bias, w, b = (a.astype(dtype) for a in args)
        h = norm.apply({"params": {"scale": scale, "bias": bias}}, x + y2)
        out = jax.nn.softmax(h @ w.T + b, axis=1).astype(jnp.float32)
        return jax_crit(out, jnp.asarray(labels), valid=jnp.asarray(valid))

    args = tuple(map(jnp.asarray, (x, y2, scale, bias, w, b)))
    want, want32 = (jax.jit(jax.grad(functools.partial(jax_loss, dtype=dt)))(args)
                    for dt in (jnp.bfloat16, jnp.float32))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, y2, scale, bias, w, b)]
    tx, ty2, tscale, tbias, tw, tb = (t.bfloat16() for t in leaves)
    ln = layers.LayerNorm(d)
    h = torch.func.functional_call(ln, {"weight": tscale, "bias": tbias},
                                   (layers.residual(tx, ty2),))
    out = layers.softmax(h @ tw.T + tb, dim=1, final=True)
    train.make_criterion(TrainConfig(model_name="attncut"))(
        out, torch.from_numpy(labels), valid=torch.from_numpy(valid)).backward()
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))  # noqa: E731
    largest = max(np.abs(np.asarray(w32)).max() for w32 in want32)
    for name, t, wb, w32 in zip(("x", "y2", "scale", "bias", "w", "b"), leaves, want, want32):
        got, wb, w32 = t.grad.numpy(), np.asarray(wb), np.asarray(w32)
        if name == "bias" and not xla_windows:
            assert np.abs(got).max() <= ZERO_GRAD_REL * largest
        else:
            assert rms(got - wb) <= rms(wb - w32), name
