"""The precision argument of the attention kernels: the packed K5' and K6',
and the per-slice K3' and K4'.

Their products run on the tensor cores as tf32 matrix products in the
three-term split of `rlt_tpu_torch/csrc/attention_mma.cuh` (3xTF32): each
operand x is cut into x_hi = tf32(x) and x_lo = tf32(x - x_hi), and a b is
taken as a_lo b_hi + a_hi b_lo + a_hi b_hi in float32, small terms first.
Here that arithmetic is emulated in numpy (tf32 rounding to nearest even at
10 mantissa bits; the kernels' cvt.rna rounds ties away from zero, which
differs only at exact ties) and run through the kernels' own order of
operations, with the dropout mask of the port's `keep_mask`: the packed
kernels at MMOECut's widths (N = 2, L = 300, D = 256, 4 heads of dh = 64,
pack 2) and at Choopy's (D = 128, 8 heads of dh = 16, pack 8), whose
16-deep score products are two k-steps of the tensor cores' 8, each
product in one fresh accumulator; the per-slice ones at PLECut's (N = 2 rows of 2 heads of dh = 128,
L = 300), whose 128-deep score products (s = q k^T, dp = do v^T) are taken
as two 64-deep parts joined by a float32 add, as K3' and K4' take them. The
results must agree with the plain float32 versions within the card's
tolerances (ATTN_ATOL for o and lse, ATTN_BWD_REL of each gradient's max
abs), and a single tf32 product must miss them: that is why the kernels pay
for three.
"""

import functools

import numpy as np
import pytest
import torch

from rlt_tpu_torch.ops import attention
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

# the tolerances of tests/test_torch_card.py and chip_smoke.py
ATTN_ATOL = 1e-5
ATTN_BWD_REL = 1e-5
N, L = 2, 300
# the packed kernels' widths: (D, heads, pack) of MMOECut and of Choopy
PACKED = {"packed": (256, 4, 2), "packed_dh16": (128, 8, 8)}
# the per-slice kernels: N rows of SLICE_HEADS heads of SLICE_DH
SLICE_HEADS, SLICE_DH = 2, 128
SLICE_SCALE = np.float32(1.0 / np.sqrt(SLICE_DH))


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to tf32's 10 mantissa bits, to nearest even."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def matmul_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def matmul_1xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return tf32(a) @ tf32(b)


PRODUCTS = {"3xtf32": matmul_3xtf32, "1xtf32": matmul_1xtf32}


def _heads(t: torch.Tensor, heads: int) -> np.ndarray:
    """(N, L, D) -> (N, H, L, dh) float32 numpy."""
    return t.reshape(N, L, heads, -1).transpose(1, 2).numpy()


def _merge(x: np.ndarray) -> np.ndarray:
    return x.transpose(0, 2, 1, 3).reshape(N, L, -1)


@functools.lru_cache(maxsize=None)
def _inputs(kernels: str, rate: float):
    d, heads, pack = PACKED[kernels]
    rng = np.random.default_rng(40)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(N, L, d)).astype(np.float32))
                   for _ in range(4))
    streams = torch.from_numpy(rng.integers(-2**31, 2**31, size=N, dtype=np.int64)
                               .astype(np.int32))
    keep = attention.head_keep_mask(streams, heads, pack, L, rate).numpy()
    return q, k, v, do, streams, keep


def _emulated_fwd(matmul, heads, pack, q, k, v, keep, rate):
    """K5''s order: s = q k^T scale, per-head max, weights exp(s - m)
    summed before dropout, o = (weights v) / sum, lse = m + log(sum)."""
    qh, kh, vh = (_heads(t, heads) for t in (q, k, v))
    s = matmul(qh, kh.transpose(0, 1, 3, 2)) * np.float32(1.0 / np.sqrt(qh.shape[-1]))
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    total = e.sum(-1, keepdims=True, dtype=np.float32)
    if rate > 0.0:
        e = np.where(keep, e * np.float32(1.0 / (1.0 - rate)), np.float32(0.0))
    o = matmul(e, vh) / total
    lse = (m + np.log(total))[..., 0].reshape(N, heads // pack, pack, L).transpose(0, 1, 3, 2)
    return _merge(o), lse


def _emulated_bwd(matmul, heads, q, k, v, o, lse, do, keep, rate):
    """K6''s order: p = exp(q k^T scale - lse), dp = do v^T, the keep mask
    on dp and on pd, ds = p (dp - delta) scale, dq = ds k, dk = ds^T q,
    dv = pd^T do."""
    qh, kh, vh, oh, doh = (_heads(t, heads) for t in (q, k, v, o, do))
    scale = np.float32(1.0 / np.sqrt(qh.shape[-1]))
    lse_h = lse.transpose(2, 3).reshape(N, heads, L).numpy()[..., None]
    p = np.exp(matmul(qh, kh.transpose(0, 1, 3, 2)) * scale - lse_h)
    dp = matmul(doh, vh.transpose(0, 1, 3, 2))
    pd = p
    if rate > 0.0:
        inv = np.float32(1.0 / (1.0 - rate))
        pd = np.where(keep, p * inv, np.float32(0.0))
        dp = np.where(keep, dp * inv, np.float32(0.0))
    delta = (doh * oh).sum(-1, keepdims=True, dtype=np.float32)
    ds = p * (dp - delta) * scale
    return (_merge(matmul(ds, kh)), _merge(matmul(ds.transpose(0, 1, 3, 2), qh)),
            _merge(matmul(pd.transpose(0, 1, 3, 2), doh)))


def _fwd_err(kernels: str, products: str, rate: float) -> float:
    _, heads, pack = PACKED[kernels]
    q, k, v, _, streams, keep = _inputs(kernels, rate)
    want_o, want_lse = attention.attention_packed_plain(q, k, v, heads, pack, rate, streams)
    o, lse = _emulated_fwd(PRODUCTS[products], heads, pack, q, k, v, keep, rate)
    assert o.dtype == np.float32 and np.isfinite(o).all()
    return max(np.abs(o - want_o.numpy()).max(), np.abs(lse - want_lse.numpy()).max())


def _bwd_rel_err(kernels: str, products: str, rate: float) -> float:
    _, heads, pack = PACKED[kernels]
    q, k, v, do, streams, keep = _inputs(kernels, rate)
    o, lse = attention.attention_packed_plain(q, k, v, heads, pack, rate, streams)
    want = attention.attention_packed_bwd_plain(q, k, v, o, lse, do, heads, pack, rate,
                                                streams)
    got = _emulated_bwd(PRODUCTS[products], heads, q, k, v, o, lse, do, keep, rate)
    errs = []
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.dtype == np.float32 and np.isfinite(g).all()
        errs.append(np.abs(g - w).max() / np.abs(w).max())
    return max(errs)


@functools.lru_cache(maxsize=None)
def _slice_inputs(rate: float):
    rng = np.random.default_rng(41)
    shape = (N, SLICE_HEADS, L, SLICE_DH)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   for _ in range(4))
    streams = torch.from_numpy(rng.integers(-2**31, 2**31, size=N * SLICE_HEADS,
                                            dtype=np.int64).astype(np.int32))
    keep = attention.slice_keep_mask(streams, L, rate).numpy().reshape(N, SLICE_HEADS, L, L)
    return q, k, v, do, streams, keep


def _scores(matmul, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a b^T over dh = 128 as K3' and K4' take it: two 64-deep parts, each
    in its own accumulator, joined by a float32 add."""
    half = SLICE_DH // 2
    return (matmul(a[..., :half], b[..., :half].transpose(0, 1, 3, 2))
            + matmul(a[..., half:], b[..., half:].transpose(0, 1, 3, 2)))


def _emulated_slice_fwd(matmul, q, k, v, keep, rate):
    """K3''s order: s from two 64-deep parts, times scale, the row max,
    weights exp(s - m) summed before dropout, o = (weights v) / sum, lse =
    m + log(sum)."""
    s = _scores(matmul, q.numpy(), k.numpy()) * SLICE_SCALE
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    total = e.sum(-1, keepdims=True, dtype=np.float32)
    if rate > 0.0:
        e = np.where(keep, e * np.float32(1.0 / (1.0 - rate)), np.float32(0.0))
    o = matmul(e, v.numpy()) / total
    lse = (m + np.log(total)).reshape(N * SLICE_HEADS, 1, L)
    return o, lse


def _emulated_slice_bwd(matmul, q, k, v, o, lse, do, keep, rate):
    """K4''s order: p = exp(s scale - lse) and dp = do v^T, each from two
    64-deep parts; the keep mask on dp and on pd, ds = p (dp - delta) scale,
    dq = ds k, dk = ds^T q, dv = pd^T do."""
    qn, kn, vn, on, don = (t.numpy() for t in (q, k, v, o, do))
    p = np.exp(_scores(matmul, qn, kn) * SLICE_SCALE
               - lse.numpy().reshape(N, SLICE_HEADS, L, 1))
    dp = _scores(matmul, don, vn)
    pd = p
    if rate > 0.0:
        inv = np.float32(1.0 / (1.0 - rate))
        pd = np.where(keep, p * inv, np.float32(0.0))
        dp = np.where(keep, dp * inv, np.float32(0.0))
    delta = (don * on).sum(-1, keepdims=True, dtype=np.float32)
    ds = p * (dp - delta) * SLICE_SCALE
    return (matmul(ds, kn), matmul(ds.transpose(0, 1, 3, 2), qn),
            matmul(pd.transpose(0, 1, 3, 2), don))


def _slice_fwd_err(products: str, rate: float) -> float:
    q, k, v, _, streams, keep = _slice_inputs(rate)
    want_o, want_lse = attention.attention_plain(q, k, v, rate, streams)
    o, lse = _emulated_slice_fwd(PRODUCTS[products], q, k, v, keep, rate)
    assert o.dtype == np.float32 and np.isfinite(o).all()
    return max(np.abs(o - want_o.numpy()).max(), np.abs(lse - want_lse.numpy()).max())


def _slice_bwd_rel_err(products: str, rate: float) -> float:
    q, k, v, do, streams, keep = _slice_inputs(rate)
    o, lse = attention.attention_plain(q, k, v, rate, streams)
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, rate, streams)
    got = _emulated_slice_bwd(PRODUCTS[products], q, k, v, o, lse, do, keep, rate)
    errs = []
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.dtype == np.float32 and np.isfinite(g).all()
        errs.append(np.abs(g - w).max() / np.abs(w).max())
    return max(errs)


# each kernel pair's (forward error, backward relative error)
ERRORS = {name: (functools.partial(_fwd_err, name), functools.partial(_bwd_rel_err, name))
          for name in PACKED}
ERRORS["slice"] = (_slice_fwd_err, _slice_bwd_rel_err)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                  1.0 + 2.0**-11 + 2.0**-20, -3.0 - 2.0**-12], np.float32)
    want = np.array([1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2 * 2.0**-10,
                     1.0 + 2.0**-10, -3.0], np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    hi = tf32(x)
    np.testing.assert_array_equal(hi + tf32(x - hi), x)  # the split is exact here


@pytest.mark.parametrize("kernels", ["packed", "packed_dh16", "slice"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_3xtf32_split_meets_the_card_tolerance(direction, rate, kernels):
    fwd_err, bwd_rel_err = ERRORS[kernels]
    if direction == "forward":
        assert fwd_err("3xtf32", rate) <= ATTN_ATOL
    else:
        assert bwd_rel_err("3xtf32", rate) <= ATTN_BWD_REL


@pytest.mark.parametrize("kernels", ["packed", "packed_dh16", "slice"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_one_tf32_product_misses_the_card_tolerance(direction, rate, kernels):
    fwd_err, bwd_rel_err = ERRORS[kernels]
    if direction == "forward":
        assert fwd_err("1xtf32", rate) > 10 * ATTN_ATOL
    else:
        assert bwd_rel_err("1xtf32", rate) > 10 * ATTN_BWD_REL
