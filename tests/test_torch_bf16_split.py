"""The precision argument of the bf16 LSTM kernels K1' and K2'
(`rlt_tpu_torch/csrc/lstm_bf16_mma.cuh`).

Their products run on the tensor cores with bf16 operands, while the
function they compute takes the step's product from an f32 operand: h_{t-1}
in K1', dgates in K2''s chain and in its dW_hh^T. The kernels give that
operand as three bf16 parts, x = hi + mid + lo with hi = bf16(x), mid =
bf16(x - hi) and lo = bf16(x - hi - mid), beside the bf16 W_hh^T (or hs),
which is exact as a bf16 operand. Here, on the f32 values that h and dgates
take in the plain versions (|h| < 1; dgates across several decades), on
zeros, signs, tiny magnitudes and values drawn across 200 binades:

- the three parts reconstruct every value exactly;
- the three-part product summed in f32, in the kernels' order (each part's
  product one f32 sum, then (hi + lo) + mid), is the f32 product up to the
  order of summation: within the f32 summation bound (K + 2) 2^-24
  sum |w x| of the exact product, as the f32 product itself is.

Three parts are kept: no two-part split is used.
"""

import numpy as np
import pytest
import torch

from rlt_tpu_torch.ops import lstm
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

H, L, B, NDIR = 128, 40, 5, 2
EPS32 = 2.0 ** -24


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).bfloat16().float().numpy()


def split3(x: np.ndarray):
    """The kernels' split: each difference taken in float32."""
    x = np.asarray(x, dtype=np.float32)
    hi = bf16(x)
    mid = bf16(x - hi)
    lo = bf16((x - hi) - mid)
    return hi, mid, lo


def _weights(seed: int, rows: int, cols: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return bf16((rng.uniform(-1, 1, size=(rows, cols)) / np.sqrt(H)).astype(np.float32))


def _plain_values():
    """h (f32 hs of the plain forward) and dgates (f32 dxw of the plain
    backward) at a small size, bf16-exact xw and W_hh^T."""
    rng = np.random.default_rng(60)
    xw = torch.from_numpy(bf16(rng.normal(size=(L, NDIR * B, 4 * H)).astype(np.float32)))
    w = torch.from_numpy(_weights(61, NDIR * H, 4 * H))
    hs, cs = lstm.lstm_recurrence_plain(xw, w, NDIR)
    dho = torch.from_numpy(rng.normal(size=tuple(hs.shape)).astype(np.float32))
    dxw, _ = lstm.lstm_bwd_plain(xw, w, hs, cs, dho, NDIR)
    return hs.numpy(), dxw.numpy()


_VALUES = {}


def values(kind: str) -> np.ndarray:
    if not _VALUES:
        h, dgates = _plain_values()
        rng = np.random.default_rng(62)
        decades = (rng.choice([-1.0, 1.0], size=4096)
                   * np.exp2(rng.uniform(-100, 100, size=4096))).astype(np.float32)
        edges = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.999999, 2.0 ** -100, -(2.0 ** -100),
                          1e-30, -1e-30, 3.0e38, np.nextafter(np.float32(1), np.float32(0))],
                         dtype=np.float32)
        _VALUES.update(h=h, dgates=dgates, decades=decades, edges=edges)
    return _VALUES[kind]


@pytest.mark.parametrize("kind", ["h", "dgates", "decades", "edges"])
def test_three_bf16_parts_reconstruct_exactly(kind):
    x = values(kind)
    assert np.all(np.isfinite(x))
    if kind == "h":
        assert np.abs(x).max() < 1.0
    if kind == "dgates":  # several decades, as the coefficients spread them
        mag = np.abs(x[x != 0])
        assert np.log10(mag.max() / mag.min()) > 4
    hi, mid, lo = split3(x)
    for part in (hi, mid, lo):
        assert np.array_equal(part, bf16(part))  # each part is a bf16 value
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    assert np.array_equal(total, x.astype(np.float64))
    # the sign goes with the value, and zero splits into zeros
    nh, nm, nl = split3(-x)
    assert np.array_equal(nh, -hi) and np.array_equal(nm, -mid) and np.array_equal(nl, -lo)
    assert not np.any(hi[x == 0]) and not np.any(mid[x == 0]) and not np.any(lo[x == 0])


def _products(w: np.ndarray, x: np.ndarray):
    """(exact, f32 product, three-part product in the kernels' order,
    sum |w x|) of w (K, N) bf16 and x (M, K) f32: x w."""
    exact = x.astype(np.float64) @ w.astype(np.float64)
    direct = x @ w
    hi, mid, lo = (p @ w for p in split3(x))  # each an f32 sum of exact products
    parts = (hi + lo) + mid
    scale = np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64)
    return exact, direct, parts, scale


@pytest.mark.parametrize("kind", ["h", "dgates"])
def test_three_part_product_is_the_f32_product(kind):
    x = values(kind)
    if kind == "h":  # K1''s step: h_{t-1} (rows, H) times W_hh^T (H, 4H)
        x2, w, depth = x.reshape(-1, H), _weights(63, H, 4 * H), H
    else:  # K2''s chain: dgates (rows, 4H) times W_hh (4H, H)
        x2, w, depth = x.reshape(-1, 4 * H), _weights(64, 4 * H, H), 4 * H
    exact, direct, parts, scale = _products(w, x2)
    bound = (depth + 2) * EPS32 * scale
    assert np.all(np.abs(direct - exact) <= bound)
    assert np.all(np.abs(parts - exact) <= bound)
    # and the parts are needed: hi alone (bf16 x) is another function
    hi_only = split3(x2)[0] @ w
    assert np.any(np.abs(hi_only - exact) > bound)


def test_dw_three_part_product_is_the_f32_product():
    """K2''s dW_hh^T: hs (bf16, exact) transposed times dgates' parts, over
    the (t, b) rows."""
    h, dgates = values("h"), values("dgates")
    hs = bf16(h[:-1].reshape(-1, H))                 # rows (t - 1, b)
    dg = dgates[1:].reshape(-1, 4 * H)                # rows (t, b)
    exact = hs.T.astype(np.float64) @ dg.astype(np.float64)
    parts = [hs.T @ p for p in split3(dg)]
    got = (parts[0] + parts[2]) + parts[1]
    scale = np.abs(hs.T).astype(np.float64) @ np.abs(dg).astype(np.float64)
    bound = (hs.shape[0] + 2) * EPS32 * scale
    assert np.all(np.abs(got - exact) <= bound)
