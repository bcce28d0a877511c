"""Attention ops: per-slice CUDA kernels K3' (forward) and K4' (backward),
head-packed CUDA kernels K5' (forward) and K6' (backward), their plain
PyTorch versions, and the dropout mask they share.

Per-slice (`fused_attention`, the counterpart of the JAX package's
`fused_attention` and its custom_vjp; PLECut's heads of dh = 128): q, k, v
are (B, H, L, dh), the JAX layout, and every (batch, head) slice computes
softmax(q k^T / sqrt(dh)) v on its own. lse comes back as (B * H, 1, L).
Slice n = b * H + h has the dropout stream `streams[n]`, and its keep mask is
`keep_mask(streams[n], (L, L), rate)`: score (i, j) at index i * L + j, with
no head group. On a CUDA tensor the forward launches the kernel of
`rlt_tpu_torch/csrc/attention_fwd.cu` and the backward those of
`csrc/attention_bwd.cu` (a dq pass, then a dk/dv pass; dh = 128, float32,
L <= 65535, both streaming 64-row tiles, their products on the tensor
cores in the 3xTF32 split that keeps float32 accuracy, each pair of warps
sharing a slice's 16 rows between the two halves of dh); on a CPU tensor
they run `attention_plain` and `attention_bwd_plain`. Every other dh from
1 to MAX_HEAD_DIM launches `csrc/attention_any_dh.cu` (the instances
`attention_fwd_any`, `attention_bwd_any`, counted apart): the packed
kernels' body at one head in a group of one, which is the per-slice layout,
lse layout and stream rule.

Head-packed (`fused_attention_packed`, the counterpart of the JAX package's
`fused_attention_packed` and its custom_vjp; the heads of dh = 64 of MMOECut,
MOECut, AttnCut and MtAttnCut, 4 in groups of pack 2, and of dh = 16 of
Choopy and MtChoopy, 8 in one group of pack 8):
q, k, v are (N, L, D) with the H heads contiguous in the feature dim
(D = H * dh): the raw output of torch's head-major in_proj, so no head split
happens around the kernels. Each head computes
softmax(q_h k_h^T / sqrt(dh)) v_h; the log-sum-exp of every score row is
returned beside o in the JAX layout (N, H / pack, L, pack), and the backward
recomputes the probabilities from it.

Dropout on the softmax weights uses the JAX package's counter-based mask
(`keep_mask`, bit for bit). In the packed op, row n of the batch has the
int32 stream `streams[n]`, head h belongs to group h // pack whose stream is
`_group_stream(streams[n], h // pack)`, and its score (i, j) is element
(i, (h % pack) * L + j) of the group's (L, pack * L) tile. The JAX package
draws one seed per call and takes seed + n as row n's stream (`_streams`);
under its `nn.vmap` over experts each expert draws its own seed, so a stacked
(E * B) batch has the streams seed_e + b.

Each head's softmax subtracts its own row max. The JAX kernel subtracts
the max over its head group, which gives the same o and lse up to rounding
while both are finite, and underflows a head whose scores sit far below
another head of its group (tests/test_torch_ops.py pins this).

On a CUDA tensor the forward launches the kernel of
`rlt_tpu_torch/csrc/attention_packed_fwd.cu` and the backward that of
`csrc/attention_packed_bwd.cu` (dh = 16 or 64, one instance of each kernel
per width, float32, L <= 65535, both streaming 64-row tiles, their products
on the tensor cores in the 3xTF32 split that keeps float32 accuracy), and
at every other dh from 1 to MAX_HEAD_DIM and any pack those of
`csrc/attention_any_dh.cu` (`attention_packed_fwd_any`,
`attention_packed_bwd_any`: simple SIMT kernels, dh padded to a bucket);
each raises on anything else. On a CPU
tensor they run `attention_packed_plain` and `attention_packed_bwd_plain`.

bf16 (the serving lane): `attention_packed_fwd_bf16` (dh 16 and 64) and
`attention_fwd_bf16` (dh 128; every other dh up to MAX_HEAD_DIM on the
`_any_bf16` instances of `csrc/attention_any_dh.cu`) take bf16 q, k and v
and return bf16 o
beside f32 lse, with the JAX kernels' semantics on bf16 operands: the
products of bf16 values summed in f32, the softmax statistics in f32, the
weights rounded to bf16 before P V. On a CUDA tensor they launch the bf16
kernels of `csrc/attention_bf16_wgmma.cuh` (dh 64 and 128) and
`csrc/attention_bf16_dh16.cuh` (dh 16), through `attention_packed_fwd.cu`
and `attention_fwd.cu`, which stream the keys and so round the weights
against the running max before the final division (the plain versions
round the normalised weights, as the JAX kernels do; the difference is
rounding noise, emulated in tests/test_torch_bf16.py); on a CPU tensor
they run `attention_packed_plain` and `attention_plain`, which compute
either dtype's semantics. The float32 wrappers raise on bf16 and the bf16
ones on anything else; `AttentionPacked` and `Attention` pick one by q's
dtype, in the forward and in the backward.

bf16 (the training lane): `attention_packed_bwd_bf16` (dh 16 and 64) and
`attention_bwd_bf16` (dh 128; every other dh on the `_any_bf16`
instances) take bf16 q, k, v, o and do beside f32 lse
and return bf16 dq, dk and dv, with the JAX kernels' semantics on bf16
operands: s, p = exp(s scale - lse), dP = do v^T and delta = rowsum(do o)
in f32, ds = p (dp - delta) scale and the dropped weights pd rounded to
bf16 before the products dq = ds k, dk = ds^T q and dv = pd^T do, which sum
in f32 and are stored in bf16. On a CUDA tensor they launch the bf16
kernels of `csrc/attention_bf16_bwd_wgmma.cuh` (dh 64 and 128) and
`csrc/attention_bf16_dh16.cuh` (dh 16), through `attention_packed_bwd.cu`
and `attention_bwd.cu`, which round what the JAX kernels round; on a CPU tensor `attention_packed_bwd_plain` and
`attention_bwd_plain`, which compute either dtype's semantics.

A rate per row (population training, whose members differ in their
dropout rate and share one launch; the JAX package's traced
`hp["dropout_rate"]`): every op and plain version takes as `dropout_rate`
a float, or a `RowDropout` (`row_dropout`: the (N,) tensors of row n's
rate, keep threshold and scale, computed on the host). Row n then gives what a call at its own rate gives, bit for bit, and a
row at rate 0 the undropped row (`csrc/keep_mask.cuh` has the encoding:
threshold 0 keeps every weight, scale 1).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from rlt_tpu_torch.ops.build import (
    Kernel,
    ptr,
    refuse_bf16,
    require_bf16,
    stream_handle,
    widen,
)

# every launcher's pointers (the forwards' 8: q, k, v, o, lse, streams,
# thresholds, scales; the backwards' 13: q, k, v, o, do, lse, streams,
# thresholds, scales, dq, dk, dv, delta), its int arguments (per slice: n,
# length; packed: n, length, heads, head_dim, pack), then rate, threshold
# and the CUDA stream
_FWD, _BWD, _SLICE, _PACKED = 8, 13, 2, 5


def _args(pointers: int, ints: int) -> list:
    return ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
            + [ctypes.c_float, ctypes.c_uint, ctypes.c_void_p])


ATTENTION_FWD = Kernel("rlt_attention_fwd", _args(_FWD, _SLICE))
ATTENTION_FWD_BF16 = Kernel("rlt_attention_fwd_bf16", _args(_FWD, _SLICE))
ATTENTION_BWD = Kernel("rlt_attention_bwd", _args(_BWD, _SLICE))
ATTENTION_BWD_BF16 = Kernel("rlt_attention_bwd_bf16", _args(_BWD, _SLICE))
ATTENTION_PACKED_FWD = Kernel("rlt_attention_packed_fwd", _args(_FWD, _PACKED))
ATTENTION_PACKED_FWD_BF16 = Kernel("rlt_attention_packed_fwd_bf16", _args(_FWD, _PACKED))
ATTENTION_PACKED_BWD = Kernel("rlt_attention_packed_bwd", _args(_BWD, _PACKED))
ATTENTION_PACKED_BWD_BF16 = Kernel("rlt_attention_packed_bwd_bf16", _args(_BWD, _PACKED))
# every other head width (csrc/attention_any_dh.cu): one launcher each way and
# dtype, in the packed form, which the per-slice wrappers call at heads =
# pack = 1; each wrapper's instance counts its own launches
ATTENTION_FWD_ANY = Kernel("rlt_attention_any_fwd", _args(_FWD, _PACKED))
ATTENTION_FWD_ANY_BF16 = Kernel("rlt_attention_any_fwd_bf16", _args(_FWD, _PACKED))
ATTENTION_BWD_ANY = Kernel("rlt_attention_any_bwd", _args(_BWD, _PACKED))
ATTENTION_BWD_ANY_BF16 = Kernel("rlt_attention_any_bwd_bf16", _args(_BWD, _PACKED))
ATTENTION_PACKED_FWD_ANY = Kernel("rlt_attention_any_fwd", _args(_FWD, _PACKED))
ATTENTION_PACKED_FWD_ANY_BF16 = Kernel("rlt_attention_any_fwd_bf16", _args(_FWD, _PACKED))
ATTENTION_PACKED_BWD_ANY = Kernel("rlt_attention_any_bwd", _args(_BWD, _PACKED))
ATTENTION_PACKED_BWD_ANY_BF16 = Kernel("rlt_attention_any_bwd_bf16", _args(_BWD, _PACKED))

PACKED_HEAD_DIMS = (16, 64)  # the packed kernels' width-specialised instances
SLICE_HEAD_DIM = 128  # the per-slice kernels' width-specialised instance
MAX_HEAD_DIM = 512  # attention_any_dh.cu's widest bucket
_U32 = 0xFFFFFFFF


def packed_group_size(d: int, heads: int) -> int | None:
    """Heads per group `pack` with pack * dh == 128, or None when the shape
    admits none (as the JAX package's `packed_group_size`). On the card the
    group fixes the lse layout and the dropout mask's geometry; the kernels
    run each head on its own."""
    if d % heads:
        return None
    dh = d // heads
    if dh >= 128 or 128 % dh:
        return None
    pack = 128 // dh
    if heads % pack or d % (heads // pack):
        return None
    return pack


# ---------------------------------------------------------------------------
# Dropout mask (the JAX package's keep_mask, _streams, _group_stream)
# ---------------------------------------------------------------------------

def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> their int32 two's-complement wrap, kept in int64."""
    return ((x + 2**31) & _U32) - 2**31


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 values held in int64, without overflowing
    int64: c is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def keep_threshold(rate: float) -> int:
    """The uint32 keep threshold, in Python double as the JAX package."""
    return min(int((1.0 - rate) * 2**32), 2**32 - 1)


def check_rate(rate: float) -> None:
    """Raise unless 0 <= rate < 1 with a keep threshold above 0 (a rate
    within 2^-32 of 1 has none: it would drop every weight, and threshold 0
    encodes rate 0 in the per-row form)."""
    if not 0.0 <= rate < 1.0 or (rate > 0.0 and keep_threshold(rate) == 0):
        raise ValueError(f"dropout_rate must lie in [0, 1), short of 1 by more than "
                         f"2^-32, got {rate}")


class RowDropout(NamedTuple):
    """A dropout rate per row (or slice) of an attention launch, as the
    kernels read it (`csrc/keep_mask.cuh`): `rate` (float64), `threshold`
    (int32 holding the uint32 keep threshold, computed on the host in
    double as `keep_threshold`; 0 at rate 0, which keeps every weight) and
    `scale` (float32 1 / (1 - rate), as a launch at that rate computes it;
    1 at rate 0), each (N,) on the tensors' device."""

    rate: torch.Tensor
    threshold: torch.Tensor
    scale: torch.Tensor

    def repeat(self, n: int) -> "RowDropout":
        """Each row's values over n rows in turn: (N,) -> (N * n,)."""
        return RowDropout(*(t[:, None].expand(-1, n).reshape(-1) for t in self))


DropoutRate = Union[float, RowDropout]


def row_dropout(rates: Sequence[float], device=None) -> RowDropout:
    """The `RowDropout` of per-row rates, computed on the host."""
    rates = [float(r) for r in rates]
    for r in rates:
        check_rate(r)
    threshold = np.array([keep_threshold(r) if r > 0.0 else 0 for r in rates],
                         dtype=np.uint32).view(np.int32)
    rate32 = np.array(rates, dtype=np.float32)
    scale = np.float32(1.0) / (np.float32(1.0) - rate32)
    return RowDropout(torch.tensor(rates, dtype=torch.float64, device=device),
                      torch.from_numpy(threshold).to(device),
                      torch.from_numpy(scale).to(device))


def as_rate(rate: DropoutRate) -> float | RowDropout:
    """A float rate, or the `RowDropout` of per-row rates."""
    return rate if isinstance(rate, RowDropout) else float(rate)


def _drops(rate: float | RowDropout) -> bool:
    return isinstance(rate, RowDropout) or rate > 0.0


def _rows(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-row values shaped to broadcast over `like`'s trailing axes."""
    return values.reshape(values.shape + (1,) * (like.dim() - values.dim()))


def _kept_weights(p: torch.Tensor, keep: torch.Tensor, rate: float | RowDropout,
                  rows_of: int) -> torch.Tensor:
    """where(keep, p / (1 - rate), 0): per row, each row's 1 - rate rounded
    to f32, the divisor torch takes on the CPU for the float rate
    (`rows_of`: the leading axes that make a row)."""
    if isinstance(rate, RowDropout):
        keep_f = (1.0 - rate.rate).to(torch.float32).reshape(p.shape[:rows_of])
        return torch.where(keep, p / _rows(keep_f, p), 0.0)
    return torch.where(keep, p / (1.0 - rate), 0.0)


def _inverse_keep(rate: float | RowDropout, like: torch.Tensor, rows_of: int):
    """1 / (1 - rate) in double rounded to f32, per row or as a float."""
    if isinstance(rate, RowDropout):
        return _rows((1.0 / (1.0 - rate.rate)).to(torch.float32).reshape(
            like.shape[:rows_of]), like)
    return 1.0 / (1.0 - rate)


def keep_mask(stream, shape: tuple[int, int], rate: float | RowDropout) -> torch.Tensor:
    """Boolean keep mask of one (rows, cols) tile, bit for bit the JAX
    package's `keep_mask`. `stream` is an int or an integer tensor of any
    shape S; the result has shape S + `shape`. With a `RowDropout` of shape
    S each tile takes its own threshold, and threshold 0 keeps every
    element (the kernels' x <= threshold - 1 in uint32)."""
    stream = torch.as_tensor(stream, dtype=torch.int64)
    rows, cols = shape
    index = (torch.arange(rows, dtype=torch.int64, device=stream.device)[:, None] * cols
             + torch.arange(cols, dtype=torch.int64, device=stream.device))
    key = _mul_u32(stream & _U32, 0x9E3779B9)
    x = index ^ key[..., None, None]
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    if isinstance(rate, RowDropout):
        limit = ((rate.threshold.to(torch.int64) & _U32) - 1) & _U32
        return x <= limit.to(x.device)[..., None, None]
    return x < keep_threshold(rate)


def _streams(seed, n: int) -> torch.Tensor:
    """Per-row streams seed + row index, wrapped to int32 (int64 tensor)."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    return _wrap_int32(seed.reshape(()) + torch.arange(n, dtype=torch.int64,
                                                        device=seed.device))


def expert_streams(seeds: torch.Tensor, batch: int, start: int = 0) -> torch.Tensor:
    """Streams of a stacked (E * B) batch from one seed per expert: row
    e * B + b has seed_e + b, wrapped to int32, as the JAX package's
    per-expert `_streams` give under its `nn.vmap` over experts. `start`:
    the rows are rows start..start + B - 1 of a longer batch (a data rank's
    share of it), row b taking seed_e + start + b.

    The per-slice op takes `expert_streams(seeds, B * H)` for its stacked
    (E * B, H) slices: slice (e, b, h) is row e * B * H + b * H + h and gets
    seed_e + b * H + h, which is `_streams(seed_e, B * H)[b * H + h]`, the
    stream the JAX package's `_fwd_pallas` gives that slice in expert e."""
    seeds = seeds.to(torch.int64)
    b = torch.arange(start, start + batch, dtype=torch.int64, device=seeds.device)
    return _wrap_int32(seeds[:, None] + b).reshape(-1).to(torch.int32)


def _group_stream(stream, gi: int):
    """Stream of head group `gi`: group 0 keeps the row's stream; later
    groups add (gi * 0x7F4A7C15) & 0x7FFFFFFF with int32 wrap-around."""
    if gi == 0:
        return stream
    stream = torch.as_tensor(stream, dtype=torch.int64)
    return _wrap_int32(stream + ((gi * 0x7F4A7C15) & 0x7FFFFFFF))


def head_keep_mask(streams: torch.Tensor, heads: int, pack: int, length: int,
                   rate: float | RowDropout) -> torch.Tensor:
    """(N, H, L, L) keep mask of every head's scores, as the kernels
    evaluate it: head h reads columns (h % pack) * L + j of group h // pack
    (row n at its own rate with a `RowDropout`)."""
    streams = streams.to(torch.int64)
    n = streams.shape[0]
    masks = []
    for gi in range(heads // pack):
        tile = keep_mask(_group_stream(streams, gi), (length, pack * length), rate)
        masks.append(tile.reshape(n, length, pack, length).transpose(1, 2))
    return torch.cat(masks, dim=1)


def slice_keep_mask(streams: torch.Tensor, length: int,
                    rate: float | RowDropout) -> torch.Tensor:
    """(N, L, L) keep mask of every slice's scores, as K3' and K4' evaluate
    it: slice n's (L, L) tile on its own stream `streams[n]` (and at its own
    rate with a `RowDropout`)."""
    return keep_mask(streams.to(torch.int64), (length, length), rate)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dropout_rate: DropoutRate = 0.0, streams: torch.Tensor | None = None):
    """Explicit per-slice softmax attention: q, k, v (B, H, L, dh) -> (o
    (B, H, L, dh), lse (B * H, 1, L)). With a rate above 0 the softmax
    weights are dropped by `slice_keep_mask(streams, ...)` and the kept ones
    divided by 1 - rate (per slice b * H + h with per-row rates). bf16 q,
    k, v: the scores and the softmax in float32 from the widened values,
    the weights rounded to bf16 before P V, o rounded to bf16 and lse
    float32."""
    dropout_rate = as_rate(dropout_rate)
    batch, heads, length, dh = q.shape
    s = widen(q) @ widen(k).transpose(-1, -2) * (1.0 / math.sqrt(dh))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom
    if _drops(dropout_rate):
        keep = slice_keep_mask(streams, length, dropout_rate).reshape(p.shape)
        p = _kept_weights(p, keep, dropout_rate, 2)
    lse = (m + torch.log(denom)).reshape(batch * heads, 1, length)
    return (widen(p.to(v.dtype)) @ widen(v)).to(q.dtype), lse


def _rounded_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (and widened back) where `ref` is bf16: the JAX
    kernels' rounding of ds and pd before the gradient products."""
    return x.to(ref.dtype).float() if ref.dtype == torch.bfloat16 else x


def attention_bwd_plain(q, k, v, o, lse, do, dropout_rate: DropoutRate = 0.0,
                        streams: torch.Tensor | None = None):
    """The JAX package's per-slice backward: p from lse, delta =
    rowsum(do * o), ds = p (dp - delta) scale -> (dq, dk, dv), each
    (B, H, L, dh). bf16 q, k, v, o, do: every step in f32 from the widened
    values, ds and pd rounded to bf16 before the products, dq, dk and dv
    rounded to bf16."""
    dropout_rate = as_rate(dropout_rate)
    batch, heads, length, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf, of, dof = (widen(t) for t in (q, k, v, o, do))
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale
                  - lse.reshape(batch, heads, length, 1))
    dp = dof @ vf.transpose(-1, -2)
    pd = p
    if _drops(dropout_rate):
        keep = slice_keep_mask(streams, length, dropout_rate).reshape(p.shape)
        inv = _inverse_keep(dropout_rate, p, 2)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = _rounded_like(p * (dp - delta) * scale, q)
    pd = _rounded_like(pd, q)
    return ((ds @ kf).to(q.dtype), (ds.transpose(-1, -2) @ qf).to(q.dtype),
            (pd.transpose(-1, -2) @ dof).to(q.dtype))


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    n, length, d = t.shape
    return t.reshape(n, length, heads, d // heads).transpose(1, 2)  # (N, H, L, dh)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    n, heads, length, dh = t.shape
    return t.transpose(1, 2).reshape(n, length, heads * dh)


def attention_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, pack: int, dropout_rate: DropoutRate = 0.0,
                           streams: torch.Tensor | None = None):
    """Explicit per-head softmax attention: (o (N, L, D), lse (N, H / pack,
    L, pack)). With a rate above 0 the softmax weights are dropped by
    `head_keep_mask(streams, ...)` and the kept ones divided by 1 - rate
    (row n's own with per-row rates). bf16 q, k, v as in `attention_plain`."""
    dropout_rate = as_rate(dropout_rate)
    n, length, d = q.shape
    dh = d // heads
    groups = heads // pack
    s = (_split_heads(widen(q), heads) @ _split_heads(widen(k), heads).transpose(-1, -2)
         * (1.0 / math.sqrt(dh)))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom
    if _drops(dropout_rate):
        keep = head_keep_mask(streams, heads, pack, length, dropout_rate)
        p = _kept_weights(p, keep, dropout_rate, 1)
    o = _merge_heads(widen(p.to(v.dtype)) @ _split_heads(widen(v), heads)).to(q.dtype)
    lse = (m + torch.log(denom))[..., 0]  # (N, H, L)
    lse = lse.reshape(n, groups, pack, length).transpose(2, 3).contiguous()
    return o, lse


def attention_packed_bwd_plain(q, k, v, o, lse, do, heads: int, pack: int,
                               dropout_rate: DropoutRate = 0.0,
                               streams: torch.Tensor | None = None):
    """The JAX package's packed backward, per head: p from lse, delta =
    rowsum(do * o), ds = p (dp - delta) scale -> (dq, dk, dv), each (N, L, D).
    bf16 q, k, v, o, do as in `attention_bwd_plain`."""
    dropout_rate = as_rate(dropout_rate)
    n, length, d = q.shape
    scale = 1.0 / math.sqrt(d // heads)
    qh, kh, vh, oh, doh = (_split_heads(widen(t), heads) for t in (q, k, v, o, do))
    lse_h = lse.transpose(2, 3).reshape(n, heads, length)  # (N, H, L)
    p = torch.exp(qh @ kh.transpose(-1, -2) * scale - lse_h[..., None])
    dp = doh @ vh.transpose(-1, -2)
    pd = p
    if _drops(dropout_rate):
        keep = head_keep_mask(streams, heads, pack, length, dropout_rate)
        inv = _inverse_keep(dropout_rate, p, 1)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = _rounded_like(p * (dp - delta) * scale, q)
    pd = _rounded_like(pd, q)
    return tuple(_merge_heads(t).to(q.dtype) for t in (
        ds @ kh, ds.transpose(-1, -2) @ qh, pd.transpose(-1, -2) @ doh))


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _check(q, k, v, heads: int, pack: int, dropout_rate, streams) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be equal (N, L, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    d = q.shape[-1]
    if heads < 1 or d % heads:
        raise ValueError(f"feature dim {d} not divisible by heads={heads}")
    if pack < 1 or heads % pack:
        raise ValueError(f"heads={heads} not divisible by pack={pack}")
    _check_rate(dropout_rate, streams, q.shape[0], q.device)


def _check_rate(dropout_rate: float | RowDropout, streams, rows: int, device) -> None:
    """A float rate in [0, 1) (`check_rate`), or a `RowDropout` of `rows`
    rows on `device` (its rates were checked when it was made); streams
    where anything drops."""
    if isinstance(dropout_rate, RowDropout):
        for name, t in zip(RowDropout._fields, dropout_rate):
            if tuple(t.shape) != (rows,) or t.device != device:
                raise ValueError(f"per-row dropout {name} must be ({rows},) on "
                                 f"{device}, got {tuple(t.shape)} on {t.device}")
    else:
        check_rate(dropout_rate)
    if _drops(dropout_rate):
        if streams is None:
            raise ValueError("a dropout rate above 0 needs the per-row int32 "
                             "streams")
        if tuple(streams.shape) != (rows,) or streams.device != device:
            raise ValueError(f"streams must be ({rows},) on {device}, got "
                             f"{tuple(streams.shape)} on {streams.device}")


def _check_slices(q, k, v, dropout_rate, streams) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be equal (B, H, L, dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    _check_rate(dropout_rate, streams, q.shape[0] * q.shape[1], q.device)


def _check_kernel_inputs(name: str, dh: int, kernel_dhs: tuple, tensors: dict,
                         dtype: torch.dtype = torch.float32) -> None:
    if next(iter(tensors.values())).device.type != "cuda":
        raise ValueError(f"{name}: unsupported device "
                         f"{next(iter(tensors.values())).device}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        takes = " or ".join(f"dh = {w}" for w in kernel_dhs)
        raise ValueError(f"{name} kernels take 1 <= dh <= {MAX_HEAD_DIM} ({takes} on the "
                         f"width-specialised instance, any other on `{name}_any`), got "
                         f"dh = {dh}")
    for tname, t in tensors.items():
        if t.dtype != dtype and tname != "lse":
            raise TypeError(f"{name} kernel takes {dtype} {tname}, got {t.dtype}")
        if tname == "lse" and t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32 lse, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes a contiguous, 16-byte "
                             f"aligned {tname}")


def _kernel_dropout(streams, dropout_rate: float | RowDropout):
    """The launchers' dropout arguments (streams, thresholds, scales, rate,
    threshold) and the tensors they point into, kept alive by the caller:
    the int32 streams where anything drops; per-row thresholds and scales
    with a `RowDropout`, whose launch reads no rate."""
    null = ctypes.c_void_p(None)
    if not _drops(dropout_rate):
        return (null, null, null, 0.0, keep_threshold(0.0)), ()
    s = streams.to(torch.int32).contiguous()
    if isinstance(dropout_rate, RowDropout):
        t = dropout_rate.threshold.contiguous()
        c = dropout_rate.scale.contiguous()
        return (ptr(s), ptr(t), ptr(c), 0.0, 0), (s, t, c)
    return (ptr(s), null, null, dropout_rate, keep_threshold(dropout_rate)), (s,)


def attention_packed_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int, pack: int, dropout_rate: DropoutRate = 0.0,
                         streams: torch.Tensor | None = None):
    """K5' on a CUDA tensor, `attention_packed_plain` on a CPU tensor:
    (o (N, L, D), lse (N, H / pack, L, pack) float32). bf16 goes to
    `attention_packed_fwd_bf16`."""
    dropout_rate = as_rate(dropout_rate)
    _check(q, k, v, heads, pack, dropout_rate, streams)
    refuse_bf16("attention_packed_fwd", {"q": q, "k": k, "v": v})
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, heads, pack, dropout_rate, streams)
    _check_kernel_inputs("attention_packed_fwd", q.shape[-1] // heads, PACKED_HEAD_DIMS,
                         {"q": q, "k": k, "v": v})
    n, length, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(n, heads // pack, length, pack, device=q.device,
                      dtype=torch.float32)
    (s_ptr, t_ptr, c_ptr, rate, threshold), _keep = _kernel_dropout(streams, dropout_rate)
    kernel = (ATTENTION_PACKED_FWD if d // heads in PACKED_HEAD_DIMS
              else ATTENTION_PACKED_FWD_ANY)
    with torch.cuda.device(q.device):
        kernel(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), s_ptr, t_ptr, c_ptr, n, length,
               heads, d // heads, pack, rate, threshold, stream_handle(q.device))
    return o, lse


def attention_packed_fwd_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              heads: int, pack: int, dropout_rate: DropoutRate = 0.0,
                              streams: torch.Tensor | None = None):
    """K5''s bf16 instance on a CUDA tensor, `attention_packed_plain` on a
    CPU tensor: bf16 q, k, v -> (o (N, L, D) bf16, lse (N, H / pack, L,
    pack) float32). Raises on any other dtype."""
    dropout_rate = as_rate(dropout_rate)
    _check(q, k, v, heads, pack, dropout_rate, streams)
    require_bf16("attention_packed_fwd_bf16", {"q": q, "k": k, "v": v})
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, heads, pack, dropout_rate, streams)
    _check_kernel_inputs("attention_packed_fwd_bf16", q.shape[-1] // heads,
                         PACKED_HEAD_DIMS, {"q": q, "k": k, "v": v}, torch.bfloat16)
    n, length, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(n, heads // pack, length, pack, device=q.device,
                      dtype=torch.float32)
    (s_ptr, t_ptr, c_ptr, rate, threshold), _keep = _kernel_dropout(streams, dropout_rate)
    kernel = (ATTENTION_PACKED_FWD_BF16 if d // heads in PACKED_HEAD_DIMS
              else ATTENTION_PACKED_FWD_ANY_BF16)
    with torch.cuda.device(q.device):
        kernel(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), s_ptr, t_ptr, c_ptr, n, length,
               heads, d // heads, pack, rate, threshold, stream_handle(q.device))
    return o, lse


def _packed_bwd(name: str, kernels: tuple, dtype: torch.dtype, q, k, v, o, lse, do,
                heads: int, pack: int, dropout_rate: float | RowDropout, streams):
    """K6' or its bf16 instance: checks, outputs and the launch of
    `kernels`' first (the width-specialised instance) at dh in
    PACKED_HEAD_DIMS, else of its second."""
    _check_kernel_inputs(name, q.shape[-1] // heads, PACKED_HEAD_DIMS,
                         {"q": q, "k": k, "v": v, "o": o, "do": do, "lse": lse}, dtype)
    n, length, d = q.shape
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError("o and do must have q's shape")
    if tuple(lse.shape) != (n, heads // pack, length, pack):
        raise ValueError(f"lse must be {(n, heads // pack, length, pack)}, got "
                         f"{tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(n, heads, length, device=q.device, dtype=torch.float32)
    (s_ptr, t_ptr, c_ptr, rate, threshold), _keep = _kernel_dropout(streams, dropout_rate)
    kernel = kernels[0] if d // heads in PACKED_HEAD_DIMS else kernels[1]
    with torch.cuda.device(q.device):
        kernel(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), s_ptr, t_ptr, c_ptr,
               ptr(dq), ptr(dk), ptr(dv), ptr(delta), n, length, heads, d // heads, pack,
               rate, threshold, stream_handle(q.device))
    return dq, dk, dv


def attention_packed_bwd(q, k, v, o, lse, do, heads: int, pack: int,
                         dropout_rate: DropoutRate = 0.0,
                         streams: torch.Tensor | None = None):
    """K6' on a CUDA tensor, `attention_packed_bwd_plain` on a CPU tensor:
    (dq, dk, dv), each (N, L, D). bf16 goes to `attention_packed_bwd_bf16`."""
    dropout_rate = as_rate(dropout_rate)
    _check(q, k, v, heads, pack, dropout_rate, streams)
    refuse_bf16("attention_packed_bwd", {"q": q, "k": k, "v": v, "do": do})
    if q.device.type == "cpu":
        return attention_packed_bwd_plain(q, k, v, o, lse, do, heads, pack,
                                          dropout_rate, streams)
    return _packed_bwd("attention_packed_bwd",
                       (ATTENTION_PACKED_BWD, ATTENTION_PACKED_BWD_ANY), torch.float32,
                       q, k, v, o, lse, do, heads, pack, dropout_rate, streams)


def attention_packed_bwd_bf16(q, k, v, o, lse, do, heads: int, pack: int,
                              dropout_rate: DropoutRate = 0.0,
                              streams: torch.Tensor | None = None):
    """K6''s bf16 instance on a CUDA tensor, `attention_packed_bwd_plain` on
    a CPU tensor: bf16 q, k, v, o, do and float32 lse -> (dq, dk, dv), each
    (N, L, D) bf16. Raises on any other dtype."""
    dropout_rate = as_rate(dropout_rate)
    _check(q, k, v, heads, pack, dropout_rate, streams)
    require_bf16("attention_packed_bwd_bf16", {"q": q, "k": k, "v": v, "o": o, "do": do})
    if q.device.type == "cpu":
        return attention_packed_bwd_plain(q, k, v, o, lse, do, heads, pack,
                                          dropout_rate, streams)
    return _packed_bwd("attention_packed_bwd_bf16",
                       (ATTENTION_PACKED_BWD_BF16, ATTENTION_PACKED_BWD_ANY_BF16),
                       torch.bfloat16, q, k, v, o, lse, do, heads, pack, dropout_rate,
                       streams)


def _op_dropout(dropout_rate: float | RowDropout, streams) -> tuple:
    """The forward ops' dropout arguments (`ops/library.py`): rate, streams,
    and a `RowDropout`'s row_rate, row_threshold and row_scale, or None."""
    if isinstance(dropout_rate, RowDropout):
        return (0.0, streams, *dropout_rate)
    return (float(dropout_rate), streams, None, None, None)


class AttentionPacked(torch.autograd.Function):
    """Forward K5' (the op `rlt::attention_packed_fwd`, or its `_bf16` twin
    for bf16 q, which call `attention_packed_fwd` and
    `attention_packed_fwd_bf16`; `ops/library.py`), backward K6'
    (`attention_packed_bwd`, or `attention_packed_bwd_bf16`); lse is
    returned but takes no gradient. The wrappers are looked up as module
    attributes at each call."""

    @staticmethod
    def forward(ctx, q, k, v, heads, pack, dropout_rate, streams):
        fwd = (torch.ops.rlt.attention_packed_fwd_bf16 if q.dtype == torch.bfloat16
               else torch.ops.rlt.attention_packed_fwd)
        o, lse = fwd(q, k, v, heads, pack, *_op_dropout(dropout_rate, streams))
        ctx.save_for_backward(q, k, v, o, lse, streams)
        ctx.args = (heads, pack, dropout_rate)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, streams = ctx.saved_tensors
        heads, pack, rate = ctx.args
        bwd = (attention_packed_bwd_bf16 if q.dtype == torch.bfloat16
               else attention_packed_bwd)
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), heads, pack, rate, streams)
        return dq, dk, dv, None, None, None, None


def fused_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, pack: int | None = None,
                           dropout_rate: DropoutRate = 0.0,
                           streams: torch.Tensor | None = None):
    """Head-packed attention, differentiable: q, k, v (N, L, D) -> (o (N, L,
    D), lse (N, H / pack, L, pack) float32). `pack` defaults to all heads in
    one group, as in the JAX package. A dropout rate above 0 needs `streams`,
    one int32 dropout stream per row n; a rate per row is a `RowDropout`."""
    if pack is None:
        pack = heads
    return AttentionPacked.apply(q, k, v, heads, pack, as_rate(dropout_rate), streams)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dropout_rate: DropoutRate = 0.0, streams: torch.Tensor | None = None):
    """K3' on a CUDA tensor, `attention_plain` on a CPU tensor: (o (B, H, L,
    dh), lse (B * H, 1, L) float32). bf16 goes to `attention_fwd_bf16`."""
    dropout_rate = as_rate(dropout_rate)
    _check_slices(q, k, v, dropout_rate, streams)
    refuse_bf16("attention_fwd", {"q": q, "k": k, "v": v})
    if q.device.type == "cpu":
        return attention_plain(q, k, v, dropout_rate, streams)
    _check_kernel_inputs("attention_fwd", q.shape[-1], (SLICE_HEAD_DIM,),
                         {"q": q, "k": k, "v": v})
    return _slice_fwd(ATTENTION_FWD, ATTENTION_FWD_ANY, q, k, v, dropout_rate, streams)


def _slice_fwd(kernel: Kernel, any_kernel: Kernel, q, k, v,
               dropout_rate: float | RowDropout, streams):
    """K3' or its bf16 instance: outputs and the launch of `kernel` at dh =
    SLICE_HEAD_DIM, else of `any_kernel` at one head in a group of one."""
    batch, heads, length, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(batch * heads, 1, length, device=q.device, dtype=torch.float32)
    (s_ptr, t_ptr, c_ptr, rate, threshold), _keep = _kernel_dropout(streams, dropout_rate)
    with torch.cuda.device(q.device):
        if dh == SLICE_HEAD_DIM:
            kernel(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), s_ptr, t_ptr, c_ptr,
                   batch * heads, length, rate, threshold, stream_handle(q.device))
        else:
            any_kernel(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), s_ptr, t_ptr, c_ptr,
                       batch * heads, length, 1, dh, 1, rate, threshold,
                       stream_handle(q.device))
    return o, lse


def attention_fwd_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dropout_rate: DropoutRate = 0.0,
                       streams: torch.Tensor | None = None):
    """K3''s bf16 instance on a CUDA tensor, `attention_plain` on a CPU
    tensor: bf16 q, k, v (B, H, L, dh) -> (o (B, H, L, dh) bf16, lse
    (B * H, 1, L) float32). Raises on any other dtype."""
    dropout_rate = as_rate(dropout_rate)
    _check_slices(q, k, v, dropout_rate, streams)
    require_bf16("attention_fwd_bf16", {"q": q, "k": k, "v": v})
    if q.device.type == "cpu":
        return attention_plain(q, k, v, dropout_rate, streams)
    _check_kernel_inputs("attention_fwd_bf16", q.shape[-1], (SLICE_HEAD_DIM,),
                         {"q": q, "k": k, "v": v}, torch.bfloat16)
    return _slice_fwd(ATTENTION_FWD_BF16, ATTENTION_FWD_ANY_BF16, q, k, v, dropout_rate,
                      streams)


def _slice_bwd(name: str, kernels: tuple, dtype: torch.dtype, q, k, v, o, lse, do,
               dropout_rate: float | RowDropout, streams):
    """K4' or its bf16 instance: checks, outputs and the launch of
    `kernels`' first at dh = SLICE_HEAD_DIM, else of its second at one head
    in a group of one."""
    _check_kernel_inputs(name, q.shape[-1], (SLICE_HEAD_DIM,),
                         {"q": q, "k": k, "v": v, "o": o, "do": do, "lse": lse}, dtype)
    batch, heads, length, dh = q.shape
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError("o and do must have q's shape")
    if tuple(lse.shape) != (batch * heads, 1, length):
        raise ValueError(f"lse must be {(batch * heads, 1, length)}, got "
                         f"{tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(batch * heads, length, device=q.device, dtype=torch.float32)
    (s_ptr, t_ptr, c_ptr, rate, threshold), _keep = _kernel_dropout(streams, dropout_rate)
    pointers = (ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), s_ptr, t_ptr, c_ptr,
                ptr(dq), ptr(dk), ptr(dv), ptr(delta), batch * heads, length)
    with torch.cuda.device(q.device):
        if dh == SLICE_HEAD_DIM:
            kernels[0](*pointers, rate, threshold, stream_handle(q.device))
        else:
            kernels[1](*pointers, 1, dh, 1, rate, threshold, stream_handle(q.device))
    return dq, dk, dv


def attention_bwd(q, k, v, o, lse, do, dropout_rate: DropoutRate = 0.0,
                  streams: torch.Tensor | None = None):
    """K4' on a CUDA tensor, `attention_bwd_plain` on a CPU tensor: (dq, dk,
    dv), each (B, H, L, dh). bf16 goes to `attention_bwd_bf16`."""
    dropout_rate = as_rate(dropout_rate)
    _check_slices(q, k, v, dropout_rate, streams)
    refuse_bf16("attention_bwd", {"q": q, "k": k, "v": v, "do": do})
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, dropout_rate, streams)
    return _slice_bwd("attention_bwd", (ATTENTION_BWD, ATTENTION_BWD_ANY), torch.float32,
                      q, k, v, o, lse, do, dropout_rate, streams)


def attention_bwd_bf16(q, k, v, o, lse, do, dropout_rate: DropoutRate = 0.0,
                       streams: torch.Tensor | None = None):
    """K4''s bf16 instance on a CUDA tensor, `attention_bwd_plain` on a CPU
    tensor: bf16 q, k, v, o, do and float32 lse -> (dq, dk, dv), each
    (B, H, L, dh) bf16. Raises on any other dtype."""
    dropout_rate = as_rate(dropout_rate)
    _check_slices(q, k, v, dropout_rate, streams)
    require_bf16("attention_bwd_bf16", {"q": q, "k": k, "v": v, "o": o, "do": do})
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, dropout_rate, streams)
    return _slice_bwd("attention_bwd_bf16", (ATTENTION_BWD_BF16, ATTENTION_BWD_ANY_BF16),
                      torch.bfloat16, q, k, v, o, lse, do, dropout_rate, streams)


class Attention(torch.autograd.Function):
    """Forward K3' (the op `rlt::attention_fwd`, or `rlt::attention_fwd_bf16`
    for bf16 q, which call `attention_fwd` and `attention_fwd_bf16`;
    `ops/library.py`), backward K4' (`attention_bwd`, or
    `attention_bwd_bf16`); lse is returned but takes no gradient. The
    wrappers are looked up as module attributes at each call."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_rate, streams):
        fwd = (torch.ops.rlt.attention_fwd_bf16 if q.dtype == torch.bfloat16
               else torch.ops.rlt.attention_fwd)
        o, lse = fwd(q, k, v, *_op_dropout(dropout_rate, streams))
        ctx.save_for_backward(q, k, v, o, lse, streams)
        ctx.rate = dropout_rate
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, streams = ctx.saved_tensors
        bwd = attention_bwd_bf16 if q.dtype == torch.bfloat16 else attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), ctx.rate, streams)
        return dq, dk, dv, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dropout_rate: DropoutRate = 0.0, streams: torch.Tensor | None = None):
    """Per-slice attention, differentiable: q, k, v (B, H, L, dh) -> (o (B,
    H, L, dh), lse (B * H, 1, L) float32). A dropout rate above 0 needs
    `streams`, one int32 dropout stream per slice b * H + h; a rate per
    slice is a `RowDropout`."""
    return Attention.apply(q, k, v, as_rate(dropout_rate), streams)
