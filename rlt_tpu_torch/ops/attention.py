"""Head-packed attention forward: CUDA kernel K5' and its plain version.

The counterpart of the JAX package's `ops/attention.py::fused_attention_packed`
forward. q, k, v are (N, L, D) with the H heads contiguous in the feature
dim (D = H * dh): the raw output of torch's head-major in_proj, so no head
split happens around the kernel. Each head computes
softmax(q_h k_h^T / sqrt(dh)) v_h; the log-sum-exp of every score row is
returned beside o in the JAX layout (N, H / pack, L, pack), so that the
training slice's backward can consume it.

Each head's softmax subtracts its own row max. The JAX kernel subtracts
the max over its head group, which gives the same o and lse up to rounding
while both are finite, and underflows a head whose scores sit far below
another head of its group (tests/test_torch_ops.py pins this).

On a CUDA tensor the wrapper launches the kernel of
`rlt_tpu_torch/csrc/attention_packed_fwd.cu` (dh = 64, float32, L <= 333
on an H100, no dropout) and raises on anything else. On a CPU tensor it
runs `attention_packed_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rlt_tpu_torch.ops.build import Kernel, ptr, stream_handle

ATTENTION_PACKED_FWD = Kernel(
    "rlt_attention_packed_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

KERNEL_HEAD_DIM = 64


def packed_group_size(d: int, heads: int) -> int | None:
    """Heads per group `pack` with pack * dh == 128, or None when the shape
    admits none (as the JAX package's `packed_group_size`). On the card the
    group only fixes the lse layout; the kernel runs each head on its own."""
    if d % heads:
        return None
    dh = d // heads
    if dh >= 128 or 128 % dh:
        return None
    pack = 128 // dh
    if heads % pack or d % (heads // pack):
        return None
    return pack


def attention_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, pack: int):
    """Explicit per-head softmax attention: (o (N, L, D), lse (N, H / pack,
    L, pack))."""
    n, length, d = q.shape
    dh = d // heads
    groups = heads // pack

    def split(t):
        return t.reshape(n, length, heads, dh).transpose(1, 2)  # (N, H, L, dh)

    s = split(q) @ split(k).transpose(-1, -2) * (1.0 / math.sqrt(dh))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    o = (e / denom) @ split(v)
    lse = (m + torch.log(denom))[..., 0]  # (N, H, L)
    o = o.transpose(1, 2).reshape(n, length, d)
    lse = lse.reshape(n, groups, pack, length).transpose(2, 3).contiguous()
    return o, lse


def _check(q, k, v, heads: int, pack: int) -> None:
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


def fused_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, pack: int | None = None,
                           dropout_rate: float = 0.0):
    """Head-packed attention forward: q, k, v (N, L, D) -> (o (N, L, D),
    lse (N, H / pack, L, pack) float32). `pack` defaults to all heads in one
    group, as in the JAX package. Dropout is not ported yet: a rate above 0
    raises."""
    if pack is None:
        pack = heads
    _check(q, k, v, heads, pack)
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "fused_attention_packed: in-kernel dropout is not ported yet "
            "(ROADMAP.md, training slice)")
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, heads, pack)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_packed: unsupported device {q.device}")
    n, length, d = q.shape
    if d // heads != KERNEL_HEAD_DIM:
        raise ValueError(f"attention_packed_fwd kernel takes dh = "
                         f"{KERNEL_HEAD_DIM}, got dh = {d // heads}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"attention_packed_fwd kernel takes float32 {name}, "
                            f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"attention_packed_fwd kernel takes a contiguous, "
                             f"16-byte aligned {name}")
    o = torch.empty_like(q)
    lse = torch.empty(n, heads // pack, length, pack, device=q.device,
                      dtype=torch.float32)
    with torch.cuda.device(q.device):
        ATTENTION_PACKED_FWD(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), n,
                             length, heads, pack, stream_handle(q.device))
    return o, lse
