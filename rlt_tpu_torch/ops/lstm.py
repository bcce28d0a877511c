"""LSTM recurrence: CUDA kernels K1' (forward) and K2' (backward) and their
plain PyTorch versions.

The counterpart of the JAX package's `ops/lstm.py::fused_lstm`,
`fused_lstm_bidir` and their custom_vjp, in the layout of its kernels
(`_fwd_pallas` / `_bwd_pallas`): `ndir` directions (1, 2 for both
directions of a BiLSTM layer, or 2K for the BiLSTM layers of K population
members, which the JAX package reaches by `jax.vmap` over
`fused_lstm_bidir`) folded into the batch axis, xw (L, ndir * B,
4H) with rows d * B .. d * B + B - 1 of each step for direction d, and
W_hh^T (ndir * H, 4H) with rows d * H .. d * H + H - 1 for direction d;
the outputs follow the same layout. The TPU kernels' padding of B to 8 is
not carried over. The input projection for all time steps is hoisted out
of the recurrence by the caller (`models/layers.py`); what remains per step
and direction is gates = xw_t + h W_hh^T in torch gate order i, f, g, o,
then c = f c + i g and h = o tanh(c), from a zero state. The backward walks
time in reverse from the saved hs and cs, recomputing the gates, and
returns the gradients of xw and of W_hh^T.

On a CUDA tensor `lstm_fwd` and `lstm_bwd` launch the kernels of
`rlt_tpu_torch/csrc/lstm_fwd.cu` and `csrc/lstm_bwd.cu` at H in
KERNEL_HIDDEN (64, 96 and 128: W_hh^T held on chip), and at every H below
128 after padding it with zeros to the next of those widths
(`kernel_hidden`, `at_kernel_width_fwd`: exact, a padded unit stays 0);
every H from 129 to MAX_HIDDEN launches those of `csrc/lstm_any.cu` (the
instances `lstm_fwd_any`, `lstm_bwd_any`, counted apart: W_hh^T streamed
from L2 every step). Each takes any ndir up to MAX_DIRECTIONS and raises
on anything it does not take. On a CPU tensor they run
`lstm_recurrence_plain` and `lstm_bwd_plain`, explicit time loops.

bf16 (the serving lane): `lstm_fwd_bf16` takes bf16 xw and W_hh^T and
returns bf16 hs beside f32 cs, as the JAX kernel does on bf16 operands: the
carried h and c are f32, gates = xw + h W_hh^T is taken in f32 from the
widened bf16 values, and only the stored hs is rounded. On a CUDA tensor it
launches K1''s bf16 instance (`csrc/lstm_bf16_mma.cuh`: the tensor cores,
h_{t-1} in three exact bf16 parts) at H up to 128 (padded as above) and
`lstm_fwd_any_bf16` (`csrc/lstm_any.cu`) at H from 129 to MAX_HIDDEN, on a
CPU tensor `lstm_recurrence_plain`,
which computes either dtype's semantics. `lstm_fwd` raises on bf16 and
`lstm_fwd_bf16` on anything else; `LSTMRecurrence` picks one by xw's dtype.

bf16 (the training lane): `lstm_bwd_bf16` takes bf16 xw, W_hh^T, hs and
dho beside f32 cs, as the JAX kernel does on bf16 operands: the gates are
recomputed from the rounded bf16 hs[t-1] and the widened weights, the
carries dh and dc are f32, dgates is f32 and feeds the dh carry and the
dW_hh^T sum unrounded, only the stored dxw is rounded to bf16, and dW_hh^T
is f32. On a CUDA tensor it launches K2''s bf16 instance (at H up to 128,
padded as above; `lstm_bwd_any_bf16` at H from 129 to MAX_HIDDEN), on a
CPU tensor `lstm_bwd_plain`, which computes either dtype's semantics.
`LSTMRecurrence` takes W_hh^T in f32 or bf16 beside bf16 xw: it rounds an
f32 W_hh^T for the kernels itself and returns dW_hh^T in f32, so the f32
master weight of a bf16 training step receives K2''s f32 sum unrounded,
as the JAX package's custom_vjp hands it to its f32 master.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rlt_tpu_torch.ops.build import (
    Kernel,
    ptr,
    refuse_bf16,
    require_bf16,
    stream_handle,
    widen,
)

LSTM_FWD = Kernel("rlt_lstm_fwd", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
LSTM_FWD_BF16 = Kernel("rlt_lstm_fwd_bf16", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
LSTM_BWD = Kernel("rlt_lstm_bwd", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])
LSTM_BWD_BF16 = Kernel("rlt_lstm_bwd_bf16", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
# the instances of every other hidden width (csrc/lstm_any.cu)
LSTM_FWD_ANY = Kernel("rlt_lstm_any_fwd", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
LSTM_FWD_ANY_BF16 = Kernel("rlt_lstm_any_fwd_bf16", [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
LSTM_BWD_ANY = Kernel("rlt_lstm_any_bwd", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
LSTM_BWD_ANY_BF16 = Kernel("rlt_lstm_any_bwd_bf16", [ctypes.c_void_p] * 10
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# the hidden widths of the width-specialised instances (lstm_fwd.cu,
# lstm_bwd.cu, lstm_bf16_mma.cuh), which every H below their widest takes
# padded; lstm_any.cu takes every H above it up to MAX_HIDDEN, where its
# reverse chain's carries and dgates still fit in a block's shared memory
KERNEL_HIDDEN = (64, 96, 128)
MAX_HIDDEN = 2048
# most chunks the dW_hh^T contraction is split into (K2' sums their partial
# products in a second pass, in a fixed order)
DW_SPLITS = 32
# most directions a kernel launch takes: K2''s dW_hh^T pass puts ndir *
# splits blocks on the grid's z axis, at most 65535
MAX_DIRECTIONS = 65535 // DW_SPLITS


def dw_splits(length: int, batch: int) -> int:
    """Chunks of K2''s dW_hh^T contraction over the (L - 1) B rows of one
    direction: about 512 rows each, at most DW_SPLITS."""
    return max(1, min(DW_SPLITS, (length - 1) * batch // 512))


def dw_boxes(batch: int) -> tuple[int, int, int]:
    """The 64-row boxes of K2' bf16's products (`csrc/lstm_bf16_mma.cuh`'s
    `boxes_of`): (rows, steps, boxes a step): min(B, 64) rows b of each of
    64 // B steps at B <= 64, else one step in ceil(B / 64) boxes."""
    return (batch, 64 // batch, 1) if batch <= 64 else (64, 1, -(-batch // 64))


def dw_splits_bf16(length: int, batch: int) -> int:
    """Chunks of K2' bf16's dW_hh^T contraction over the boxes of steps 1 ..
    L - 1 (`dw_boxes`): about 8 boxes each, at most DW_SPLITS."""
    _, steps, per_step = dw_boxes(batch)
    boxes = -(-(length - 1) // steps) * per_step
    return max(1, min(DW_SPLITS, -(-boxes // 8)))


def _per_dir(op, a: torch.Tensor, b: torch.Tensor, ndir: int) -> torch.Tensor:
    """op(a_d, b_d) over each direction's slice of a and of b along their
    first axes, concatenated: the JAX package's `_dir_dot`."""
    if ndir == 1:
        return op(a, b)
    m, k = a.shape[0] // ndir, b.shape[0] // ndir
    return torch.cat([op(a[d * m:(d + 1) * m], b[d * k:(d + 1) * k])
                      for d in range(ndir)])


def lstm_recurrence_plain(xw: torch.Tensor, w_hh_t: torch.Tensor, ndir: int = 1):
    """(L, ndir * B, 4H) gate inputs, (ndir * H, 4H) W_hh^T -> hs, cs, each
    (L, ndir * B, H). On bf16 inputs h and c are carried in float32 from
    the widened xw and W_hh^T, hs is rounded to bf16 as it is stored and cs
    stays float32 (the JAX kernel's f32 scratch and output types)."""
    length, rows, gates4 = xw.shape
    hidden = gates4 // 4
    state = torch.float32 if xw.dtype == torch.bfloat16 else xw.dtype
    h = torch.zeros(rows, hidden, dtype=state, device=xw.device)
    c = torch.zeros(rows, hidden, dtype=state, device=xw.device)
    w = widen(w_hh_t)
    hs, cs = [], []
    for t in range(length):
        gates = widen(xw[t]) + _per_dir(torch.matmul, h, w, ndir)
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs).to(xw.dtype), torch.stack(cs)


def lstm_bwd_plain(xw: torch.Tensor, w_hh_t: torch.Tensor, hs: torch.Tensor,
                   cs: torch.Tensor, dho: torch.Tensor, ndir: int = 1):
    """The JAX package's reverse-time LSTM backward as an explicit loop:
    (L, ndir * B, 4H) xw, (ndir * H, 4H) W_hh^T, hs, cs and dho
    (L, ndir * B, H) -> dxw (L, ndir * B, 4H), dW_hh^T (ndir * H, 4H). On
    bf16 xw, W_hh^T, hs and dho (cs f32): everything in f32 from the widened
    values, dxw rounded to bf16 as it is stored, dW_hh^T f32."""
    length, rows, gates4 = xw.shape
    hidden = gates4 // 4
    state = torch.float32 if xw.dtype == torch.bfloat16 else xw.dtype
    w, xs, hs, dho = widen(w_hh_t), widen(xw), widen(hs), widen(dho)
    zeros = torch.zeros(rows, hidden, dtype=state, device=xw.device)
    dh_carry, dc_carry = zeros, zeros
    dw = torch.zeros_like(w)
    dxw = torch.empty(xw.shape, dtype=state, device=xw.device)
    for t in range(length - 1, -1, -1):
        h_prev = hs[t - 1] if t > 0 else zeros
        c_prev = cs[t - 1] if t > 0 else zeros
        gates = xs[t] + _per_dir(torch.matmul, h_prev, w, ndir)
        i, f, g, o = gates.split(hidden, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        tanh_c = torch.tanh(cs[t])
        dh = dho[t] + dh_carry
        do = dh * tanh_c
        dc = dc_carry + dh * o * (1.0 - tanh_c * tanh_c)
        dc_carry = dc * f
        dgates = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dxw[t] = dgates
        dh_carry = _per_dir(lambda g_, w_: g_ @ w_.T, dgates, w, ndir)
        dw = dw + _per_dir(lambda h_, g_: h_.T @ g_, h_prev, dgates, ndir)
    return dxw.to(xw.dtype), dw


def _check(xw: torch.Tensor, w_hh_t: torch.Tensor, ndir: int) -> None:
    if not isinstance(ndir, int) or ndir < 1:
        raise ValueError(f"ndir must be a positive int, got {ndir!r}")
    if xw.dim() != 3 or w_hh_t.dim() != 2:
        raise ValueError(f"lstm_fwd expects xw (L, ndir*B, 4H) and w_hh_t "
                         f"(ndir*H, 4H), got {tuple(xw.shape)} and "
                         f"{tuple(w_hh_t.shape)}")
    length, rows, gates4 = xw.shape
    hidden = gates4 // 4
    if gates4 % 4 or tuple(w_hh_t.shape) != (ndir * hidden, gates4):
        raise ValueError(f"w_hh_t must be (ndir*H, 4H) = ({ndir * hidden}, {gates4}) "
                         f"(H, 4H) per direction, got {tuple(w_hh_t.shape)}")
    if length < 1 or rows < 1 or rows % ndir:
        raise ValueError(f"lstm_fwd needs L >= 1 and ndir*B rows with B >= 1, got "
                         f"{tuple(xw.shape)} at ndir = {ndir}")
    if xw.device != w_hh_t.device:
        raise ValueError(f"xw on {xw.device}, w_hh_t on {w_hh_t.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself where its data starts on a 16-byte boundary, else a copy
    that does: the bf16 kernels take their inputs by bulk copies and TMA."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_kernel_inputs(name: str, tensors: dict,
                         dtype: torch.dtype = torch.float32) -> None:
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    for tname, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} kernel takes {dtype}, got {t.dtype} for {tname}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous {tname}")
    hidden = first.shape[-1] // 4
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"{name} kernels take 1 <= H <= {MAX_HIDDEN} (H up to "
                         f"{KERNEL_HIDDEN[-1]} on the width-specialised instances, padded "
                         f"to one of {KERNEL_HIDDEN}; any wider on `{name}_any`), got "
                         f"H = {hidden}")
    ndir = tensors["w_hh_t"].shape[0] // hidden
    if ndir > MAX_DIRECTIONS:
        raise ValueError(f"{name} kernel takes at most {MAX_DIRECTIONS} directions, "
                         f"got {ndir}")


def kernel_hidden(hidden: int) -> int:
    """The H a kernel runs `hidden` at: the least width of KERNEL_HIDDEN at
    or above it (the wrappers pad to it), else `hidden` itself (lstm_any.cu)."""
    return next((w for w in KERNEL_HIDDEN if w >= hidden), hidden)


def _pad_units(t: torch.Tensor, blocks: int, hidden: int, run: int) -> torch.Tensor:
    """(..., blocks * hidden) -> (..., blocks * run): each block of `hidden`
    units followed by run - hidden zeros."""
    lead = t.shape[:-1]
    return F.pad(t.view(*lead, blocks, hidden), (0, run - hidden)).view(*lead, blocks * run)


def _unpad_units(t: torch.Tensor, blocks: int, hidden: int, run: int) -> torch.Tensor:
    lead = t.shape[:-1]
    return t.view(*lead, blocks, run)[..., :hidden].reshape(*lead, blocks * hidden)


def _pad_w(w_hh_t: torch.Tensor, ndir: int, hidden: int, run: int) -> torch.Tensor:
    """(ndir * H, 4H) W_hh^T -> (ndir * run, 4 run): each direction's rows
    and each gate's columns padded with zeros."""
    w = F.pad(w_hh_t.view(ndir, hidden, 4, hidden), (0, run - hidden, 0, 0, 0, run - hidden))
    return w.view(ndir * run, 4 * run)


def _unpad_w(dw: torch.Tensor, ndir: int, hidden: int, run: int) -> torch.Tensor:
    return dw.view(ndir, run, 4, run)[:, :hidden, :, :hidden].reshape(ndir * hidden, 4 * hidden)


def at_kernel_width_fwd(launch, xw: torch.Tensor, w_hh_t: torch.Tensor, ndir: int):
    """`launch(xw, w_hh_t, ndir)` -> (hs, cs) at `kernel_hidden(H)`: below it,
    xw's gate blocks and W_hh^T padded with zeros, hs and cs sliced back.
    Exact: a padded unit's gates are 0, so its c and h stay 0, and its zero
    rows of W_hh^T add nothing to a real unit's gates."""
    hidden = xw.shape[-1] // 4
    run = kernel_hidden(hidden)
    if run == hidden:
        return launch(xw, w_hh_t, ndir)
    hs, cs = launch(_pad_units(xw, 4, hidden, run), _pad_w(w_hh_t, ndir, hidden, run), ndir)
    return hs[..., :hidden].contiguous(), cs[..., :hidden].contiguous()


def at_kernel_width_bwd(launch, xw: torch.Tensor, w_hh_t: torch.Tensor, hs: torch.Tensor,
                        cs: torch.Tensor, dho: torch.Tensor, ndir: int):
    """`launch(xw, w_hh_t, hs, cs, dho, ndir)` -> (dxw, dW_hh^T) at
    `kernel_hidden(H)`, padded as `at_kernel_width_fwd` pads: a padded
    unit's dho is 0 and its zero columns of W_hh^T give it no dh carry, so
    its dgates are 0; dxw and dW_hh^T sliced back."""
    hidden = xw.shape[-1] // 4
    run = kernel_hidden(hidden)
    if run == hidden:
        return launch(xw, w_hh_t, hs, cs, dho, ndir)
    dxw, dw = launch(_pad_units(xw, 4, hidden, run), _pad_w(w_hh_t, ndir, hidden, run),
                     *(_pad_units(t, 1, hidden, run) for t in (hs, cs, dho)), ndir)
    return _unpad_units(dxw, 4, hidden, run), _unpad_w(dw, ndir, hidden, run)


def lstm_fwd(xw: torch.Tensor, w_hh_t: torch.Tensor, ndir: int = 1):
    """`ndir` LSTM directions: (L, ndir * B, 4H) xw, (ndir * H, 4H) W_hh^T
    -> (hs, cs), each (L, ndir * B, H) float32. The kernel on a CUDA
    tensor, the plain loop on a CPU tensor. The kernels take contiguous
    float32: H up to 128 on `lstm_fwd.cu` (padded to KERNEL_HIDDEN), 129 <=
    H <= MAX_HIDDEN on `lstm_any.cu`; bf16 goes to `lstm_fwd_bf16`."""
    _check(xw, w_hh_t, ndir)
    refuse_bf16("lstm_fwd", {"xw": xw, "w_hh_t": w_hh_t})
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, w_hh_t, ndir)
    _check_kernel_inputs("lstm_fwd", {"xw": xw, "w_hh_t": w_hh_t})
    return at_kernel_width_fwd(_launch_fwd, xw, w_hh_t, ndir)


def _launch_fwd(xw: torch.Tensor, w_hh_t: torch.Tensor, ndir: int):
    length, rows, gates4 = xw.shape
    hidden = gates4 // 4
    hs = torch.empty(length, rows, hidden, device=xw.device, dtype=torch.float32)
    cs = torch.empty_like(hs)
    kernel = LSTM_FWD if hidden in KERNEL_HIDDEN else LSTM_FWD_ANY
    with torch.cuda.device(xw.device):
        kernel(ptr(xw), ptr(w_hh_t), ptr(hs), ptr(cs), length, rows // ndir, hidden,
               ndir, stream_handle(xw.device))
    return hs, cs


def lstm_fwd_bf16(xw: torch.Tensor, w_hh_t: torch.Tensor, ndir: int = 1):
    """`lstm_fwd` on bf16 xw and W_hh^T -> (hs bf16, cs float32), each
    (L, ndir * B, H): K1''s bf16 instance on a CUDA tensor, the plain loop
    on a CPU tensor. Raises on any other dtype."""
    _check(xw, w_hh_t, ndir)
    require_bf16("lstm_fwd_bf16", {"xw": xw, "w_hh_t": w_hh_t})
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, w_hh_t, ndir)
    _check_kernel_inputs("lstm_fwd_bf16", {"xw": xw, "w_hh_t": w_hh_t}, torch.bfloat16)
    return at_kernel_width_fwd(_launch_fwd_bf16, xw, w_hh_t, ndir)


def _launch_fwd_bf16(xw: torch.Tensor, w_hh_t: torch.Tensor, ndir: int):
    length, rows, gates4 = xw.shape
    hidden = gates4 // 4
    hs = torch.empty(length, rows, hidden, device=xw.device, dtype=torch.bfloat16)
    cs = torch.empty(length, rows, hidden, device=xw.device, dtype=torch.float32)
    kernel = LSTM_FWD_BF16 if hidden in KERNEL_HIDDEN else LSTM_FWD_ANY_BF16
    xw = _aligned(xw)
    with torch.cuda.device(xw.device):
        kernel(ptr(xw), ptr(w_hh_t), ptr(hs), ptr(cs), length, rows // ndir, hidden, ndir,
               stream_handle(xw.device))
    return hs, cs


def _check_bwd(name: str, xw, hs, cs, dho) -> None:
    state = (xw.shape[0], xw.shape[1], xw.shape[2] // 4)
    for tname, t in (("hs", hs), ("cs", cs), ("dho", dho)):
        if tuple(t.shape) != state or t.device != xw.device:
            raise ValueError(f"{name}: {tname} must be {state} on {xw.device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def _bwd_scratch(xw: torch.Tensor, ndir: int, splits: int):
    """K2''s scratch arrays: the dW_hh^T partial products (ndir, splits, H,
    4H) and the dc factors gf (L, ndir * B, H, 2), both float32."""
    length, rows, gates4 = xw.shape
    hidden = gates4 // 4
    partial = torch.empty(ndir, splits, hidden, gates4, device=xw.device,
                          dtype=torch.float32)
    # per (t, row, unit) the factors of K2''s dc update, {o(1 - tanh(c)^2), f}
    gf = torch.empty(length, rows, hidden, 2, device=xw.device, dtype=torch.float32)
    return partial, gf


def _any_scratch(xw: torch.Tensor, ndir: int, splits: int):
    """`lstm_any.cu`'s backward scratch: the dW_hh^T partial products
    (ndir, splits, H, 4H) and every step's gate activations (L, ndir * B,
    4H), both float32."""
    length, rows, gates4 = xw.shape
    partial = torch.empty(ndir, splits, gates4 // 4, gates4, device=xw.device,
                          dtype=torch.float32)
    act = torch.empty(length, rows, gates4, device=xw.device, dtype=torch.float32)
    return partial, act


def lstm_bwd(xw: torch.Tensor, w_hh_t: torch.Tensor, hs: torch.Tensor,
             cs: torch.Tensor, dho: torch.Tensor, ndir: int = 1):
    """Backward of `ndir` LSTM directions: `lstm_fwd`'s inputs and outputs
    and the gradient dho of hs -> (dxw (L, ndir * B, 4H), dW_hh^T
    (ndir * H, 4H)) float32. The kernel on a CUDA tensor, the plain loop on
    a CPU tensor; bf16 goes to `lstm_bwd_bf16`."""
    _check(xw, w_hh_t, ndir)
    refuse_bf16("lstm_bwd", {"xw": xw, "w_hh_t": w_hh_t, "dho": dho})
    _check_bwd("lstm_bwd", xw, hs, cs, dho)
    if xw.device.type == "cpu":
        return lstm_bwd_plain(xw, w_hh_t, hs, cs, dho, ndir)
    _check_kernel_inputs("lstm_bwd", {"xw": xw, "w_hh_t": w_hh_t, "hs": hs,
                                      "cs": cs, "dho": dho})
    return at_kernel_width_bwd(_launch_bwd, xw, w_hh_t, hs, cs, dho, ndir)


def _launch_bwd(xw, w_hh_t, hs, cs, dho, ndir: int):
    length, rows, gates4 = xw.shape
    splits = dw_splits(length, rows // ndir)
    dxw = torch.empty_like(xw)
    dw = torch.empty_like(w_hh_t)
    if gates4 // 4 not in KERNEL_HIDDEN:
        partial, act = _any_scratch(xw, ndir, splits)
        with torch.cuda.device(xw.device):
            LSTM_BWD_ANY(ptr(xw), ptr(w_hh_t), ptr(hs), ptr(cs), ptr(dho), ptr(dxw),
                         ptr(dw), ptr(partial), ptr(act), length, rows // ndir, gates4 // 4,
                         ndir, splits, stream_handle(xw.device))
        return dxw, dw
    partial, gf = _bwd_scratch(xw, ndir, splits)
    with torch.cuda.device(xw.device):
        LSTM_BWD(ptr(xw), ptr(w_hh_t), ptr(hs), ptr(cs), ptr(dho), ptr(dxw),
                 ptr(dw), ptr(partial), ptr(gf), length, rows // ndir, gates4 // 4, ndir,
                 splits, stream_handle(xw.device))
    return dxw, dw


def lstm_bwd_bf16(xw: torch.Tensor, w_hh_t: torch.Tensor, hs: torch.Tensor,
                  cs: torch.Tensor, dho: torch.Tensor, ndir: int = 1):
    """`lstm_bwd` on bf16 xw, W_hh^T, hs and dho beside float32 cs ->
    (dxw (L, ndir * B, 4H) bf16, dW_hh^T (ndir * H, 4H) float32): K2''s
    bf16 instance on a CUDA tensor, the plain loop on a CPU tensor. Raises
    on any other dtype."""
    _check(xw, w_hh_t, ndir)
    require_bf16("lstm_bwd_bf16", {"xw": xw, "w_hh_t": w_hh_t, "hs": hs, "dho": dho})
    if cs.dtype != torch.float32:
        raise TypeError(f"lstm_bwd_bf16 takes float32 cs, got {cs.dtype}")
    _check_bwd("lstm_bwd_bf16", xw, hs, cs, dho)
    if xw.device.type == "cpu":
        return lstm_bwd_plain(xw, w_hh_t, hs, cs, dho, ndir)
    _check_kernel_inputs("lstm_bwd_bf16", {"xw": xw, "w_hh_t": w_hh_t, "hs": hs,
                                           "dho": dho}, torch.bfloat16)
    if not cs.is_contiguous():
        raise ValueError("lstm_bwd_bf16 kernel takes contiguous cs")
    return at_kernel_width_bwd(_launch_bwd_bf16, xw, w_hh_t, hs, cs, dho, ndir)


def _launch_bwd_bf16(xw, w_hh_t, hs, cs, dho, ndir: int):
    length, rows, gates4 = xw.shape
    dxw = torch.empty_like(xw)
    dw = torch.empty(w_hh_t.shape, device=xw.device, dtype=torch.float32)
    if gates4 // 4 not in KERNEL_HIDDEN:
        splits = dw_splits(length, rows // ndir)
        partial, act = _any_scratch(xw, ndir, splits)
        dg = torch.empty(xw.shape, device=xw.device, dtype=torch.float32)  # dgates, f32
        with torch.cuda.device(xw.device):
            LSTM_BWD_ANY_BF16(ptr(xw), ptr(w_hh_t), ptr(hs), ptr(cs), ptr(dho), ptr(dxw),
                              ptr(dw), ptr(partial), ptr(act), ptr(dg), length, rows // ndir,
                              gates4 // 4, ndir, splits, stream_handle(xw.device))
        return dxw, dw
    splits = dw_splits_bf16(length, rows // ndir)
    partial, gf = _bwd_scratch(xw, ndir, splits)
    # the f32 coefficients of the gate recompute, then dgates' mid and lo
    # parts (dxw holds hi), which feed dW_hh^T
    dg = torch.empty(xw.shape, device=xw.device, dtype=torch.float32)
    xw, w_hh_t, hs, cs, dho = (_aligned(t) for t in (xw, w_hh_t, hs, cs, dho))
    with torch.cuda.device(xw.device):
        LSTM_BWD_BF16(ptr(xw), ptr(w_hh_t), ptr(hs), ptr(cs), ptr(dho), ptr(dxw),
                      ptr(dw), ptr(partial), ptr(gf), ptr(dg), length, rows // ndir,
                      gates4 // 4, ndir, splits, stream_handle(xw.device))
    return dxw, dw


class LSTMRecurrence(torch.autograd.Function):
    """Forward K1' (the op `rlt::lstm_fwd`, or `rlt::lstm_fwd_bf16` for
    bf16 xw, which call `lstm_fwd` and `lstm_fwd_bf16`; `ops/library.py`),
    backward K2' (`lstm_bwd`, or `lstm_bwd_bf16`) over `ndir` directions,
    the wrappers looked up as module attributes at each call; it saves xw,
    W_hh^T, hs and cs, as the JAX package's custom_vjp does. Beside bf16 xw, W_hh^T may be f32
    (the master weight of a bf16 training step): it is rounded to bf16 for
    the kernels here, and its gradient, K2''s f32 sum, is returned in f32,
    which autograd would round to bf16 had the Function received W_hh^T in
    bf16."""

    @staticmethod
    def forward(ctx, xw, w_hh_t, ndir=1):
        bf16 = xw.dtype == torch.bfloat16
        w = w_hh_t.to(torch.bfloat16) if bf16 else w_hh_t
        fwd = torch.ops.rlt.lstm_fwd_bf16 if bf16 else torch.ops.rlt.lstm_fwd
        hs, cs = fwd(xw, w, ndir)
        ctx.save_for_backward(xw, w, hs, cs)
        ctx.ndir = ndir
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xw, w_hh_t, hs, cs = ctx.saved_tensors
        bwd = lstm_bwd_bf16 if xw.dtype == torch.bfloat16 else lstm_bwd
        dxw, dw = bwd(xw, w_hh_t, hs, cs, dhs.contiguous(), ctx.ndir)
        return dxw, dw, None


def fused_lstm(xw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """One LSTM direction's hidden states (L, B, H), differentiable, as the
    JAX package's `fused_lstm`. The reverse direction is the caller's time
    flip."""
    if xw.dim() != 3:
        raise ValueError(f"fused_lstm expects xw (L, B, 4H), got {tuple(xw.shape)}")
    return LSTMRecurrence.apply(xw, w_hh_t, 1)


def fused_lstm_bidir(xw_fwd: torch.Tensor, xw_rev: torch.Tensor,
                     w_hh_fwd_t: torch.Tensor, w_hh_rev_t: torch.Tensor):
    """Both directions of a BiLSTM layer in one launch (ndir = 2), as the JAX
    package's `fused_lstm_bidir`: xw_fwd and xw_rev (L, B, 4H), both in
    kernel time order (the caller flips the reverse direction's inputs
    before and its outputs after), W_hh^T (H, 4H) each -> (hs_fwd, hs_rev),
    each (L, B, H), hs_rev still in flipped time order. Differentiable.

    With a leading member axis, the counterpart of `jax.vmap` of the JAX
    function over K population members: xw_fwd and xw_rev (K, L, B, 4H),
    W_hh^T (K, H, 4H) each -> hs_fwd and hs_rev (K, L, B, H), all K
    members' layers in one launch at ndir = 2K, member m's directions at
    d = 2m (forward) and 2m + 1 (reverse), each with its own W_hh^T."""
    members = xw_fwd.dim() == 4
    if xw_fwd.dim() not in (3, 4) or xw_rev.shape != xw_fwd.shape:
        raise ValueError(f"fused_lstm_bidir expects two (L, B, 4H) inputs of one "
                         f"shape, or (K, L, B, 4H) over K members, got "
                         f"{tuple(xw_fwd.shape)} and {tuple(xw_rev.shape)}")
    if not members:
        batch = xw_fwd.shape[1]
        # one write each of the kernels' (L, 2B, 4H) and (2H, 4H) layouts
        hs = LSTMRecurrence.apply(torch.cat([xw_fwd, xw_rev], dim=1),
                                  torch.cat([w_hh_fwd_t, w_hh_rev_t]), 2)
        return hs[:, :batch], hs[:, batch:]
    k, length, batch, gates4 = xw_fwd.shape
    if w_hh_fwd_t.shape != (k, gates4 // 4, gates4) or w_hh_rev_t.shape != w_hh_fwd_t.shape:
        raise ValueError(f"fused_lstm_bidir over {k} members expects W_hh^T "
                         f"({k}, H, 4H) each, got {tuple(w_hh_fwd_t.shape)} and "
                         f"{tuple(w_hh_rev_t.shape)}")
    # one write each of the kernels' (L, 2K B, 4H) and (2K H, 4H) layouts:
    # the time-major views stacked as (L, K, 2, B, 4H), rows (2m + s) B + b
    xw = torch.stack([xw_fwd.transpose(0, 1), xw_rev.transpose(0, 1)], dim=2)
    w = torch.stack([w_hh_fwd_t, w_hh_rev_t], dim=1)
    hs = LSTMRecurrence.apply(xw.reshape(length, 2 * k * batch, gates4),
                              w.reshape(2 * k * w.shape[2], gates4), 2 * k)
    hs = hs.view(length, k, 2, batch, -1).transpose(0, 1)  # (K, L, 2, B, H)
    return hs[:, :, 0], hs[:, :, 1]
