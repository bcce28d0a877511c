"""LSTM recurrence: CUDA kernels K1' (forward) and K2' (backward) and their
plain PyTorch versions.

The counterpart of the JAX package's `ops/lstm.py::fused_lstm` and its
custom_vjp. The input projection for all time steps is hoisted out of the
recurrence by the caller (`models/layers.py::_gate_inputs`); what remains
per step is gates = xw_t + h W_hh^T in torch gate order i, f, g, o, then
c = f c + i g and h = o tanh(c), from a zero state. The backward walks time
in reverse from the saved hs and cs, recomputing the gates, and returns the
gradients of xw and of W_hh^T.

On a CUDA tensor `lstm_fwd` and `lstm_bwd` launch the kernels of
`rlt_tpu_torch/csrc/lstm_fwd.cu` and `csrc/lstm_bwd.cu` and raise on
anything they do not take. On a CPU tensor they run `lstm_recurrence_plain`
and `lstm_bwd_plain`, explicit time loops.
"""

from __future__ import annotations

import ctypes

import torch

from rlt_tpu_torch.ops.build import Kernel, ptr, stream_handle

LSTM_FWD = Kernel("rlt_lstm_fwd", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])
LSTM_BWD = Kernel("rlt_lstm_bwd", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
# most chunks the dW_hh^T contraction is split into (K2' sums their partial
# products in a second pass, in a fixed order)
DW_SPLITS = 32


def lstm_recurrence_plain(xw: torch.Tensor, w_hh_t: torch.Tensor):
    """(L, B, 4H) gate inputs, (H, 4H) W_hh^T -> hs, cs, each (L, B, H)."""
    length, batch, gates4 = xw.shape
    hidden = gates4 // 4
    h = xw.new_zeros(batch, hidden)
    c = xw.new_zeros(batch, hidden)
    hs, cs = [], []
    for t in range(length):
        gates = xw[t] + h @ w_hh_t
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_bwd_plain(xw: torch.Tensor, w_hh_t: torch.Tensor, hs: torch.Tensor,
                   cs: torch.Tensor, dho: torch.Tensor):
    """The JAX package's reverse-time LSTM backward as an explicit loop:
    (L, B, 4H) xw, (H, 4H) W_hh^T, hs, cs and dho (L, B, H) -> dxw (L, B,
    4H), dW_hh^T (H, 4H)."""
    length, batch, gates4 = xw.shape
    hidden = gates4 // 4
    zeros = xw.new_zeros(batch, hidden)
    dh_carry, dc_carry = zeros, zeros
    dw = torch.zeros_like(w_hh_t)
    dxw = torch.empty_like(xw)
    for t in range(length - 1, -1, -1):
        h_prev = hs[t - 1] if t > 0 else zeros
        c_prev = cs[t - 1] if t > 0 else zeros
        gates = xw[t] + h_prev @ w_hh_t
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
        dh_carry = dgates @ w_hh_t.T
        dw = dw + h_prev.T @ dgates
    return dxw, dw


def _check(xw: torch.Tensor, w_hh_t: torch.Tensor) -> None:
    if xw.dim() != 3 or w_hh_t.dim() != 2:
        raise ValueError(f"lstm_fwd expects xw (L, B, 4H) and w_hh_t (H, 4H), "
                         f"got {tuple(xw.shape)} and {tuple(w_hh_t.shape)}")
    length, batch, gates4 = xw.shape
    hidden = gates4 // 4
    if gates4 % 4 or tuple(w_hh_t.shape) != (hidden, gates4):
        raise ValueError(f"w_hh_t must be (H, 4H) = ({hidden}, {gates4}), got "
                         f"{tuple(w_hh_t.shape)}")
    if length < 1 or batch < 1:
        raise ValueError(f"lstm_fwd needs L >= 1 and B >= 1, got {tuple(xw.shape)}")
    if xw.device != w_hh_t.device:
        raise ValueError(f"xw on {xw.device}, w_hh_t on {w_hh_t.device}")


def _check_kernel_inputs(name: str, tensors: dict) -> None:
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    for tname, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {t.dtype} for {tname}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous {tname}")
    hidden = first.shape[-1] // 4
    if hidden % 32 or not 32 <= hidden <= 128:
        raise ValueError(f"{name} kernel takes H a multiple of 32 in "
                         f"[32, 128], got H = {hidden}")


def lstm_fwd(xw: torch.Tensor, w_hh_t: torch.Tensor):
    """One LSTM direction: (L, B, 4H) xw, (H, 4H) W_hh^T -> (hs, cs), each
    (L, B, H) float32. The kernel on a CUDA tensor, the plain loop on a CPU
    tensor. The kernel takes contiguous float32 with H a multiple of 32 in
    [32, 128]."""
    _check(xw, w_hh_t)
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, w_hh_t)
    _check_kernel_inputs("lstm_fwd", {"xw": xw, "w_hh_t": w_hh_t})
    length, batch, gates4 = xw.shape
    hidden = gates4 // 4
    hs = torch.empty(length, batch, hidden, device=xw.device, dtype=torch.float32)
    cs = torch.empty_like(hs)
    with torch.cuda.device(xw.device):
        LSTM_FWD(ptr(xw), ptr(w_hh_t), ptr(hs), ptr(cs), length, batch, hidden,
                 stream_handle(xw.device))
    return hs, cs


def lstm_bwd(xw: torch.Tensor, w_hh_t: torch.Tensor, hs: torch.Tensor,
             cs: torch.Tensor, dho: torch.Tensor):
    """Backward of one LSTM direction: `lstm_fwd`'s inputs and outputs and
    the gradient dho of hs -> (dxw (L, B, 4H), dW_hh^T (H, 4H)) float32. The
    kernel on a CUDA tensor, the plain loop on a CPU tensor."""
    _check(xw, w_hh_t)
    state = (xw.shape[0], xw.shape[1], xw.shape[2] // 4)
    for name, t in (("hs", hs), ("cs", cs), ("dho", dho)):
        if tuple(t.shape) != state or t.device != xw.device:
            raise ValueError(f"lstm_bwd: {name} must be {state} on {xw.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if xw.device.type == "cpu":
        return lstm_bwd_plain(xw, w_hh_t, hs, cs, dho)
    _check_kernel_inputs("lstm_bwd", {"xw": xw, "w_hh_t": w_hh_t, "hs": hs,
                                      "cs": cs, "dho": dho})
    length, batch, hidden = state
    splits = max(1, min(DW_SPLITS, (length - 1) * batch // 512))
    dxw = torch.empty_like(xw)
    dw = torch.empty_like(w_hh_t)
    partial = torch.empty(splits, hidden, 4 * hidden, device=xw.device,
                          dtype=torch.float32)
    with torch.cuda.device(xw.device):
        LSTM_BWD(ptr(xw), ptr(w_hh_t), ptr(hs), ptr(cs), ptr(dho), ptr(dxw),
                 ptr(dw), ptr(partial), length, batch, hidden, splits,
                 stream_handle(xw.device))
    return dxw, dw


class LSTMRecurrence(torch.autograd.Function):
    """Forward K1' (`lstm_fwd`), backward K2' (`lstm_bwd`), looked up as
    module attributes at each call; it saves xw, W_hh^T, hs and cs, as the
    JAX package's custom_vjp does."""

    @staticmethod
    def forward(ctx, xw, w_hh_t):
        hs, cs = lstm_fwd(xw, w_hh_t)
        ctx.save_for_backward(xw, w_hh_t, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xw, w_hh_t, hs, cs = ctx.saved_tensors
        return lstm_bwd(xw, w_hh_t, hs, cs, dhs.contiguous())


def fused_lstm(xw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """One LSTM direction's hidden states (L, B, H), differentiable, as the
    JAX package's `fused_lstm`. The reverse direction is the caller's time
    flip."""
    return LSTMRecurrence.apply(xw, w_hh_t)
