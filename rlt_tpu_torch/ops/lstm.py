"""LSTM recurrence forward: CUDA kernel K1' and its plain PyTorch version.

The counterpart of the JAX package's `ops/lstm.py::fused_lstm` forward.
The input projection for all time steps is hoisted out of the recurrence
by the caller (`models/layers.py::_gate_inputs`); what remains per step is
gates = xw_t + h W_hh^T in torch gate order i, f, g, o, then
c = f c + i g and h = o tanh(c), from a zero state.

On a CUDA tensor `lstm_fwd` launches the kernel of
`rlt_tpu_torch/csrc/lstm_fwd.cu` and raises on anything it does not take.
On a CPU tensor it runs `lstm_recurrence_plain`, an explicit time loop.
"""

from __future__ import annotations

import ctypes

import torch

from rlt_tpu_torch.ops.build import Kernel, ptr, stream_handle

LSTM_FWD = Kernel("rlt_lstm_fwd", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])


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


def lstm_fwd(xw: torch.Tensor, w_hh_t: torch.Tensor):
    """One LSTM direction: (L, B, 4H) xw, (H, 4H) W_hh^T -> (hs, cs), each
    (L, B, H) float32. The kernel on a CUDA tensor, the plain loop on a CPU
    tensor. The kernel takes contiguous float32 with H a multiple of 32 in
    [32, 128]."""
    _check(xw, w_hh_t)
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, w_hh_t)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_fwd: unsupported device {xw.device}")
    length, batch, gates4 = xw.shape
    hidden = gates4 // 4
    if xw.dtype != torch.float32 or w_hh_t.dtype != torch.float32:
        raise TypeError(f"lstm_fwd kernel takes float32, got {xw.dtype} and "
                        f"{w_hh_t.dtype}")
    if not (xw.is_contiguous() and w_hh_t.is_contiguous()):
        raise ValueError("lstm_fwd kernel takes contiguous xw and w_hh_t")
    if hidden % 32 or not 32 <= hidden <= 128:
        raise ValueError(f"lstm_fwd kernel takes H a multiple of 32 in "
                         f"[32, 128], got H = {hidden}")
    hs = torch.empty(length, batch, hidden, device=xw.device, dtype=torch.float32)
    cs = torch.empty_like(hs)
    with torch.cuda.device(xw.device):
        LSTM_FWD(ptr(xw), ptr(w_hh_t), ptr(hs), ptr(cs), length, batch, hidden,
                 stream_handle(xw.device))
    return hs, cs


def fused_lstm(xw: torch.Tensor, w_hh_t: torch.Tensor) -> torch.Tensor:
    """One LSTM direction's hidden states (L, B, H), as the JAX package's
    `fused_lstm`. The reverse direction is the caller's time flip."""
    return lstm_fwd(xw, w_hh_t)[0]
