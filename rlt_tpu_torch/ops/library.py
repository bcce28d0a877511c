"""The forward kernels K1', K3' and K5' as `torch.library` custom ops.

`torch.export` traces a model with fake tensors, which hold no data, so it
cannot pass through the wrappers' `ctypes` launches (`ops/build.py::Kernel`
reads `data_ptr()`). Registered as custom ops under the `rlt` namespace,
each with a fake implementation that gives its outputs' shapes and dtypes,
the six forward launchers become single nodes of an exported program:

    rlt::lstm_fwd, rlt::lstm_fwd_bf16                      K1'
    rlt::attention_fwd, rlt::attention_fwd_bf16            K3'
    rlt::attention_packed_fwd, rlt::attention_packed_fwd_bf16  K5'

An op's implementation calls its wrapper, looked up on `ops.lstm` or
`ops.attention` at each call, so it keeps the wrapper's branches (the
plain version on a CPU tensor, the kernel on a CUDA tensor, a raise
otherwise), its launch count, and `ops.plain_ops()`'s routing. The autograd
Functions of those modules (`LSTMRecurrence`, `AttentionPacked`,
`Attention`) call the ops in their forward, so training, serving and an
exported program launch the same op. The backward launchers (K2', K4',
K6') are not on an exported program's path and stay plain calls.

The dropout arguments of a training forward travel as the schema allows: the
per-row int32 `streams`, the float `rate`, and a `RowDropout`'s three (N,)
tensors (`row_rate`, `row_threshold`, `row_scale`) as optional tensors;
the keep threshold of a float rate is `attention.keep_threshold(rate)`,
computed by the wrapper as before. Importing this module registers the ops
and builds nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from rlt_tpu_torch.ops import attention, lstm

NAMESPACE = "rlt"


def _rate(rate: float, row_rate, row_threshold, row_scale):
    """The wrappers' `dropout_rate`: the float, or the `RowDropout` of the
    three per-row tensors."""
    if row_rate is None:
        return rate
    return attention.RowDropout(row_rate, row_threshold, row_scale)


# ---------------------------------------------------------------------------
# K1': the LSTM recurrence
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::lstm_fwd", mutates_args=())
def lstm_fwd(xw: Tensor, w_hh_t: Tensor, ndir: int) -> tuple[Tensor, Tensor]:
    return lstm.lstm_fwd(xw, w_hh_t, ndir)


@torch.library.custom_op(f"{NAMESPACE}::lstm_fwd_bf16", mutates_args=())
def lstm_fwd_bf16(xw: Tensor, w_hh_t: Tensor, ndir: int) -> tuple[Tensor, Tensor]:
    return lstm.lstm_fwd_bf16(xw, w_hh_t, ndir)


def _lstm_fake(xw, w_hh_t, ndir):
    length, rows, gates4 = xw.shape
    hs = xw.new_empty((length, rows, gates4 // 4))
    return hs, hs.new_empty(hs.shape, dtype=torch.float32)


lstm_fwd.register_fake(_lstm_fake)
lstm_fwd_bf16.register_fake(_lstm_fake)


# ---------------------------------------------------------------------------
# K3': per-slice attention
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::attention_fwd", mutates_args=())
def attention_fwd(q: Tensor, k: Tensor, v: Tensor, rate: float, streams: Optional[Tensor],
                  row_rate: Optional[Tensor], row_threshold: Optional[Tensor],
                  row_scale: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    return attention.attention_fwd(q, k, v, _rate(rate, row_rate, row_threshold, row_scale),
                                   streams)


@torch.library.custom_op(f"{NAMESPACE}::attention_fwd_bf16", mutates_args=())
def attention_fwd_bf16(q: Tensor, k: Tensor, v: Tensor, rate: float,
                       streams: Optional[Tensor], row_rate: Optional[Tensor],
                       row_threshold: Optional[Tensor],
                       row_scale: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    return attention.attention_fwd_bf16(
        q, k, v, _rate(rate, row_rate, row_threshold, row_scale), streams)


def _attention_fake(q, k, v, rate, streams, row_rate, row_threshold, row_scale):
    batch, heads, length, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((batch * heads, 1, length), dtype=torch.float32))


attention_fwd.register_fake(_attention_fake)
attention_fwd_bf16.register_fake(_attention_fake)


# ---------------------------------------------------------------------------
# K5': head-packed attention
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::attention_packed_fwd", mutates_args=())
def attention_packed_fwd(q: Tensor, k: Tensor, v: Tensor, heads: int, pack: int,
                         rate: float, streams: Optional[Tensor],
                         row_rate: Optional[Tensor], row_threshold: Optional[Tensor],
                         row_scale: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    return attention.attention_packed_fwd(
        q, k, v, heads, pack, _rate(rate, row_rate, row_threshold, row_scale), streams)


@torch.library.custom_op(f"{NAMESPACE}::attention_packed_fwd_bf16", mutates_args=())
def attention_packed_fwd_bf16(q: Tensor, k: Tensor, v: Tensor, heads: int, pack: int,
                              rate: float, streams: Optional[Tensor],
                              row_rate: Optional[Tensor], row_threshold: Optional[Tensor],
                              row_scale: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    return attention.attention_packed_fwd_bf16(
        q, k, v, heads, pack, _rate(rate, row_rate, row_threshold, row_scale), streams)


def _packed_fake(q, k, v, heads, pack, rate, streams, row_rate, row_threshold, row_scale):
    n, length, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((n, heads // pack, length, pack), dtype=torch.float32))


attention_packed_fwd.register_fake(_packed_fake)
attention_packed_fwd_bf16.register_fake(_packed_fake)
