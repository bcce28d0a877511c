"""Operators of the port that run hand-written CUDA kernels on the card."""

import contextlib
from typing import NamedTuple

from rlt_tpu_torch.ops import attention, lstm
from rlt_tpu_torch.ops import library  # noqa: F401  (registers the rlt:: forward ops)
from rlt_tpu_torch.ops.attention import (  # noqa: F401
    ATTENTION_BWD,
    ATTENTION_BWD_ANY,
    ATTENTION_BWD_ANY_BF16,
    ATTENTION_BWD_BF16,
    ATTENTION_FWD,
    ATTENTION_FWD_ANY,
    ATTENTION_FWD_ANY_BF16,
    ATTENTION_FWD_BF16,
    ATTENTION_PACKED_BWD,
    ATTENTION_PACKED_BWD_ANY,
    ATTENTION_PACKED_BWD_ANY_BF16,
    ATTENTION_PACKED_BWD_BF16,
    ATTENTION_PACKED_FWD,
    ATTENTION_PACKED_FWD_ANY,
    ATTENTION_PACKED_FWD_ANY_BF16,
    ATTENTION_PACKED_FWD_BF16,
    attention_bwd,
    attention_bwd_bf16,
    attention_bwd_plain,
    attention_fwd,
    attention_fwd_bf16,
    attention_packed_bwd,
    attention_packed_bwd_bf16,
    attention_packed_bwd_plain,
    attention_packed_fwd,
    attention_packed_fwd_bf16,
    attention_packed_plain,
    attention_plain,
    fused_attention,
    fused_attention_packed,
    packed_group_size,
)
from rlt_tpu_torch.ops.lstm import (  # noqa: F401
    LSTM_BWD,
    LSTM_BWD_ANY,
    LSTM_BWD_ANY_BF16,
    LSTM_BWD_BF16,
    LSTM_FWD,
    LSTM_FWD_ANY,
    LSTM_FWD_ANY_BF16,
    LSTM_FWD_BF16,
    fused_lstm,
    fused_lstm_bidir,
    lstm_bwd,
    lstm_bwd_bf16,
    lstm_bwd_plain,
    lstm_fwd,
    lstm_fwd_bf16,
    lstm_recurrence_plain,
)


class Instance(NamedTuple):
    """A kernel instance: the wrapper that launches it, its Kernel, and the
    widths at which the wrapper does (H after `lstm.kernel_hidden`'s
    padding for the LSTM wrappers, dh for the attention ones), None for
    every width the wrapper's other instance does not take."""

    wrapper: str
    kernel: object
    widths: tuple | None


_LSTM_H, _PACKED_DH, _SLICE_DH = (lstm.KERNEL_HIDDEN, attention.PACKED_HEAD_DIMS,
                                  (attention.SLICE_HEAD_DIM,))
# every kernel instance of the port, by the name chip_smoke.py and PERF.md
# use; the bf16 instances count their launches apart from the float32 ones,
# and the `_any` instances (csrc/lstm_any.cu, csrc/attention_any_dh.cu: every
# width the width-specialised ones do not take) apart from both
INSTANCES = {
    "lstm_fwd": Instance("lstm_fwd", LSTM_FWD, _LSTM_H),
    "lstm_bwd": Instance("lstm_bwd", LSTM_BWD, _LSTM_H),
    "attention_fwd": Instance("attention_fwd", ATTENTION_FWD, _SLICE_DH),
    "attention_bwd": Instance("attention_bwd", ATTENTION_BWD, _SLICE_DH),
    "attention_packed_fwd": Instance("attention_packed_fwd", ATTENTION_PACKED_FWD,
                                     _PACKED_DH),
    "attention_packed_bwd": Instance("attention_packed_bwd", ATTENTION_PACKED_BWD,
                                     _PACKED_DH),
    "lstm_fwd_bf16": Instance("lstm_fwd_bf16", LSTM_FWD_BF16, _LSTM_H),
    "attention_fwd_bf16": Instance("attention_fwd_bf16", ATTENTION_FWD_BF16, _SLICE_DH),
    "attention_packed_fwd_bf16": Instance("attention_packed_fwd_bf16",
                                          ATTENTION_PACKED_FWD_BF16, _PACKED_DH),
    "lstm_bwd_bf16": Instance("lstm_bwd_bf16", LSTM_BWD_BF16, _LSTM_H),
    "attention_bwd_bf16": Instance("attention_bwd_bf16", ATTENTION_BWD_BF16, _SLICE_DH),
    "attention_packed_bwd_bf16": Instance("attention_packed_bwd_bf16",
                                          ATTENTION_PACKED_BWD_BF16, _PACKED_DH),
    "lstm_fwd_any": Instance("lstm_fwd", LSTM_FWD_ANY, None),
    "lstm_bwd_any": Instance("lstm_bwd", LSTM_BWD_ANY, None),
    "lstm_fwd_any_bf16": Instance("lstm_fwd_bf16", LSTM_FWD_ANY_BF16, None),
    "lstm_bwd_any_bf16": Instance("lstm_bwd_bf16", LSTM_BWD_ANY_BF16, None),
    "attention_fwd_any": Instance("attention_fwd", ATTENTION_FWD_ANY, None),
    "attention_bwd_any": Instance("attention_bwd", ATTENTION_BWD_ANY, None),
    "attention_fwd_any_bf16": Instance("attention_fwd_bf16", ATTENTION_FWD_ANY_BF16, None),
    "attention_bwd_any_bf16": Instance("attention_bwd_bf16", ATTENTION_BWD_ANY_BF16, None),
    "attention_packed_fwd_any": Instance("attention_packed_fwd", ATTENTION_PACKED_FWD_ANY,
                                         None),
    "attention_packed_bwd_any": Instance("attention_packed_bwd", ATTENTION_PACKED_BWD_ANY,
                                         None),
    "attention_packed_fwd_any_bf16": Instance("attention_packed_fwd_bf16",
                                              ATTENTION_PACKED_FWD_ANY_BF16, None),
    "attention_packed_bwd_any_bf16": Instance("attention_packed_bwd_bf16",
                                              ATTENTION_PACKED_BWD_ANY_BF16, None)}
KERNELS = {name: inst.kernel for name, inst in INSTANCES.items()}


def instance_at(wrapper: str, width: int) -> str:
    """The instance that `wrapper` launches at hidden width H (the LSTM
    wrappers) or head width dh (the attention ones)."""
    if PLAIN_VERSIONS[wrapper][0] is lstm:
        width = lstm.kernel_hidden(width)
    ours = {inst.widths: name for name, inst in INSTANCES.items() if inst.wrapper == wrapper}
    return next((name for widths, name in ours.items() if widths and width in widths),
                ours[None])


# each kernel's wrapper, by its name, as (its module, its plain version)
PLAIN_VERSIONS = {"lstm_fwd": (lstm, lstm_recurrence_plain),
                  "lstm_bwd": (lstm, lstm_bwd_plain),
                  "attention_fwd": (attention, attention_plain),
                  "attention_bwd": (attention, attention_bwd_plain),
                  "attention_packed_fwd": (attention, attention_packed_plain),
                  "attention_packed_bwd": (attention, attention_packed_bwd_plain),
                  "lstm_fwd_bf16": (lstm, lstm_recurrence_plain),
                  "attention_fwd_bf16": (attention, attention_plain),
                  "attention_packed_fwd_bf16": (attention, attention_packed_plain),
                  "lstm_bwd_bf16": (lstm, lstm_bwd_plain),
                  "attention_bwd_bf16": (attention, attention_bwd_plain),
                  "attention_packed_bwd_bf16": (attention, attention_packed_bwd_plain)}


def plain_active() -> bool:
    """Whether `plain_ops()` routes the wrappers to their plain versions
    now. A CUDA graph replays the kernels it captured whatever the wrappers
    are, so `utils.graphs` neither captures nor replays while it does."""
    return any(getattr(module, name) is plain
               for name, (module, plain) in PLAIN_VERSIONS.items())


@contextlib.contextmanager
def plain_ops():
    """Route every kernel wrapper to its plain version, for reference runs
    of the same path on the card; restored on exit. The autograd Functions
    and the ops' other callers look the wrappers up on their module at call
    time, so they follow."""
    missing = {inst.wrapper for inst in INSTANCES.values()} - set(PLAIN_VERSIONS)
    if missing:
        raise RuntimeError(f"no plain version for the kernels {sorted(missing)}")
    saved = {name: getattr(module, name) for name, (module, _) in PLAIN_VERSIONS.items()}
    try:
        for name, (module, plain) in PLAIN_VERSIONS.items():
            setattr(module, name, plain)
        yield
    finally:
        for name, (module, _) in PLAIN_VERSIONS.items():
            setattr(module, name, saved[name])
