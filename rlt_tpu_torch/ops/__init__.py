"""Operators of the port that run hand-written CUDA kernels on the card."""

import contextlib

from rlt_tpu_torch.ops import attention, lstm
from rlt_tpu_torch.ops.attention import (  # noqa: F401
    ATTENTION_BWD,
    ATTENTION_BWD_BF16,
    ATTENTION_FWD,
    ATTENTION_FWD_BF16,
    ATTENTION_PACKED_BWD,
    ATTENTION_PACKED_BWD_BF16,
    ATTENTION_PACKED_FWD,
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
    LSTM_BWD_BF16,
    LSTM_FWD,
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

# every kernel instance of the port, by the name chip_smoke.py and PERF.md
# use; the bf16 instances count their launches apart from the float32 ones
KERNELS = {"lstm_fwd": LSTM_FWD, "lstm_bwd": LSTM_BWD,
           "attention_fwd": ATTENTION_FWD, "attention_bwd": ATTENTION_BWD,
           "attention_packed_fwd": ATTENTION_PACKED_FWD,
           "attention_packed_bwd": ATTENTION_PACKED_BWD,
           "lstm_fwd_bf16": LSTM_FWD_BF16, "attention_fwd_bf16": ATTENTION_FWD_BF16,
           "attention_packed_fwd_bf16": ATTENTION_PACKED_FWD_BF16,
           "lstm_bwd_bf16": LSTM_BWD_BF16, "attention_bwd_bf16": ATTENTION_BWD_BF16,
           "attention_packed_bwd_bf16": ATTENTION_PACKED_BWD_BF16}

# each kernel's wrapper, by the same name, as (its module, its plain version)
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
    missing = set(KERNELS) - set(PLAIN_VERSIONS)
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
