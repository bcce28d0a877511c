"""Operators of the port that run hand-written CUDA kernels on the card."""

from rlt_tpu_torch.ops.attention import (  # noqa: F401
    ATTENTION_PACKED_FWD,
    attention_packed_plain,
    fused_attention_packed,
    packed_group_size,
)
from rlt_tpu_torch.ops.lstm import (  # noqa: F401
    LSTM_FWD,
    fused_lstm,
    lstm_fwd,
    lstm_recurrence_plain,
)

# every kernel of the port, by the name chip_smoke.py and PERF.md use
KERNELS = {"lstm_fwd": LSTM_FWD, "attention_packed_fwd": ATTENTION_PACKED_FWD}
