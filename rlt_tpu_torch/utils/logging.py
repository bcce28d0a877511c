"""The metrics log (the JAX package's `utils/logging.py`, the reference's
tensorboardX wiring at run.py:19, 111, 146-156, 196-198).

An append-only JSONL stream of scalars with the reference's tag vocabulary
(train/..., test/...), mirrored to TensorBoard where
`torch.utils.tensorboard` imports (it needs the `tensorboard` package)."""

from __future__ import annotations

import json
import os
import time


def _summary_writer(log_dir: str):
    """A torch.utils.tensorboard SummaryWriter on `log_dir`, or None where
    it does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        return None
    return SummaryWriter(log_dir=log_dir)


class MetricsWriter:
    """Per-epoch and per-step scalars: `log_dir/run_name/metrics.jsonl`, and
    the TensorBoard mirror in the same directory."""

    TAGS = {
        "train_loss": "train/loss_epoch", "train_f1": "train/F1_epoch",
        "train_dcg": "train/DCG_epoch", "test_loss": "test/loss_epoch",
        "test_f1": "test/F1_epoch", "test_dcg": "test/DCG_epoch",
    }

    def __init__(self, log_dir: str, run_name: str = "run"):
        self.dir = os.path.join(log_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.jsonl")
        self._file = open(self.path, "a", buffering=1)
        self._tb = _summary_writer(self.dir)

    @staticmethod
    def _safe(v: float):
        """JSON has no Infinity or NaN: they become null."""
        v = float(v)
        return v if v == v and abs(v) != float("inf") else None

    def log(self, epoch: int, metrics: dict) -> None:
        row = {"epoch": epoch, "time": time.time()}
        row.update({k: self._safe(v) for k, v in metrics.items()})
        self._file.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for key, value in metrics.items():
                self._tb.add_scalar(self.TAGS.get(key, key), float(value), epoch)

    def log_step(self, step: int, tag: str, value: float) -> None:
        """A per-step scalar (the reference's 'train/loss_step', run.py:146)."""
        self._file.write(json.dumps({"step": step, tag: value}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def log_summary(self, summary: dict) -> None:
        self._file.write(json.dumps(
            {"summary": {k: self._safe(v) for k, v in summary.items()}}) + "\n")

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
