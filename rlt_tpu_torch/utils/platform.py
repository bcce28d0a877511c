"""Device choice for the port's entry points.

The port runs on a CUDA card unless the caller names the CPU. It never moves
to the CPU on its own: a run that asked for the card and found none raises,
so that no number taken on the CPU passes for one taken on the card."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`cuda` unless the caller passes `"cpu"`; raises when CUDA is absent
    and the CPU was not asked for.

    Also turns TF32 off for matrix products and cuDNN: the parity
    tolerances of the port (tests/test_torch_*.py, chip_smoke.py) assume
    full float32 arithmetic."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rlt_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' (--device cpu) to run the plain PyTorch "
                "path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
