"""Feature-channel normalisation (the JAX package's `utils/batchnorm.py`;
the reference's utils/batchnorm.py:4-11, a helper that normalises each
feature channel over the whole dataset)."""

from __future__ import annotations

import torch


def batch_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Each feature channel of (N, L, F) over all (N, L) positions to zero
    mean and unit variance (the population variance), as BatchNorm1d in
    eval mode with the dataset's statistics."""
    mean = torch.mean(x, dim=(0, 1), keepdim=True)
    var = torch.var(x, dim=(0, 1), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)
