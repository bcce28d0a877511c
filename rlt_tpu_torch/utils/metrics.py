"""Truncation metrics and cut decoding in PyTorch.

The counterpart of the JAX package's `utils/metrics.py` for what serving
needs: metric curves at every cut position from one cumulative sum, the
metric at a chosen cut, and the decoding rules. Conventions are the same:
`labels` is a (B, L) binary relevance matrix and `k` counts documents
(1-based), so column j of a curve is k = j + 1.
"""

from __future__ import annotations

import torch


def dcg_discount(length: int, dtype=torch.float32,
                 device: torch.device | None = None) -> torch.Tensor:
    """log2(j+2) discount table, j = 0..length-1."""
    j = torch.arange(length, dtype=dtype, device=device)
    return torch.log2(j + 2.0)


def f1_curve(labels: torch.Tensor) -> torch.Tensor:
    """F1@k for every k: (B, L). Precision = (#relevant in prefix)/k, recall
    = (#relevant in prefix)/(#relevant in list), 0 where the list has no
    relevant document or P + R == 0."""
    labels = labels.to(torch.float32)
    cum_rel = torch.cumsum(labels, dim=-1)
    k = torch.arange(1, labels.shape[-1] + 1, dtype=torch.float32,
                     device=labels.device)
    total_rel = cum_rel[..., -1:]
    precision = cum_rel / k
    recall = torch.where(total_rel > 0,
                         cum_rel / torch.clamp(total_rel, min=1e-30),
                         torch.zeros_like(cum_rel))
    denom = precision + recall
    return torch.where(denom > 0,
                       2.0 * precision * recall / torch.clamp(denom, min=1e-30),
                       torch.zeros_like(denom))


def dcg_curve(labels: torch.Tensor, penalty: float = -1.0) -> torch.Tensor:
    """DCG@k for every k: each kept relevant document at rank j adds
    1/log2(j+2), each kept irrelevant one penalty/log2(j+2). (B, L)."""
    labels = labels.to(torch.float32)
    coef = dcg_discount(labels.shape[-1], device=labels.device)
    gains = torch.where(labels == 1.0, 1.0, penalty) / coef
    return torch.cumsum(gains, dim=-1)


def _gather_at_k(curve: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """curve (B, L), ks (B,) 1-based -> (B,) values at the cut."""
    idx = torch.clamp(ks.to(torch.int64) - 1, 0, curve.shape[-1] - 1)
    return torch.gather(curve, -1, idx[:, None])[:, 0]


def _masked_mean(values: torch.Tensor,
                 valid: torch.Tensor | None) -> torch.Tensor:
    if valid is None:
        return torch.mean(values)
    valid = valid.to(values.dtype)
    return torch.sum(values * valid) / torch.clamp(torch.sum(valid), min=1.0)


def f1_at_k(labels: torch.Tensor, ks: torch.Tensor,
            valid: torch.Tensor | None = None) -> torch.Tensor:
    """Batch-mean F1 at per-row cuts `ks` (1-based)."""
    return _masked_mean(_gather_at_k(f1_curve(labels), ks), valid)


def dcg_at_k(labels: torch.Tensor, ks: torch.Tensor, penalty: float = -1.0,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Batch-mean penalized DCG at per-row cuts `ks`."""
    return _masked_mean(_gather_at_k(dcg_curve(labels, penalty), ks), valid)


def decode_cut(scores: torch.Tensor) -> torch.Tensor:
    """k = argmax over positions + 1, for (B, L) or (B, L, 1) distributions."""
    if scores.dim() == 3:
        scores = scores[..., 0]
    return torch.argmax(scores, dim=-1).to(torch.int32) + 1


def decode_cut_bicut(output: torch.Tensor) -> torch.Tensor:
    """BiCut rule: `output` (B, L, 2) holds per-position {0: truncate,
    1: continue} probabilities. k = L when every position says continue,
    else (first truncate position) + 1."""
    decisions = torch.argmax(output, dim=-1)
    seq_len = output.shape[1]
    all_continue = torch.sum(decisions, dim=-1) == seq_len
    # argmax of (decision == 0) is the first truncate position
    first_trunc = torch.argmax((decisions == 0).to(torch.int32), dim=-1)
    return torch.where(all_continue, seq_len, first_trunc + 1).to(torch.int32)
