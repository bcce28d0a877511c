"""Truncation metrics and cut decoding in PyTorch.

The counterpart of the JAX package's `utils/metrics.py`: metric curves at
every cut position from one cumulative sum, the reward matrices of the
losses, the metric at a chosen cut, the decoding rules, the auxiliary-task
metrics of the verification harnesses (rerank DCG, per-query AUC) and the
classical baselines (oracle, greedy k, fixed k). Conventions are the same:
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


def reward_matrix(labels: torch.Tensor, metric: str = "f1") -> torch.Tensor:
    """(B, L) rewards r[i, j] = metric(labels[i], k = j + 1)."""
    if metric == "f1":
        return f1_curve(labels)
    if metric == "dcg":
        return dcg_curve(labels)
    raise ValueError(f"unknown reward metric: {metric!r}")


def _gather_at_k(curve: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """curve (..., B, L), ks (..., B) 1-based -> (..., B) values at the cut."""
    idx = torch.clamp(ks.to(torch.int64) - 1, 0, curve.shape[-1] - 1)
    return torch.gather(curve, -1, idx[..., None])[..., 0]


def _masked_mean(values: torch.Tensor,
                 valid: torch.Tensor | None) -> torch.Tensor:
    """The mean over the last (row) axis, over the valid rows."""
    if valid is None:
        return torch.mean(values, dim=-1)
    valid = valid.to(values.dtype)
    return (torch.sum(values * valid, dim=-1)
            / torch.clamp(torch.sum(valid, dim=-1), min=1.0))


def f1_at_k(labels: torch.Tensor, ks: torch.Tensor,
            valid: torch.Tensor | None = None) -> torch.Tensor:
    """Batch-mean F1 at per-row cuts `ks` (1-based); with a leading member
    axis, (K, B, L) labels and (K, B) cuts, each member's mean (K,)."""
    return _masked_mean(_gather_at_k(f1_curve(labels), ks), valid)


def dcg_at_k(labels: torch.Tensor, ks: torch.Tensor, penalty: float = -1.0,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Batch-mean penalized DCG at per-row cuts `ks`; per member as
    `f1_at_k`."""
    return _masked_mean(_gather_at_k(dcg_curve(labels, penalty), ks), valid)


def decode_cut(scores: torch.Tensor) -> torch.Tensor:
    """k = argmax over positions + 1, for (B, L) or (B, L, 1) distributions.
    The Predictor hands the decoders float32 outputs in either compute dtype
    (a bf16 model's are cast back first, as the JAX package's are); equal
    maxima, which bf16's rounding makes common, go to the first position,
    as with jnp.argmax."""
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


# ---------------------------------------------------------------------------
# Auxiliary-task metrics (the verification harnesses)
# ---------------------------------------------------------------------------

def taskr_metric(labels: torch.Tensor, predictions: torch.Tensor,
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """Rerank DCG: each list re-sorted by its predicted scores, descending
    (a stable sort of -predictions, so that ties keep the list's order as
    the JAX package's `argsort(-p, stable=True)` does), each document adding
    +1/log2(i+2) if relevant and -1/log2(i+2) if not. Batch mean."""
    if predictions.dim() == 3:
        predictions = predictions[..., 0]
    order = torch.sort(-predictions, dim=-1, stable=True).indices
    sorted_labels = torch.gather(labels.to(torch.float32), -1, order)
    coef = dcg_discount(labels.shape[-1], device=labels.device)
    per_row = torch.sum(torch.where(sorted_labels == 1.0, 1.0, -1.0) / coef, dim=-1)
    return _masked_mean(per_row, valid)


def taskc_metric(labels: torch.Tensor, predictions: torch.Tensor,
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean per-query ROC-AUC, exact: the pairwise statistic over
    (relevant, irrelevant) pairs with 0.5 credit for tied scores, which
    equals sklearn's roc_auc_score on binary labels. Queries with no pair
    (all relevant or all irrelevant) and invalid rows are left out. One
    (B, L, L) comparison on the device, no host sync."""
    if predictions.dim() == 3:
        predictions = predictions[..., 0]
    labels = labels.to(torch.float32)
    pos = labels == 1.0
    pair_mask = (pos[:, :, None] & ~pos[:, None, :]).to(torch.float32)
    s_i, s_j = predictions[:, :, None], predictions[:, None, :]
    credit = (s_i > s_j).to(torch.float32) + 0.5 * (s_i == s_j).to(torch.float32)
    n_pairs = torch.sum(pair_mask, dim=(1, 2))
    aucs = torch.sum(credit * pair_mask, dim=(1, 2)) / torch.clamp(n_pairs, min=1.0)
    keep = n_pairs > 0
    if valid is not None:
        keep = keep & valid.to(torch.bool)
    keep = keep.to(torch.float32)
    return torch.sum(aucs * keep) / torch.clamp(torch.sum(keep), min=1.0)


# ---------------------------------------------------------------------------
# Classical baselines, read off the same metric curves
# ---------------------------------------------------------------------------

def oracle_score(labels: torch.Tensor, metric: str = "f1") -> torch.Tensor:
    """Each query's best value over every cut, batch mean: the upper bound."""
    return torch.mean(torch.max(reward_matrix(labels, metric), dim=-1).values)


def greedy_k(train_labels: torch.Tensor, metric: str = "f1") -> torch.Tensor:
    """The one k (1-based) that maximises the mean train curve; the first
    of equal maxima."""
    return torch.argmax(torch.mean(reward_matrix(train_labels, metric), dim=0)) + 1


def fixed_k_score(labels: torch.Tensor, k: int, metric: str = "f1") -> torch.Tensor:
    """Batch-mean metric at one fixed cut k."""
    ks = torch.full((labels.shape[0],), k, dtype=torch.int64, device=labels.device)
    return torch.mean(_gather_at_k(reward_matrix(labels, metric), ks))
