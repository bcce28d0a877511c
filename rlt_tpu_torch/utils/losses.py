"""Truncation losses of the training path, in PyTorch.

The counterpart of the JAX package's `utils/losses.py` for MMOECut's
criterion: `mtcut_loss` (the cut head's JS divergence to the augmented
reward distribution, a rerank hinge and a binary cross-entropy) and its
parts. Gradients come from autograd. Every loss takes an optional `valid`
(B,) row mask: padded rows of a ragged final batch contribute nothing, and
every division by the batch size uses the true row count. `bicut_loss`,
`choopy_loss`, `attncut_loss` and `wass_dist_loss` come with their models'
slices (ROADMAP.md).
"""

from __future__ import annotations

import torch

from rlt_tpu_torch.utils.metrics import reward_matrix

_TINY = 1e-30  # guards log(0) -> -inf, as in the JAX package
_TAU = 0.85  # temperature of the augmented reward distribution


def _squeeze_last(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] if x.dim() == 3 else x


def _row_weights(batch: int, valid: torch.Tensor | None, device):
    if valid is None:
        return (torch.ones(batch, dtype=torch.float32, device=device),
                torch.tensor(float(batch), device=device))
    w = valid.to(torch.float32)
    return w, torch.clamp(torch.sum(w), min=1.0)


def _kl_batchmean(log_input: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
                  n: torch.Tensor) -> torch.Tensor:
    """torch.nn.KLDivLoss(reduction='batchmean')(log_input, target) with a
    row mask."""
    pointwise = target * (torch.log(torch.clamp(target, min=_TINY)) - log_input)
    return torch.sum(torch.sum(pointwise, dim=-1) * w) / n


def div_loss(output: torch.Tensor, labels: torch.Tensor, *, metric: str = "f1",
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """JS divergence of the cut distribution p from the augmented reward
    distribution q = softmax(r / 0.85): (KL(m -> q) + KL(m -> p)) / 2
    through the log-mean m = (p + q) / 2."""
    p = _squeeze_last(output)
    q = torch.softmax(reward_matrix(labels, metric) / _TAU, dim=-1)
    w, n = _row_weights(p.shape[0], valid, p.device)
    log_mean = torch.log(torch.clamp((p + q) / 2.0, min=_TINY))
    return (_kl_batchmean(log_mean, q, w, n) + _kl_batchmean(log_mean, p, w, n)) / 2.0


def rerank_loss(output: torch.Tensor, labels: torch.Tensor, *,
                margin: float = 5e-4,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """max(0, mean(p[irrelevant]) - mean(p[relevant]) + margin) over the
    whole batch; 0 when the batch has no positives or no negatives."""
    p = _squeeze_last(output)
    labels = labels.to(torch.float32)
    w, _ = _row_weights(p.shape[0], valid, p.device)
    rele = (labels == 1.0).to(torch.float32) * w[:, None]
    irre = (labels == 0.0).to(torch.float32) * w[:, None]
    n_rele, n_irre = torch.sum(rele), torch.sum(irre)
    pos_mean = torch.sum(rele * p) / torch.clamp(n_rele, min=1.0)
    neg_mean = torch.sum(irre * p) / torch.clamp(n_irre, min=1.0)
    hinge = torch.clamp(neg_mean - pos_mean + margin, min=0.0)
    return torch.where((n_rele == 0) | (n_irre == 0), torch.zeros_like(hinge), hinge)


def bce_loss(output: torch.Tensor, labels: torch.Tensor, *,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Binary cross-entropy, mean over valid rows and positions. Each log
    term is clamped at -100 in the forward, as torch's BCELoss does, and a
    saturated element (p == 0 or 1 exactly) takes a zero gradient, as in the
    JAX package (torch's BCELoss backward would give ~1e12 there)."""
    p = _squeeze_last(output)
    y = labels.to(torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    q = 1.0 - p
    neg_inf = torch.tensor(-float("inf"), device=p.device)
    log_p = torch.clamp(torch.where(p <= 0.0, neg_inf,
                                    torch.log(torch.clamp(p, min=tiny))), min=-100.0)
    log_1mp = torch.clamp(torch.where(q <= 0.0, neg_inf,
                                      torch.log(torch.clamp(q, min=tiny))), min=-100.0)
    pointwise = -(y * log_p + (1.0 - y) * log_1mp)
    w, n = _row_weights(p.shape[0], valid, p.device)
    return torch.sum(torch.sum(pointwise, dim=-1) * w) / (n * p.shape[-1])


def mtcut_loss(outputs: list[torch.Tensor], labels: torch.Tensor, *,
               metric: str = "f1", rerank_weight: float = 0.5,
               classi_weight: float = 0.5, num_tasks: float = 3,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """cut (JS divergence, augmented) + weighted rerank hinge + weighted BCE.
    num_tasks picks the heads: 3 -> [class, rerank, cut], 2.1 -> [class,
    cut], 2.2 -> [rerank, cut]. All tasks share the binary labels."""
    if num_tasks == 3:
        pred_y, rerank_y, cut_y = outputs
    elif num_tasks == 2.1:
        pred_y, cut_y = outputs
        rerank_y = None
    else:
        rerank_y, cut_y = outputs
        pred_y = None
    total = div_loss(cut_y, labels, metric=metric, valid=valid)
    if rerank_y is not None:
        total = total + rerank_weight * rerank_loss(rerank_y, labels, valid=valid)
    if pred_y is not None:
        total = total + classi_weight * bce_loss(pred_y, labels, valid=valid)
    return total
