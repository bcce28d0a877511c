"""Truncation losses in PyTorch.

The counterpart of the JAX package's `utils/losses.py`, loss for loss:
`bicut_loss`, `choopy_loss`, `attncut_loss`, `div_loss` (KL or JS, to the
reward distribution at temperature tau or 1), `rerank_loss`, `bce_loss`,
`mtcut_loss` (the multi-task sum) and `wass_dist_loss` (Sinkhorn), with
the registry `LOSSES` and `make_loss`. Gradients come from autograd. Every
loss takes an optional `valid` (B,) row mask: padded rows of a ragged final
batch contribute nothing, and every division by the batch size uses the
true row count. `member_losses` applies a criterion member by member to
a population's stacked outputs (`rlt_tpu_torch/population.py`).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from rlt_tpu_torch.utils.metrics import dcg_discount, reward_matrix

_TINY = 1e-30  # guards log(0) -> -inf, as in the JAX package


def _squeeze_last(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] if x.dim() == 3 else x


def _row_weights(batch: int, valid: torch.Tensor | None, device):
    if valid is None:
        return (torch.ones(batch, dtype=torch.float32, device=device),
                torch.full((), float(batch), device=device))
    w = valid.to(torch.float32)
    return w, torch.clamp(torch.sum(w), min=1.0)


def _kl_batchmean(log_input: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
                  n: torch.Tensor) -> torch.Tensor:
    """torch.nn.KLDivLoss(reduction='batchmean')(log_input, target) with a
    row mask."""
    pointwise = target * (torch.log(torch.clamp(target, min=_TINY)) - log_input)
    return torch.sum(torch.sum(pointwise, dim=-1) * w) / n


def bicut_loss(output: torch.Tensor, labels: torch.Tensor, *, metric: str = "nci",
               alpha: float = 0.65, r: float = 0.0971134020,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-position {truncate, continue} reward loss of BiCut's (B, L, 2)
    decision probabilities. Positions after the row's last truncate
    decision are masked out (none when every position says continue; the
    last one is found by argmin over the flipped decisions, whose tie rule,
    the first index, torch shares with JAX). Rewards per position:
    'nci': relevant [0, -1/log2(j+2)], irrelevant [0, (j+1)/alpha]; any
    other metric: relevant [(1-alpha)/r, 0], irrelevant [0, alpha/(1-r)].
    loss = sum(output * mask * reward) / batch."""
    batch, seq_len, _ = output.shape
    labels = labels.to(torch.float32)
    decisions = torch.argmax(output, dim=-1)  # (B, L) in {0, 1}
    all_continue = torch.sum(decisions, dim=-1) == seq_len
    last_trunc = seq_len - 1 - torch.argmin(torch.flip(decisions, dims=(-1,)), dim=-1)
    cut_idx = torch.where(all_continue, seq_len, last_trunc)  # keep j <= cut_idx
    positions = torch.arange(seq_len, device=output.device)
    mask = (positions[None, :] <= cut_idx[:, None]).to(torch.float32)
    if metric == "nci":
        j1 = positions.to(torch.float32) + 1.0
        coef = dcg_discount(seq_len, device=output.device)
        rew_trunc = torch.zeros_like(labels)
        rew_cont = torch.where(labels == 1.0, -1.0 / coef, j1 / alpha)
    else:
        zero = torch.zeros_like(labels)
        rew_trunc = torch.where(labels == 1.0, (1.0 - alpha) / r, zero)
        rew_cont = torch.where(labels == 1.0, zero, alpha / (1.0 - r))
    reward = torch.stack([rew_trunc, rew_cont], dim=-1)  # (B, L, 2)
    w, n = _row_weights(batch, valid, output.device)
    per_row = torch.sum(output * mask[:, :, None] * reward, dim=(1, 2))
    return torch.sum(per_row * w) / n


def choopy_loss(output: torch.Tensor, labels: torch.Tensor, *, metric: str = "f1",
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Negative expected reward: -sum(p * r) / batch."""
    p = _squeeze_last(output)
    w, n = _row_weights(p.shape[0], valid, p.device)
    return -torch.sum(torch.sum(p * reward_matrix(labels, metric), dim=-1) * w) / n


def _target_distribution(labels: torch.Tensor, metric: str, tau: float) -> torch.Tensor:
    """q = softmax(reward / tau) row-wise."""
    return torch.softmax(reward_matrix(labels, metric) / tau, dim=-1)


def attncut_loss(output: torch.Tensor, labels: torch.Tensor, *, metric: str = "f1",
                 tau: float = 0.95,
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """Soft cross-entropy to the reward distribution: -sum(q log p) / batch."""
    p = _squeeze_last(output)
    q = _target_distribution(labels, metric, tau)
    w, n = _row_weights(p.shape[0], valid, p.device)
    per_row = torch.sum(q * torch.log(torch.clamp(p, min=_TINY)), dim=-1)
    return -torch.sum(per_row * w) / n


def div_loss(output: torch.Tensor, labels: torch.Tensor, *, metric: str = "f1",
             tau: float = 0.85, div_type: str = "kl", augmented: bool = True,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Divergence of the cut distribution p from the reward distribution
    q = softmax(r / tau), tau = `tau` when augmented else 1. 'kl': KL(q || p)
    batchmean; 'js': (KL(m -> q) + KL(m -> p)) / 2 through the log-mean
    m = (p + q) / 2."""
    p = _squeeze_last(output)
    q = _target_distribution(labels, metric, tau if augmented else 1.0)
    w, n = _row_weights(p.shape[0], valid, p.device)
    if div_type == "kl":
        return _kl_batchmean(torch.log(torch.clamp(p, min=_TINY)), q, w, n)
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
    neg_inf = torch.full((), -float("inf"), device=p.device)
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
    total = div_loss(cut_y, labels, metric=metric, div_type="js", augmented=True,
                     valid=valid)
    if rerank_y is not None:
        total = total + rerank_weight * rerank_loss(rerank_y, labels, valid=valid)
    if pred_y is not None:
        total = total + classi_weight * bce_loss(pred_y, labels, valid=valid)
    return total


def wass_dist_loss(output: torch.Tensor, labels: torch.Tensor, *, eps: float = 1e-3,
                   max_iter: int = 100, threshold: float = 1e-1,
                   reduction: str = "mean",
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Entropy-regularised OT distance between the B prediction rows and the
    B label rows as two clouds of B points in R^L: one squared-L2 (B, B) cost
    and uniform marginals (padded rows get none). Log-domain Sinkhorn runs a
    fixed `max_iter` steps and freezes u and v once the u-increment falls
    below `threshold`, as the JAX package's scan does: the freeze is a
    `torch.where` on a device-side flag, so the loop never reads a value
    back to the host, and the gradient takes the JAX package's path."""
    del reduction  # kept for the reference's signature; the cost is a scalar
    p = _squeeze_last(output)
    y = labels.to(p.dtype)
    cost = torch.sum(torch.abs(p[:, None, :] - y[None, :, :]) ** 2, dim=-1)  # (B, B)
    n_pts = cost.shape[0]
    if valid is None:
        mu = torch.full((n_pts,), 1.0 / n_pts, dtype=cost.dtype, device=p.device)
    else:
        w = valid.to(cost.dtype)
        mu = w / torch.clamp(torch.sum(w), min=1.0)
    log_mu = torch.log(mu + 1e-8)  # nu = mu

    def modified_cost(u, v):
        return (-cost + u[:, None] + v[None, :]) / eps

    u = torch.zeros_like(mu)
    v = torch.zeros_like(mu)
    done = torch.zeros((), dtype=torch.bool, device=p.device)
    for _ in range(max_iter):
        u_new = eps * (log_mu - torch.logsumexp(modified_cost(u, v), dim=-1)) + u
        v_new = eps * (log_mu - torch.logsumexp(modified_cost(u_new, v).T, dim=-1)) + v
        err = torch.sum(torch.abs(u_new - u))
        u, v = torch.where(done, u, u_new), torch.where(done, v, v_new)
        done = done | (err < threshold)
    return torch.sum(torch.exp(modified_cost(u, v)) * cost)


def member_losses(criterion: Callable, output, labels: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """(K,) losses of K population members: `criterion` on member m's slice
    of every head (a list of (K, B, L, 1) heads, or one (K, ...) tensor),
    labels[m] and valid[m]. Each is the member's own mean over its rows,
    so their sum, the population's loss, gives each member exactly its own
    gradient (a mean over the K * B rows would scale each by 1 / K)."""
    heads = isinstance(output, (list, tuple))
    return torch.stack([
        criterion([h[m] for h in output] if heads else output[m], labels[m],
                  valid=valid[m])
        for m in range(labels.shape[0])])


# the criterion registry of the JAX package (its `LOSSES`)
LOSSES: dict[str, Callable] = {
    "bicut": bicut_loss,
    "choopy": choopy_loss,
    "attncut": attncut_loss,
    "div": div_loss,
    "rerank": rerank_loss,
    "bce": bce_loss,
    "mtcut": mtcut_loss,
    "wass": wass_dist_loss,
}


def make_loss(name: str, **kwargs) -> Callable:
    """`loss(output, labels, valid=None) -> scalar` configured with kwargs."""
    return functools.partial(LOSSES[name], **kwargs)
