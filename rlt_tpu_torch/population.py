"""Population training: K trials of one model trained as one program (the
JAX package's `population.py`).

A hyper-parameter search or a multi-seed sweep is K full training runs.
Each run's products are small (B = 63 lists), so K runs one after another
leave the card mostly idle. The JAX package stacks the K trials on a
leading member axis and `jax.vmap`s its training program; under the vmap
its Pallas LSTM kernels become kernels over the members. The port writes
the member axis out (`torch.func.vmap` cannot pass the kernels'
`autograd.Function`s, and gives no per-member generators):
`models.build_population_model` stacks K seeded models into one whose every
leaf leads with K, and one step of the population is one forward, one
backward and one update of that model:

- the BiLSTM's two layers launch K1' (forward) and K2' (backward) once each
  over the 2K directions of all members (ndir = 2K), not 2K times;
- the expert stack runs the K * E experts as one stack, so K5' and K6'
  launch once per forward and step over K * E * B attention rows;
- the loss is the sum over members of each member's own mean loss
  (`utils.losses.member_losses`), so each member's gradient is exactly its
  own;
- `MemberAdam` is torch's Adam with coupled L2 (`train.make_optimizer`)
  with a learning rate and a weight decay per member.

Member m reproduces the sequential `Trainer` run at its own config: the
same initial weights (`build_model(..., seed=m.seed)`), the same corpus
(regenerated from its seed, unless one is given), and its own
`torch.Generator` seeded with m.seed, from which its batch plans and every
dropout seed and mask are drawn in the order its sequential run draws
them. So its random bits are its sequential run's bits (the port's own
contract: the bits are torch's, not JAX's threefry), and its numbers differ
from the sequential run's by the order of float32 sums alone.

Scope (ROADMAP.md A1): MMOECut in float32, the members sharing one dropout
rate. A per-member dropout rate needs per-row keep thresholds in K5'/K6'
(the JAX package takes it off its kernels), and the other models and bf16
are the next slices; each raises a ValueError that names it.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Sequence

import numpy as np
import torch

from rlt_tpu_torch import config as config_lib
from rlt_tpu_torch.data import load_pkl_dataset, synthetic_config, synthetic_dataset
from rlt_tpu_torch.data.batching import epoch_permutation
from rlt_tpu_torch.models import build_population_model, check_population_model
from rlt_tpu_torch.train import batch_metrics, make_criterion
from rlt_tpu_torch.utils import losses as losses_lib
from rlt_tpu_torch.utils.platform import resolve_device

logger = logging.getLogger("rlt_tpu_torch")

BETAS, EPS = (0.9, 0.999), 1e-8  # train.make_optimizer's


@dataclasses.dataclass(frozen=True)
class Member:
    """One population member; None fields inherit the base TrainConfig.

    A member with only `seed` set reproduces `Trainer` at that seed (the
    multi-seed sweep protocol); the other fields are the reference's search
    axes (run.py:349-364)."""

    seed: int = 0
    lr: float | None = None
    weight_decay: float | None = None
    dropout: float | None = None
    rerank_weight: float | None = None
    class_weight: float | None = None


class MemberAdam:
    """torch's Adam with coupled L2 (`train.make_optimizer`) over parameters
    whose leading axis is the member axis, with a learning rate and a weight
    decay per member. Each update takes the ops of torch's single-tensor
    Adam in its order: g + wd p, the first moment's lerp, the second's
    mul-addcmul, the bias corrections, sqrt(v) / sqrt(bc2) + eps, and p
    minus (lr / bc1) m / denom, with lr / bc1 taken in double and rounded
    once, as torch rounds its scalar step size."""

    def __init__(self, params, lrs: Sequence[float], weight_decays: Sequence[float]):
        self.params = [p for p in params if p.requires_grad]
        self.lrs = [float(v) for v in lrs]
        k = len(self.lrs)
        if len(weight_decays) != k or any(p.shape[0] != k for p in self.params):
            raise ValueError(f"MemberAdam: {k} learning rates, {len(weight_decays)} "
                             "weight decays, and every parameter must lead with them")
        device = self.params[0].device
        self._wd = torch.tensor([float(v) for v in weight_decays], device=device)
        self.step_count = 0
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    @staticmethod
    def _per_member(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return values.view((-1,) + (1,) * (like.dim() - 1))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        beta1, beta2 = BETAS
        self.step_count += 1
        bc1 = 1 - beta1 ** self.step_count
        bc2_sqrt = (1 - beta2 ** self.step_count) ** 0.5
        neg_step = torch.tensor([-lr / bc1 for lr in self.lrs], dtype=torch.float32,
                                device=self._wd.device)
        for p, m, v in zip(self.params, self.exp_avg, self.exp_avg_sq):
            grad = p.grad.addcmul(p, self._per_member(self._wd, p))
            m.lerp_(grad, 1 - beta1)
            v.mul_(beta2).addcmul_(grad, grad, value=1 - beta2)
            denom = (v.sqrt() / bc2_sqrt).add_(EPS)
            p.addcdiv_(m * self._per_member(neg_step, p), denom)


def _member_corpora(cfg: config_lib.TrainConfig, members: Sequence[Member], data) -> list:
    """Each member's corpus, as `Trainer` would load it at the member's seed:
    a list of datasets is taken member for member, one dataset is shared,
    a pkl root is read once and shared, and the synthetic corpus is
    regenerated from each member's seed (the JAX package's rule)."""
    if isinstance(data, (list, tuple)):
        if len(data) != len(members):
            raise ValueError(f"{len(data)} datasets for {len(members)} members")
        return list(data)
    if data is not None:
        return [data] * len(members)
    if cfg.dataset_base:
        family = config_lib.loader_family(cfg.model_name, cfg.retrieve_data)
        shared = load_pkl_dataset(cfg.dataset_base, cfg.retrieve_data,
                                  cfg.dataset_name, family)
        return [shared] * len(members)
    by_seed = {seed: synthetic_dataset(
        num_queries=cfg.synthetic_queries, seq_len=cfg.seq_len,
        num_features=cfg.input_size, seed=seed,
        **synthetic_config(cfg.retrieve_data, cfg.dataset_name))
        for seed in {m.seed for m in members}}
    return [by_seed[m.seed] for m in members]


def _stack_corpora(corpora: Sequence, device) -> dict[str, torch.Tensor]:
    """The member corpora's splits stacked on a leading member axis, on
    `device`; their shapes must agree (synthetic corpora always do)."""
    shapes = {tuple(np.shape(c.x_train)) + tuple(np.shape(c.x_test)) for c in corpora}
    if len(shapes) != 1:
        raise ValueError(f"member corpora disagree on shape: {sorted(shapes)}")
    return {split: torch.as_tensor(np.stack([np.asarray(getattr(c, split), np.float32)
                                             for c in corpora])).to(device)
            for split in ("x_train", "y_train", "x_test", "y_test")}


def check_population(cfg: config_lib.TrainConfig, members: Sequence[Member]) -> None:
    """Raise a ValueError for what the population engine does not run."""
    check_population_model(cfg.model_name)
    if cfg.compute_dtype != "float32":
        raise ValueError(f"population training runs in float32, not "
                         f"{cfg.compute_dtype!r}: the bf16 population is ROADMAP.md "
                         "A1's next slice")
    if any(m.dropout is not None and m.dropout != cfg.dropout for m in members):
        raise ValueError(
            f"every member trains at the config's dropout {cfg.dropout}: a dropout "
            "rate per member needs per-row keep thresholds in K5'/K6' (ROADMAP.md "
            "B5), where the JAX package takes its population off the kernels")
    if any(m.rerank_weight is not None or m.class_weight is not None for m in members):
        raise ValueError(
            f"rerank/class weights only search ('mtchoopy', 'mtattncut') "
            f"(run.py:79/:84); {cfg.model_name!r}'s criterion would silently ignore "
            "them")


def _summary(member: Member, f1: list, dcg: list) -> dict:
    """`Trainer.summary`'s keys for one member, and its hyper-parameters."""
    return {"member": dataclasses.asdict(member),
            "best_f1": max(f1), "best_dcg": max(dcg),
            "best5_f1": float(np.mean(sorted(f1, reverse=True)[:5])),
            "best5_dcg": float(np.mean(sorted(dcg, reverse=True)[:5])),
            "compute_dtype": "float32"}


class Population:
    """K members of one model on one device: the stacked model, MemberAdam,
    the stacked corpora, one generator per member, and per-member records.
    `run_epoch` is one epoch of every member, as `train.Trainer.run_epoch`
    is one of a Trainer."""

    def __init__(self, cfg: config_lib.TrainConfig, members: Sequence[Member],
                 data=None, device: str | torch.device | None = None):
        members = list(members)
        if not members:
            raise ValueError("empty population")
        check_population(cfg, members)
        self.cfg, self.members = cfg, members
        self.device = resolve_device(device)
        self.criterion = make_criterion(cfg)
        self.data = _stack_corpora(_member_corpora(cfg, members, data), self.device)
        self.model = build_population_model(
            cfg.model_name, seq_len=cfg.seq_len, input_size=cfg.input_size,
            dropout=cfg.dropout, num_tasks=cfg.num_tasks,
            seeds=[m.seed for m in members]).to(self.device)
        self.optimizer = MemberAdam(
            self.model.parameters(),
            [cfg.lr if m.lr is None else m.lr for m in members],
            [cfg.weight_decay if m.weight_decay is None else m.weight_decay
             for m in members])
        self.generators = [torch.Generator(device=self.device).manual_seed(m.seed)
                           for m in members]
        self.history: list[list[dict]] = [[] for _ in members]

    @property
    def size(self) -> int:
        return len(self.members)

    def plans(self, split: str):
        """Each member's batch plan of `split` from its own generator,
        stacked: idx (K, batches, B) and valid (K, batches, B)."""
        n = self.data[f"x_{split}"].shape[1]
        plans = [epoch_permutation(g, n, self.cfg.batch_size) for g in self.generators]
        return torch.stack([p[0] for p in plans]), torch.stack([p[1] for p in plans])

    def batch(self, split: str, idx: torch.Tensor):
        """Member m's lists idx[m] of its own `split`: (K, B, L, F) features
        and (K, B, L) labels."""
        rows = torch.arange(self.size, device=self.device)[:, None]
        return self.data[f"x_{split}"][rows, idx], self.data[f"y_{split}"][rows, idx]

    def _metrics(self, output, y, valid) -> torch.Tensor:
        """(K, 2): each member's F1 and DCG at its decoded cuts."""
        return torch.stack([torch.stack(batch_metrics(
            self.cfg.model_name, [h[m] for h in output], y[m], valid[m]))
            for m in range(self.size)])

    def train_step(self, x, y, valid):
        """One update of every member: (K,) losses and (K, 2) F1/DCG of the
        pre-update forward, as `train.train_step` gives one member's."""
        self.model.train()
        self.optimizer.zero_grad()
        output = self.model(x, self.generators)
        losses = losses_lib.member_losses(self.criterion, output, y, valid)
        losses.sum().backward()
        self.optimizer.step()
        with torch.no_grad():
            return losses.detach(), self._metrics(output, y, valid)

    @torch.no_grad()
    def eval_step(self, x, y, valid):
        self.model.eval()
        output = self.model(x)
        return (losses_lib.member_losses(self.criterion, output, y, valid),
                self._metrics(output, y, valid))

    def run_epoch(self) -> list[dict]:
        """Every train batch of every member, then each member's test split:
        per member the metrics `train.Trainer.run_epoch` gives (the means of
        the batch means, and the per-step train losses)."""
        tr_idx, tr_valid = self.plans("train")
        te_idx, te_valid = self.plans("test")
        train = [self.train_step(*self.batch("train", tr_idx[:, s]), tr_valid[:, s])
                 for s in range(tr_idx.shape[1])]
        test = [self.eval_step(*self.batch("test", te_idx[:, s]), te_valid[:, s])
                for s in range(te_idx.shape[1])]
        out = []
        for part in (train, test):  # (steps, K, 3): loss, f1, dcg
            out.append(torch.stack([torch.cat([loss[:, None], m], dim=1)
                                    for loss, m in part]).cpu().numpy().astype(np.float64))
        tr, te = out
        epochs = []
        for m in range(self.size):
            metrics = {f"{split}_{name}": float(np.mean(values[:, m, i]))
                       for split, values in (("train", tr), ("test", te))
                       for i, name in enumerate(("loss", "f1", "dcg"))}
            metrics["train_loss_steps"] = tr[:, m, 0].tolist()
            self.history[m].append(metrics)
            epochs.append(metrics)
        return epochs


def train_population(cfg: config_lib.TrainConfig, members: Sequence[Member],
                     data=None, track_best_params: bool = False,
                     chunk_size: int | None = None,
                     device: str | torch.device | None = None) -> dict:
    """Train every member for `cfg.epochs` epochs as one program; return
    per-member summaries.

    data: None (each member's synthetic corpus from its seed, or a shared
    pkl corpus, as `Trainer` loads it), one RankedListData (shared), or a
    list of per-member RankedListData.

    chunk_size: when set and K > chunk_size, the population runs as
    ceil(K / chunk_size) populations of at most chunk_size members, one
    after another, with the same per-member results (members interact only
    through the stacked axis) and less device memory.

    Returns {"per_member": [Trainer.summary's keys, the member's
    hyper-parameters under "member", and its epochs' metrics under
    "history"], "f1_record": (K, epochs), "dcg_record": (K, epochs)[,
    "best_state": the stacked state_dict of each member's best test F1
    epoch, with track_best_params]}. Runs on the card unless `device` is
    "cpu"."""
    members = list(members)
    if not members:
        raise ValueError("empty population")
    if chunk_size is not None:
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if len(members) > chunk_size:
            check_population(cfg, members)
            chunks = [train_population(
                cfg, members[i:i + chunk_size],
                data=data[i:i + chunk_size] if isinstance(data, (list, tuple)) else data,
                track_best_params=track_best_params, device=device)
                for i in range(0, len(members), chunk_size)]
            out: dict[str, Any] = {
                "per_member": [r for c in chunks for r in c["per_member"]],
                "f1_record": np.concatenate([c["f1_record"] for c in chunks]),
                "dcg_record": np.concatenate([c["dcg_record"] for c in chunks])}
            if track_best_params:
                out["best_state"] = {k: torch.cat([c["best_state"][k] for c in chunks])
                                     for k in chunks[0]["best_state"]}
            return out

    pop = Population(cfg, members, data=data, device=device)
    best_state = None
    if track_best_params:
        best_state = {k: v.detach().clone() for k, v in pop.model.state_dict().items()}
    best_f1 = np.full(pop.size, -np.inf)
    start = time.perf_counter()
    for epoch in range(cfg.epochs):
        metrics = pop.run_epoch()
        f1 = np.array([m["test_f1"] for m in metrics])
        if track_best_params:
            improved = torch.as_tensor(f1 > best_f1, device=pop.device)
            for k, v in pop.model.state_dict().items():
                pick = improved.view((-1,) + (1,) * (v.dim() - 1))
                best_state[k] = torch.where(pick, v, best_state[k])
        best_f1 = np.maximum(best_f1, f1)
        logger.info("population epoch %d: test f1 %s", epoch, f1.tolist())
    logger.info("population of %d x %d epochs in %.2fs", pop.size, cfg.epochs,
                time.perf_counter() - start)
    f1_rec = np.array([[h["test_f1"] for h in hist] for hist in pop.history])
    dcg_rec = np.array([[h["test_dcg"] for h in hist] for hist in pop.history])
    per_member = [dict(_summary(m, f1_rec[i].tolist(), dcg_rec[i].tolist()),
                       history=pop.history[i]) for i, m in enumerate(members)]
    out = {"per_member": per_member, "f1_record": f1_rec, "dcg_record": dcg_rec}
    if track_best_params:
        out["best_state"] = best_state
    return out
