"""Population training: K trials of one model trained as one program (the
JAX package's `population.py`).

A hyper-parameter search or a multi-seed sweep is K full training runs.
Each run's products are small (B = 63 lists), so K runs one after another
leave the card mostly idle. The JAX package stacks the K trials on a
leading member axis and `jax.vmap`s its training program; under the vmap
its Pallas LSTM kernels become kernels over the members. The port writes
the member axis out (`torch.func.vmap` cannot pass the kernels'
`autograd.Function`s, and gives no per-member generators):
`models.build_population_model` stacks K seeded models of any of the eight
into one whose every leaf leads with K, and one step of the population is
one forward, one backward and one update of that model:

- the BiLSTM's two layers launch K1' (forward) and K2' (backward) once each
  over the 2K directions of all members (ndir = 2K), not 2K times;
- the attention runs all members' rows in one launch per encoder layer:
  K5'/K6' over K * E * B rows (MMOECut's and MOECut's expert stacks) or K
  * B rows (AttnCut's, MtAttnCut's, Choopy's and MtChoopy's encoders), and
  K3'/K4' over PLECut's K * E * B * H slices;
- the loss is the sum over members of each member's own mean loss under
  its own criterion (`utils.losses.member_losses`; an mt search's members
  differ in their task weights), so each member's gradient is exactly its
  own;
- `MemberAdam` is torch's capturable Adam with coupled L2
  (`train.make_optimizer`) with a learning rate and a weight decay per
  member;
- members may differ in their dropout rate (a regularizer search; the JAX
  package's traced `hp["dropout_rate"]`): the model's layers then hold the
  K rates as device tensors (`models.layers.MemberRates`), the attention
  kernels take a keep threshold and a scale per row (K3'-K6''s per-row
  form, `ops.attention.RowDropout`), and every other dropout site each
  member's own 16-bit threshold and 1 / keep.

In bfloat16 (`cfg.compute_dtype`) a step casts the f32 master parameters
and the features inside the step, as `train.forward` does for a Trainer,
and the kernels run their bf16 instances; losses and metrics stay f32. On
the card each population train step and test step is one CUDA graph
(`utils.graphs.GraphedSteps`, the counterpart of the JAX package's
`jax.jit(jax.vmap(...))`), the members' generators registered with it;
the epoch's batch plans are drawn eager, as a Trainer draws them.

Member m reproduces the sequential `Trainer` run at its own config: the
same initial weights (`build_model(..., seed=m.seed)`), the same corpus
(regenerated from its seed, unless one is given), and its own
`torch.Generator` seeded with m.seed, from which its batch plans and every
dropout seed and mask are drawn in the order its sequential run draws
them, at its own rate (a member at rate 0 draws none, as its run draws
none). So its random bits are its sequential run's bits (the port's own
contract: the bits are torch's, not JAX's threefry), and its numbers differ
from the sequential run's by the order of sums alone.

Scope (ROADMAP.md A1): all eight models in float32 and bfloat16, each
member at its own dropout rate. (Under a traced rate the JAX package
takes its attention off the Pallas kernels; the port keeps K3'-K6' and
gives them the rate per row.)
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
from rlt_tpu_torch.infer import COMPUTE_DTYPES, decode_ks
from rlt_tpu_torch.models import build_population_model, check_population_model
from rlt_tpu_torch.train import forward, make_criterion
from rlt_tpu_torch.utils import losses as losses_lib
from rlt_tpu_torch.utils import metrics as metrics_lib
from rlt_tpu_torch.utils.graphs import GraphedSteps, use_graphs
from rlt_tpu_torch.utils.platform import resolve_device

logger = logging.getLogger("rlt_tpu_torch")

BETAS, EPS = (0.9, 0.999), 1e-8  # train.make_optimizer's
# the models whose criterion takes the task weights a search draws
MT_SEARCH_MODELS = ("mtchoopy", "mtattncut")


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
    decay per member, in the op order of the Adam that the sequential
    `Trainer` runs on the same device. Its step count, learning rates and
    weight decays are tensors on the parameters' device. On a CUDA device
    the update takes the ops of torch's capturable (foreach) Adam, so that a
    CUDA graph holds the whole step: g + wd p, the first moment's lerp, the
    second's mul-addcmul, the step size -lr / (1 - beta1^t) and
    sqrt(1 - beta2^t) from the step count on the card, then (sqrt(v) /
    sqrt(1 - beta2^t) + eps) / step size as the denominator of p's addcdiv.
    On the CPU, those of torch's single-tensor Adam: the bias corrections
    in double on the host, sqrt(v) / sqrt(bc2) + eps, and p minus (lr /
    bc1) m / denom, with lr / bc1 taken in double and rounded once, as
    torch rounds its scalar step size. `state` holds each parameter's
    moments and the step count as `torch.optim.Adam`'s does
    (`utils.graphs.snapshot` reads it)."""

    def __init__(self, params, lrs: Sequence[float], weight_decays: Sequence[float]):
        self.params = [p for p in params if p.requires_grad]
        k = len(lrs)
        if len(weight_decays) != k or any(p.shape[0] != k for p in self.params):
            raise ValueError(f"MemberAdam: {k} learning rates, {len(weight_decays)} "
                             "weight decays, and every parameter must lead with them")
        device = self.params[0].device
        self._capturable = device.type == "cuda"
        self._lr = torch.tensor([float(v) for v in lrs], dtype=torch.float64)
        if self._capturable:
            self._lr = self._lr.to(device, torch.float32)
        self._wd = torch.tensor([float(v) for v in weight_decays], device=device)
        self._step = torch.zeros((), device=device)
        self.state = {p: {"step": self._step, "exp_avg": torch.zeros_like(p),
                          "exp_avg_sq": torch.zeros_like(p)} for p in self.params}

    @staticmethod
    def _per_member(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return values.view((-1,) + (1,) * (like.dim() - 1))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        beta1, beta2 = BETAS
        self._step += 1
        if self._capturable:
            # (beta1^t - 1) / lr, reciprocal: the step size -lr / (1 - beta1^t)
            step_size = torch.pow(beta1, self._step).sub_(1).div(self._lr).reciprocal_()
            bc2_sqrt = torch.pow(beta2, self._step).sub_(1).neg_().sqrt_()
        else:
            t = self._step.item()
            bc2_sqrt = (1 - beta2 ** t) ** 0.5
            neg_step = (-self._lr / (1 - beta1 ** t)).float()
        for p in self.params:
            s = self.state[p]
            m, v = s["exp_avg"], s["exp_avg_sq"]
            grad = p.grad.addcmul(p, self._per_member(self._wd, p))
            m.lerp_(grad, 1 - beta1)
            v.mul_(beta2).addcmul_(grad, grad, value=1 - beta2)
            if self._capturable:
                denom = v.sqrt().div_(bc2_sqrt).add_(EPS).div_(self._per_member(step_size, p))
                p.addcdiv_(m, denom)
            else:
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
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                         f"got {cfg.compute_dtype!r}")
    for m in members:
        rate = cfg.dropout if m.dropout is None else m.dropout
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"a member's dropout rate must lie in [0, 1), got {rate}")
    if any(m.rerank_weight is not None or m.class_weight is not None
           for m in members) and not (
            cfg.model_name in MT_SEARCH_MODELS and not cfg.loss_override):
        raise ValueError(
            f"rerank/class weights only search {MT_SEARCH_MODELS} (run.py:79/:84); "
            f"{cfg.model_name!r}'s criterion would silently ignore them")


def member_config(cfg: config_lib.TrainConfig, member: Member) -> config_lib.TrainConfig:
    """The config of member's sequential `Trainer` run: cfg with the
    member's seed and every field it sets."""
    overrides = {k: v for k, v in dataclasses.asdict(member).items() if v is not None}
    return dataclasses.replace(cfg, **overrides)


def _summary(cfg: config_lib.TrainConfig, member: Member, f1: list, dcg: list) -> dict:
    """`Trainer.summary`'s keys for one member, and its hyper-parameters."""
    return {"member": dataclasses.asdict(member),
            "best_f1": max(f1), "best_dcg": max(dcg),
            "best5_f1": float(np.mean(sorted(f1, reverse=True)[:5])),
            "best5_dcg": float(np.mean(sorted(dcg, reverse=True)[:5])),
            "compute_dtype": cfg.compute_dtype}


class Population:
    """K members of one model on one device: the stacked model, MemberAdam,
    the stacked corpora, one generator per member, each member's criterion
    and records. `run_epoch` is one epoch of every member, as
    `train.Trainer.run_epoch` is one of a Trainer, in `cfg.compute_dtype`.

    `graphs`: each population step one CUDA graph replay (the default on a
    CUDA device; `utils.graphs.GraphedSteps`, as `Trainer`'s), or eager
    (False: the CPU's only route; on the card for reference runs). Graphs
    on the CPU raise."""

    def __init__(self, cfg: config_lib.TrainConfig, members: Sequence[Member],
                 data=None, device: str | torch.device | None = None,
                 graphs: bool | None = None):
        members = list(members)
        if not members:
            raise ValueError("empty population")
        check_population(cfg, members)
        self.cfg, self.members = cfg, members
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self.device = resolve_device(device)
        self.graphs = graphs = use_graphs(self.device, graphs)
        self.criteria = [make_criterion(member_config(cfg, m)) for m in members]
        self.data = _stack_corpora(_member_corpora(cfg, members, data), self.device)
        self.model = build_population_model(
            cfg.model_name, seq_len=cfg.seq_len, input_size=cfg.input_size,
            dropout=[member_config(cfg, m).dropout for m in members],
            num_tasks=cfg.num_tasks, seeds=[m.seed for m in members]).to(self.device)
        self.optimizer = MemberAdam(
            self.model.parameters(),
            [cfg.lr if m.lr is None else m.lr for m in members],
            [cfg.weight_decay if m.weight_decay is None else m.weight_decay
             for m in members])
        self.generators = [torch.Generator(device=self.device).manual_seed(m.seed)
                           for m in members]
        self._rows = torch.arange(len(members), device=self.device)[:, None]
        self.history: list[list[dict]] = [[] for _ in members]
        self._graphed = GraphedSteps(
            self._train, self._test, (len(members), cfg.batch_size), self.device,
            params=self.model.parameters(), optimizer=self.optimizer,
            generators=self.generators) if graphs else None

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
        return (self.data[f"x_{split}"][self._rows, idx],
                self.data[f"y_{split}"][self._rows, idx])

    def _metrics(self, output, y, valid) -> torch.Tensor:
        """(K, 2): each member's F1 and DCG at its decoded cuts, decoded
        over the K * B rows at once and averaged over each member's valid
        rows."""
        k, b = y.shape[:2]
        flat = ([h.flatten(0, 1) for h in output] if isinstance(output, (list, tuple))
                else output.flatten(0, 1))
        ks = decode_ks(self.cfg.model_name, flat).view(k, b)
        return torch.stack([metrics_lib.f1_at_k(y, ks, valid=valid),
                            metrics_lib.dcg_at_k(y, ks, valid=valid)], dim=1)

    def _train(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """One update of every member on plan rows idx (K, B): (K, 3) loss,
        F1 and DCG of the pre-update forward, as `train.train_step` gives
        one member's."""
        self.model.train()
        self.optimizer.zero_grad()
        x, y = self.batch("train", idx)
        output = forward(self.model, x, self.generators, self.dtype)
        losses = losses_lib.member_losses(self.criteria, output, y, valid)
        losses.sum().backward()
        self.optimizer.step()
        with torch.no_grad():
            return torch.cat([losses.detach()[:, None], self._metrics(output, y, valid)],
                             dim=1)

    @torch.no_grad()
    def _test(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        x, y = self.batch("test", idx)
        output = forward(self.model, x, dtype=self.dtype)
        losses = losses_lib.member_losses(self.criteria, output, y, valid)
        return torch.cat([losses[:, None], self._metrics(output, y, valid)], dim=1)

    def _step(self, split: str, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if self._graphed is not None:
            return self._graphed(split, idx, valid)
        return (self._train if split == "train" else self._test)(idx, valid)

    def train_batch(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """One update of every member on its train plan row (idx, valid),
        each (K, B): (K, 3) loss, F1 and DCG of the pre-update forward, a
        tensor of its own."""
        return self._step("train", idx, valid)

    def test_batch(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(K, 3) loss, F1 and DCG of every member's test plan row (idx,
        valid) without dropout, a tensor of its own."""
        return self._step("test", idx, valid)

    def run_epoch(self) -> list[dict]:
        """Every train batch of every member, then each member's test split:
        per member the metrics `train.Trainer.run_epoch` gives (the means of
        the batch means, and the per-step train losses). The host fetches
        the epoch's results once."""
        tr_idx, tr_valid = self.plans("train")
        te_idx, te_valid = self.plans("test")
        train = [self.train_batch(tr_idx[:, s], tr_valid[:, s])
                 for s in range(tr_idx.shape[1])]
        test = [self.test_batch(te_idx[:, s], te_valid[:, s])
                for s in range(te_idx.shape[1])]
        # (steps, K, 3): loss, f1, dcg
        tr, te = (torch.stack(part).cpu().numpy().astype(np.float64)
                  for part in (train, test))
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
    "cpu", each step one CUDA graph there (each chunk a `Population` with
    graphs of its own)."""
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
    per_member = [dict(_summary(cfg, m, f1_rec[i].tolist(), dcg_rec[i].tolist()),
                       history=pop.history[i]) for i, m in enumerate(members)]
    out = {"per_member": per_member, "f1_record": f1_rec, "dcg_record": dcg_rec}
    if track_best_params:
        out["best_state"] = best_state
    return out
