"""Training harness and CLI of the port (the JAX package's `train.py`).

    python -m rlt_tpu_torch.train --model-name mmoecut            # on the card
    python -m rlt_tpu_torch.train --model-name attncut --div-type kl
    python -m rlt_tpu_torch.train --device cpu --retrieve-data mq2007
    python -m rlt_tpu_torch.train --model-name mmoecut --compute-dtype bfloat16
    python -m rlt_tpu_torch.train --parameter-search 1 --search-times 8 --population 4

One epoch is every train batch of a shuffled, padded batch plan, each an
update of Adam with coupled L2 (torch's `Adam(weight_decay=...)`, which is
optax's `add_decayed_weights -> scale_by_adam`), then the whole test split
without dropout. Each train step decodes its cuts and scores F1/DCG on the
pre-update forward, as the reference does, and an epoch reports every
metric as the mean of its batch means. On the card the model runs through
the kernels K1' and K2' (BiLSTM; not Choopy or MtChoopy, which have none)
and, but for BiCut, its encoder's attention pair with dropout inside: K5'
and K6' for MMOECut, MOECut, AttnCut and MtAttnCut (heads of dh = 64) and
for Choopy and MtChoopy (heads of dh = 16, one launch per encoder layer),
K3' and K4' for PLECut; on the CPU (`--device cpu`) through their plain
versions. The batch plans and
every dropout mask come from one `torch.Generator` on the device, seeded
from `--seed`; the initial weights from the model's own seeded
initialisation or `--model-path`.

On the card each train step and each test step is one CUDA graph, as the
JAX package runs its steps inside one jitted program: the step is captured
at its first batch (`rlt_tpu_torch/utils/graphs.py`) and replayed for every
batch after it, the batch gathered inside the graph from the dataset on the
card through static index and mask buffers; the first replay is step 1 of
the run, with the dropout bits the eager step would draw. `Trainer(...,
graphs=False)` runs the same steps eager on the card, for reference runs
(through `ops.plain_ops()`, which refuses graphs) and to hold the graphs to.
The CPU runs eager. `--profile-dir DIR` writes a torch.profiler trace of
epochs 1-3 there, as the JAX trainer traces them with jax.profiler.

`--compute-dtype bfloat16` (`compute_dtype="bfloat16"`) trains as the JAX
package's `build_epoch_fn` does with it: the master parameters stay f32 and
Adam updates them; every step casts them to bf16 inside the autograd graph
(`models.layers.compute_params`, through `torch.func.functional_call`) and
the features with them, runs the model in bf16 and casts its outputs back
to f32 before the criterion, so losses, F1 and DCG are f32, and each
gradient reaches its f32 master through the cast. The test pass casts the
same way without dropout. The kernels run their bf16 instances, forward
and backward (K1', K2', and K3'/K4' or K5'/K6' in bf16); the LSTM's
recurrent weights take K2''s f32 gradient unrounded. No loss scaling (bf16
has f32's exponent range, and the JAX package scales none). best_state,
state_dict and `--model-persist` stay f32.

Eight models train: bicut, choopy, attncut, mtchoopy, mtattncut, mmoecut,
moecut and mtple, each with the JAX package's criterion
(`make_criterion`, with `--div-type`, `--augmented-reward`,
`--rerank-weight`, `--class-weight` and `--loss-override`).

The hyper-parameter search (`--parameter-search 1`, with
`--regularizer-search 1` or `--mt-search 1` for the reference's other
search axes, `--search-times` and `--parameter-record`) draws the JAX
package's trials (`draw_search_trials`) and appends its record lines.
It trains the trials one after another, or with `--population K` K at a
time as one population (`rlt_tpu_torch/population.py`): any of the eight
models, in float32 or bfloat16, each population step one CUDA graph on
the card; `--mt-search 1` gives MtChoopy's and MtAttnCut's members their
own task weights, and `--regularizer-search 1` their own dropout rates and
weight decays (each attention row at its member's rate in K3'-K6').

`--model-persist 1` writes the best weights (`<save-path>/<model>.pt`) and,
after every epoch, the training state (`utils/checkpoint.py`: the f32
master parameters, Adam's state, the generator's state, the epoch and the
records); `--resume 1` restores it in place and goes on at the next epoch,
so that a run of 3 epochs resumed for 2 more is the run of 5, bit for bit.
`--log-dir DIR` writes the metrics log (`utils/logging.py`: each step's
loss, each epoch's metrics and the summary, as JSONL, mirrored to
TensorBoard where `torch.utils.tensorboard` imports) under DIR/<model>/,
and `--draw 1` draws the reward and prediction curves of the test split
into ./figs every second epoch (`utils/plots.py`).

`--data-parallel 1` shards each batch over one process a card
(`rlt_tpu_torch/parallel/`, the JAX package's `Mesh('data')`): every card
of the host (the CLI spawns one process each; one card is a world of one),
or the ranks of a `torchrun` launch; the CPU runs parallel only under a
launcher. `--model-parallel M` adds the model axis: expert parallelism of
the MMOE family's expert stack where E divides M, else Megatron tensor
parallelism of the encoder FFNs. Each data rank runs the forward on its
rows of the batch, gathers the whole batch's outputs and evaluates the
unchanged criterion and F1/DCG on them (`rerank_loss`'s batch means,
`wass_dist_loss`'s (B, B) cost and every normaliser stay the batch's), and
the ranks' gradients are summed over the data group as one flat buffer
before Adam, inside the CUDA graph of the step on the card. Every dropout
mask is drawn whole and cut to the rank's share, so each layout draws the
bits of one process. Rank 0 alone writes the log, the records and the
checkpoints, which hold the whole tensors and load into any layout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from rlt_tpu_torch import config as config_lib
from rlt_tpu_torch.data import (
    DeviceDataset,
    load_pkl_dataset,
    synthetic_config,
    synthetic_dataset,
)
from rlt_tpu_torch.infer import COMPUTE_DTYPES, decode_ks, load_state_dict, to_float32
from rlt_tpu_torch.models import MODELS, build_model, is_multi_head
from rlt_tpu_torch.models.layers import compute_params
from rlt_tpu_torch.parallel.functional import all_reduce_grads, gather_outputs
from rlt_tpu_torch.utils import losses as losses_lib
from rlt_tpu_torch.utils import metrics as metrics_lib
from rlt_tpu_torch.utils.checkpoint import (
    load_train_state,
    restore_train_state,
    save_train_state,
)
from rlt_tpu_torch.utils.graphs import GraphedSteps, use_graphs
from rlt_tpu_torch.utils.logging import MetricsWriter
from rlt_tpu_torch.utils.platform import resolve_device

logger = logging.getLogger("rlt_tpu_torch")


def make_optimizer(params, lr: float, weight_decay: float) -> torch.optim.Adam:
    """torch optim.Adam as the reference builds it (run.py:104): the L2 term
    is added to the gradient before the moments, not decoupled. On CUDA
    parameters it is capturable (its step count and bias corrections on the
    card, no host sync), so that a CUDA graph holds the whole step; capturable
    Adam takes no CPU tensors, so the CPU keeps the default."""
    params = list(params)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay,
                            capturable=all(p.is_cuda for p in params))


def make_criterion(cfg: config_lib.TrainConfig) -> Callable:
    """criterion(output, labels, valid=...) -> scalar: the JAX package's
    dispatch (the reference's run.py:59-102). `loss_override` replaces the
    loss of choopy and attncut, the single-task models whose output is a
    distribution over positions; bicut -> `bicut_loss`; choopy ->
    `choopy_loss`; attncut -> `div_loss` with the config's divergence and
    augmentation; mtchoopy and mtattncut -> `mtcut_loss` with the config's
    task weights; mmoecut, moecut and mtple -> `mtcut_loss` with the torch
    defaults 0.5/0.5 (the reference passes none), PLECut always with its
    three tasks. Any other model raises a ValueError: probe_base trains
    through `rlt_tpu_torch.verify_probe`, as in the JAX package."""
    name, metric = cfg.model_name, cfg.criterion
    if name not in MODELS:
        raise ValueError(
            f"no criterion for model {name!r}: the Trainer trains "
            f"{', '.join(sorted(MODELS))}; probe_base trains through verify_probe")
    if cfg.loss_override and name in ("choopy", "attncut"):
        if cfg.loss_override == "wass":
            return losses_lib.wass_dist_loss
        if cfg.loss_override in ("attncut", "choopy"):
            return losses_lib.make_loss(cfg.loss_override, metric=metric)
        if cfg.loss_override == "div":
            return losses_lib.make_loss("div", metric=metric, div_type=cfg.div_type,
                                        augmented=cfg.augmented_reward)
        raise ValueError(f"unknown loss_override: {cfg.loss_override!r}")
    if name == "bicut":
        return losses_lib.make_loss("bicut", metric=metric)
    if name == "choopy":
        return losses_lib.make_loss("choopy", metric=metric)
    if name == "attncut":
        return losses_lib.make_loss("div", metric=metric, div_type=cfg.div_type,
                                    augmented=cfg.augmented_reward)
    if name in ("mtchoopy", "mtattncut"):
        return losses_lib.make_loss("mtcut", metric=metric,
                                    rerank_weight=cfg.rerank_weight,
                                    classi_weight=cfg.class_weight,
                                    num_tasks=cfg.num_tasks)
    return losses_lib.make_loss("mtcut", metric=metric, rerank_weight=0.5,
                                classi_weight=0.5,
                                num_tasks=cfg.num_tasks if name != "mtple" else 3)


def load_data(cfg: config_lib.TrainConfig):
    """The corpus of `cfg` on the host: the reference-format pkls under
    `dataset_base` in the model's loader family, or the calibrated synthetic
    corpus of `synthetic_queries` lists."""
    if cfg.dataset_base:
        family = config_lib.loader_family(cfg.model_name, cfg.retrieve_data)
        return load_pkl_dataset(cfg.dataset_base, cfg.retrieve_data, cfg.dataset_name,
                                family)
    return synthetic_dataset(num_queries=cfg.synthetic_queries, seq_len=cfg.seq_len,
                             num_features=cfg.input_size, seed=cfg.seed,
                             **synthetic_config(cfg.retrieve_data, cfg.dataset_name))


def batch_metrics(model_name: str, output, y: torch.Tensor, valid: torch.Tensor):
    """F1 and DCG at the decoded cuts, means over the valid rows."""
    ks = decode_ks(model_name, output)
    return (metrics_lib.f1_at_k(y, ks, valid=valid),
            metrics_lib.dcg_at_k(y, ks, valid=valid))


def forward(model, x: torch.Tensor, generator: torch.Generator | None = None,
            dtype: torch.dtype = torch.float32):
    """The model's outputs on f32 features x, in f32: the model itself in
    float32, or in `dtype` on its parameters cast inside the autograd graph
    (`compute_params`) with x cast alike, the outputs cast back to f32."""
    if dtype == torch.float32:
        return model(x, generator)
    return to_float32(torch.func.functional_call(
        model, compute_params(model, dtype), (x.to(dtype), generator)))


def train_step(model, optimizer, criterion, model_name: str, x: torch.Tensor,
               y: torch.Tensor, valid: torch.Tensor, generator: torch.Generator,
               dtype: torch.dtype = torch.float32, mesh=None):
    """One update on a batch, the forward in `dtype`; returns (loss, f1,
    dcg), 0-dim f32 tensors of the pre-update forward. The gradients stay in
    the parameters' `.grad`. Under a `mesh` (`parallel.ProcessMesh`) x is
    this data rank's rows and y, valid the whole batch's: the outputs are
    gathered over the data group, the criterion and F1/DCG are the whole
    batch's, and the gradients are summed over the data group before the
    update."""
    model.train()
    optimizer.zero_grad()
    output = forward(model, x, generator, dtype)
    if mesh is not None:
        output = gather_outputs(output, mesh.data, y.shape[0])
    loss = criterion(output, y, valid=valid)
    loss.backward()
    if mesh is not None:
        all_reduce_grads(model.parameters(), mesh.data)
    optimizer.step()
    with torch.no_grad():
        f1, dcg = batch_metrics(model_name, output, y, valid)
    return loss.detach(), f1, dcg


@torch.no_grad()
def eval_step(model, criterion, model_name: str, x: torch.Tensor, y: torch.Tensor,
              valid: torch.Tensor, dtype: torch.dtype = torch.float32, mesh=None):
    """The loss and F1/DCG of a batch without dropout, the forward in
    `dtype` (under a `mesh`, x this data rank's rows, as `train_step`)."""
    model.eval()
    output = forward(model, x, dtype=dtype)
    if mesh is not None:
        output = gather_outputs(output, mesh.data, y.shape[0])
    loss = criterion(output, y, valid=valid)
    f1, dcg = batch_metrics(model_name, output, y, valid)
    return loss, f1, dcg


class Trainer:
    """The reference's Trainer (run.py:26-240): epochs with best and best-5
    test F1/DCG, and the best weights written as a torch state_dict. Its
    steps run in `cfg.compute_dtype` (float32, or bfloat16 on f32 master
    parameters).

    `graphs`: each step one CUDA graph replay (the default on a CUDA
    device), or eager (False: the CPU's only route; on the card for
    reference runs). Graphs on the CPU raise. With `cfg.log_dir` the run
    writes its metrics log there (`writer`), with `cfg.model_persist` its
    training state after every epoch, which `run(resume=True)` takes up.

    `mesh` (a `parallel.ProcessMesh`; built over the launch when
    `cfg.data_parallel` is set, as the JAX Trainer builds its mesh) lays
    the run out: the model is sharded by `parallel.sharding.shard_module`
    after its weights are loaded, each step runs on this data rank's rows
    (`train_step`), `best_state` holds this rank's slices, and rank 0 alone
    writes the log, the figures and the files, with the whole tensors.
    `model`: a model built by the caller in place of `build_model`'s (the
    dry run's MMOECut at four experts; `build_model(..., **widths)` at
    widths the config does not name)."""

    def __init__(self, cfg: config_lib.TrainConfig, data=None,
                 device: str | torch.device | None = None, state_dict=None,
                 graphs: bool | None = None, mesh=None, model=None):
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                             f"got {cfg.compute_dtype!r}")
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self.cfg = cfg
        self.model_name = cfg.model_name
        self.criterion = make_criterion(cfg)
        self.device = resolve_device(device)
        if mesh is None and cfg.data_parallel:
            from rlt_tpu_torch.parallel import ensure_process_group, mesh_2d

            ensure_process_group(self.device)
            mesh = mesh_2d(model_parallel=cfg.model_parallel)
        self.mesh = mesh
        self.graphs = graphs = use_graphs(self.device, graphs)
        self.data = DeviceDataset.from_host(load_data(cfg) if data is None else data,
                                            cfg.batch_size, self.device)
        self.model = model if model is not None else build_model(
            cfg.model_name, seq_len=cfg.seq_len, input_size=cfg.input_size,
            dropout=cfg.dropout, num_tasks=cfg.num_tasks, seed=cfg.seed)
        if state_dict is None and cfg.model_path:
            state_dict = load_state_dict(cfg.model_path)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device)
        if mesh is not None:
            from rlt_tpu_torch.parallel.sharding import shard_module

            shard_module(self.model, mesh, cfg.batch_size)
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr,
                                        cfg.weight_decay)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.best_state = self._snapshot()
        self.best_test_f1 = -float("inf")
        self.best_test_dcg = -float("inf")
        self.f1_record: list[float] = []
        self.dcg_record: list[float] = []
        self.history: list[dict] = []  # each epoch's metrics, as run_epoch gives them
        self.writer = (MetricsWriter(cfg.log_dir, run_name=cfg.model_name)
                       if cfg.log_dir and self.writes else None)
        self._graphed = GraphedSteps(
            self._train, self._test, (cfg.batch_size,), self.device,
            params=self.model.parameters(), optimizer=self.optimizer,
            generators=[self.generator]) if graphs else None

    def _snapshot(self) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    @property
    def writes(self) -> bool:
        """Whether this process writes the run's files: rank 0 of a mesh, or
        the one process."""
        return self.mesh is None or self.mesh.is_writer

    def whole_state_dict(self, state: dict | None = None) -> dict[str, torch.Tensor]:
        """The model's state_dict (or `state`, one of its snapshots) with
        every sharded tensor whole; a collective of the mesh's model group
        under a layout, which every rank calls."""
        if self.mesh is None:
            return self.model.state_dict() if state is None else state
        from rlt_tpu_torch.parallel.sharding import gather_state_dict

        return gather_state_dict(self.model, self.mesh, state)

    @property
    def best_path(self) -> str:
        return os.path.join(self.cfg.save_path, f"{self.model_name}.pt")

    @property
    def state_path(self) -> str:
        """The training state's base path: `<save_path>/<model>` +
        `.trainstate.pt` and `.records.json`."""
        return os.path.join(self.cfg.save_path, self.model_name)

    def _rows(self, idx: torch.Tensor) -> torch.Tensor:
        """The plan row's indices of this data rank's rows (all of them
        without a mesh)."""
        if self.mesh is None:
            return idx
        from rlt_tpu_torch.parallel import local_rows

        return local_rows(idx, self.mesh)

    def _train(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        d = self.data
        return torch.stack(train_step(self.model, self.optimizer, self.criterion,
                                      self.model_name, d.x_train[self._rows(idx)],
                                      d.y_train[idx], valid, self.generator, self.dtype,
                                      self.mesh))

    def _test(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        d = self.data
        return torch.stack(eval_step(self.model, self.criterion, self.model_name,
                                     d.x_test[self._rows(idx)], d.y_test[idx], valid,
                                     self.dtype, self.mesh))

    def _step(self, split: str, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if self._graphed is not None:
            return self._graphed(split, idx, valid)
        return (self._train if split == "train" else self._test)(idx, valid)

    def train_batch(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """One update on the train batch of plan row (idx, valid): the
        (loss, f1, dcg) of its pre-update forward as a (3,) f32 tensor of
        its own. The gradients stay in the parameters' `.grad`."""
        return self._step("train", idx, valid)

    def test_batch(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(loss, f1, dcg) of the test batch of plan row (idx, valid)
        without dropout, as a (3,) f32 tensor of its own."""
        return self._step("test", idx, valid)

    def run_epoch(self, train_plan=None, test_plan=None) -> dict:
        """Every train batch, then the test split, the forwards in the
        compute dtype. The plans are drawn from the generator (train first)
        unless given as (idx, valid) pairs; the host fetches the epoch's
        batch results once. Returns the means of the batch means and the
        per-step train losses."""
        data, generator = self.data, self.generator
        tr_idx, tr_valid = data.plan(generator, "train", *(train_plan or (None, None)))
        te_idx, te_valid = data.plan(generator, "test", *(test_plan or (None, None)))
        train = [self.train_batch(idx, valid) for idx, valid in zip(tr_idx, tr_valid)]
        test = [self.test_batch(idx, valid) for idx, valid in zip(te_idx, te_valid)]
        tr = torch.stack(train).cpu().numpy().astype(np.float64)
        te = torch.stack(test).cpu().numpy().astype(np.float64)
        metrics = {f"{split}_{name}": float(np.mean(values[:, i]))
                   for split, values in (("train", tr), ("test", te))
                   for i, name in enumerate(("loss", "f1", "dcg"))}
        metrics["train_loss_steps"] = tr[:, 0].tolist()
        return metrics

    def run(self, profile_dir: str | None = None, resume: bool = False) -> dict:
        """Epochs up to `cfg.epochs` with best / best-5 tracking
        (run.py:222-232); with `model_persist`, each new best test F1 writes
        its weights and every epoch the training state. `resume`: restore
        the last training state (`restore`) and go on from the epoch after
        it; a finished run resumed runs no epoch and reports its restored
        records. With `profile_dir`, epochs 1-3 (epoch 0 builds the kernels
        and captures the graphs) are traced with torch.profiler into
        `profile_dir/epochs.pt.trace.json`, each epoch under a span of its
        own ("epoch <n>")."""
        cfg = self.cfg
        start = self.restore() if resume else 0
        logger.info("Train the %s model on %s (%s)", self.model_name, self.device,
                    "CUDA graphs" if self.graphs else "eager")
        prof = None
        try:
            for epoch in range(start, cfg.epochs):
                if profile_dir is not None and prof is None and 1 <= epoch < 4:
                    prof = _start_profiler(self.device)
                with torch.profiler.record_function(f"epoch {epoch}"):
                    self._epoch(epoch)
                if prof is not None and epoch == 3:
                    _write_trace(prof, profile_dir)
                    prof = None
        finally:
            if prof is not None:
                _write_trace(prof, profile_dir)
        summary = self.summary()
        if self.writer is not None:
            self.writer.log_summary({k: v for k, v in summary.items()
                                     if k != "compute_dtype"})
            self.writer.close()  # the reference closes it per run too (run.py:364)
            self.writer = None
        return summary

    def restore(self) -> int:
        """Restore the training state at `state_path` in place (the
        parameters, Adam's state, the generator and the records) and return
        the epoch to go on from; without one, 0."""
        payload = load_train_state(self.state_path)
        if payload is None:
            logger.warning("no training state at %s; training from epoch 0",
                           self.state_path)
            return 0
        restore_train_state(payload, self.model, self.optimizer, self.generator, self.mesh)
        records = payload.get("records", {})
        self.f1_record = list(records.get("f1_record", []))
        self.dcg_record = list(records.get("dcg_record", []))
        self.best_test_f1 = records.get("best_f1", self.best_test_f1)
        self.best_test_dcg = records.get("best_dcg", self.best_test_dcg)
        start = payload["epoch"] + 1
        logger.info("resumed from %s at epoch %d", self.state_path, start)
        return start

    def _records(self) -> dict:
        return {"f1_record": self.f1_record, "dcg_record": self.dcg_record,
                "best_f1": self.best_test_f1, "best_dcg": self.best_test_dcg}

    def _epoch(self, epoch: int) -> None:
        cfg = self.cfg
        start = time.perf_counter()
        metrics = self.run_epoch()
        self.history.append(metrics)
        if self.writer is not None:
            steps = metrics["train_loss_steps"]
            for s, loss in enumerate(steps):
                self.writer.log_step(epoch * len(steps) + s, "train/loss_step", loss)
            self.writer.log(epoch, {k: v for k, v in metrics.items()
                                    if k != "train_loss_steps"})
        self.f1_record.append(metrics["test_f1"])
        self.dcg_record.append(metrics["test_dcg"])
        if metrics["test_f1"] > self.best_test_f1:
            self.best_test_f1 = metrics["test_f1"]
            self.best_state = self._snapshot()
            if cfg.model_persist:
                best = self.whole_state_dict(self.best_state)
                if self.writes:
                    os.makedirs(cfg.save_path, exist_ok=True)
                    torch.save({k: v.cpu() for k, v in best.items()}, self.best_path)
        self.best_test_dcg = max(self.best_test_dcg, metrics["test_dcg"])
        if cfg.model_persist:
            save_train_state(self.state_path, self.model, self.optimizer, self.generator,
                             epoch, self._records(), self.mesh)
        if cfg.draw and epoch % 2 == 0:
            self.draw(epoch)
        logger.info(
            "Epoch %d (%.2fs): train loss=%.5f f1=%.5f dcg=%.5f | "
            "test loss=%.5f f1=%.5f dcg=%.5f", epoch, time.perf_counter() - start,
            metrics["train_loss"], metrics["train_f1"], metrics["train_dcg"],
            metrics["test_loss"], metrics["test_f1"], metrics["test_dcg"])

    @torch.no_grad()
    def test_predictions(self) -> np.ndarray:
        """The model's cut distribution over the test split without dropout,
        (n_test, L) f32 on the host, through the eval forward in the compute
        dtype in batches of `batch_size`; BiCut's is its argmax decisions
        (1 continue, 0 truncate), multi-head models' their last head."""
        self.model.eval()
        x, bs = self.data.x_test, self.data.batch_size
        cuts = []
        for i in range(0, x.shape[0], bs):
            output = forward(self.model, x[i:i + bs], dtype=self.dtype)
            if self.model_name == "bicut":
                # the reference plots the argmax decisions (run.py:132-136, 190-191)
                cuts.append(torch.argmax(output, dim=2).to(torch.float32))
            else:
                cut = output[-1] if is_multi_head(self.model_name) else output
                cuts.append(cut[..., 0])
        return torch.cat(cuts).cpu().numpy()

    def draw(self, epoch: int) -> str | None:
        """The reward and prediction curves of the test split at this epoch
        (`utils/plots.py`), into ./figs; the figure's path (under a mesh
        every rank runs the forward, rank 0 draws; None on the others)."""
        from rlt_tpu_torch.utils.plots import plot_reward_vs_prediction

        cfg = self.cfg
        predictions = self.test_predictions()
        if not self.writes:
            return None
        return plot_reward_vs_prediction(
            self.data.y_test.cpu().numpy(), predictions, metric=cfg.criterion,
            epoch=epoch, model_name=self.model_name, div_type=cfg.div_type,
            aug_reward=cfg.augmented_reward)

    def summary(self) -> dict:
        """best / best-5 test F1 and DCG (run.py:229-232; with no epoch on
        record, the bests), and the compute dtype of the steps."""
        if self.f1_record:
            best5_f1 = float(np.mean(sorted(self.f1_record, reverse=True)[:5]))
            best5_dcg = float(np.mean(sorted(self.dcg_record, reverse=True)[:5]))
        else:
            best5_f1, best5_dcg = self.best_test_f1, self.best_test_dcg
        logger.info("best: f1=%.7f dcg=%.6f | best-5: f1=%.7f dcg=%.6f",
                    self.best_test_f1, self.best_test_dcg, best5_f1, best5_dcg)
        return {"best_f1": self.best_test_f1, "best_dcg": self.best_test_dcg,
                "best5_f1": best5_f1, "best5_dcg": best5_dcg,
                "compute_dtype": self.cfg.compute_dtype}


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _write_trace(prof, profile_dir: str) -> None:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "epochs.pt.trace.json")
    prof.export_chrome_trace(path)
    logger.info("torch.profiler trace of epochs 1-3: %s", path)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="rlt_tpu_torch truncation model trainer (bicut, choopy, "
                    "attncut, mtchoopy, mtattncut, mmoecut, moecut, mtple)",
        epilog="--population K trains K search trials at a time as one population: "
               "any of the eight models, in float32 or bfloat16 (--compute-dtype), "
               "each population step one CUDA graph replay on the card; --mt-search "
               "gives MtChoopy's and MtAttnCut's members their own task weights, "
               "--regularizer-search their own dropout rates and weight decays. "
               "On the card every train and test step is one CUDA graph replay. "
               "--data-parallel 1 runs one process a visible card (or joins a torchrun "
               "launch; the CPU only under one), --model-parallel M adds expert or FFN "
               "tensor parallelism (rlt_tpu_torch/parallel/).")
    d = config_lib.TrainConfig()
    p.add_argument("--retrieve-data", type=str, default=d.retrieve_data)
    p.add_argument("--dataset-name", type=str, default=d.dataset_name)
    p.add_argument("--dataset-base", type=str, default=None,
                   help="reference-format pkl root; without it, the "
                        "calibrated synthetic corpus")
    p.add_argument("--synthetic-queries", type=int, default=d.synthetic_queries)
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--model-name", type=str, default=d.model_name)
    p.add_argument("--augmented-reward", type=int, default=1,
                   help="div loss: reward distribution at temperature tau "
                        "(1) or 1 (0)")
    p.add_argument("--div-type", type=str, default=d.div_type,
                   help="div loss: kl | js")
    p.add_argument("--criterion", type=str, default=d.criterion,
                   help="reward metric of the cut loss: f1 | dcg (bicut: nci "
                        "or any other name for its alternative rewards)")
    p.add_argument("--model-path", type=str, default=None,
                   help="initial weights: a torch state_dict file")
    p.add_argument("--model-persist", type=int, default=0,
                   help="write the best weights to <save-path>/<model>.pt, "
                        "which `rlt_tpu_torch.serve --model-path` reads")
    p.add_argument("--save-path", type=str, default=d.save_path)
    p.add_argument("--resume", type=int, default=0,
                   help="go on from the training state that --model-persist 1 wrote "
                        "after each epoch (parameters, Adam's state, generator, epoch, "
                        "records)")
    p.add_argument("--log-dir", type=str, default=d.log_dir,
                   help="write the metrics log (JSONL; TensorBoard where "
                        "torch.utils.tensorboard imports) under <log-dir>/<model>/")
    p.add_argument("--draw", type=int, default=0,
                   help="draw the test split's reward and prediction curves into "
                        "./figs every second epoch")
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--weight-decay", type=float, default=d.weight_decay)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-tasks", type=float, default=3)
    p.add_argument("--parameter-record", type=str, default=d.parameter_record)
    p.add_argument("--parameter-search", type=int, default=0)
    p.add_argument("--regularizer-search", type=int, default=0)
    p.add_argument("--mt-search", type=int, default=0)
    p.add_argument("--search-times", type=int, default=d.search_times)
    p.add_argument("--population", type=int, default=0,
                   help="with --parameter-search 1: train K search trials at a time "
                        "as one population instead of K sequential runs "
                        "(rlt_tpu_torch/population.py)")
    p.add_argument("--rerank-weight", type=float, default=d.rerank_weight)
    p.add_argument("--class-weight", type=float, default=d.class_weight)
    p.add_argument("--loss-override", type=str, default=None,
                   help="single-task loss switch: attncut|choopy|div|wass")
    p.add_argument("--no-preset", action="store_true",
                   help="skip the built-in hyper-parameter presets")
    p.add_argument("--conf-file", type=str, default=None,
                   help="reference-format hyper_parameter_*.conf to apply")
    p.add_argument("--compute-dtype", type=str, default=d.compute_dtype,
                   choices=tuple(COMPUTE_DTYPES),
                   help="the steps' dtype: bfloat16 casts the f32 master parameters "
                        "and the features to bf16 inside each step and runs the bf16 "
                        "kernels; losses and metrics stay f32")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard the batch over all visible chips (Mesh('data'))")
    p.add_argument("--model-parallel", type=int, default=d.model_parallel,
                   help="with --data-parallel 1: size of the second mesh axis "
                        "(expert-parallel MMOE stacks / Megatron FFN tp — "
                        "rlt_tpu_torch/parallel/sharding.py)")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the kernels) unless cpu (their plain versions)")
    p.add_argument("--out", type=str, default=None,
                   help="write the summary as JSON here")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of epochs 1-3 here")
    return p


def config_from_args(args) -> config_lib.TrainConfig:
    cfg = config_lib.TrainConfig(
        retrieve_data=args.retrieve_data, dataset_name=args.dataset_name,
        dataset_base=args.dataset_base, synthetic_queries=args.synthetic_queries,
        batch_size=args.batch_size, model_name=args.model_name,
        num_tasks=args.num_tasks, dropout=args.dropout, criterion=args.criterion,
        div_type=args.div_type, loss_override=args.loss_override,
        augmented_reward=bool(args.augmented_reward),
        rerank_weight=args.rerank_weight, class_weight=args.class_weight,
        epochs=args.epochs, lr=args.lr, weight_decay=args.weight_decay,
        seed=args.seed, model_path=args.model_path,
        model_persist=bool(args.model_persist), save_path=args.save_path,
        log_dir=args.log_dir, draw=bool(args.draw),
        parameter_search=bool(args.parameter_search),
        regularizer_search=bool(args.regularizer_search),
        mt_search=bool(args.mt_search), search_times=args.search_times,
        parameter_record=args.parameter_record, compute_dtype=args.compute_dtype,
        data_parallel=bool(args.data_parallel), model_parallel=args.model_parallel)
    # config-file override chain (run.py:339-347)
    if args.conf_file:
        cfg = config_lib.load_conf_file(cfg, args.conf_file)
    elif not args.no_preset:
        cfg = config_lib.apply_preset(cfg)
    return cfg


def draw_search_trials(cfg: config_lib.TrainConfig) -> list[dict]:
    """The reference's trial distributions (run.py:349-364) as a list of
    config-override dicts, drawn with the exact rng chain the sequential
    search uses — so the sequential and population engines train the SAME
    trials for a given (cfg.seed, search mode, search_times)."""
    rng = np.random.default_rng(cfg.seed)
    task_weight_range = np.logspace(-2, 1, num=250, base=10)
    trials = []
    for i in range(cfg.search_times):
        if cfg.regularizer_search:
            trials.append({
                "dropout": float(rng.uniform(0.05, 0.5)),
                "weight_decay": float(rng.uniform(0.001, 0.02)),
            })
        elif cfg.mt_search:
            rw = float(rng.uniform(0.01, 10)) if i >= 50 else float(task_weight_range[i])
            cw = float(rng.uniform(0.01, 10)) if i >= 50 else float(task_weight_range[i])
            trials.append({"rerank_weight": rw, "class_weight": cw})
        else:
            trials.append({})
    return trials


def _search_record_path(cfg: config_lib.TrainConfig) -> str:
    # the reference derives the record name in search mode (run.py:350);
    # an explicitly set parameter_record wins here
    if cfg.parameter_record is not None:
        return cfg.parameter_record
    return (
        f"{cfg.model_name}_{cfg.retrieve_data}_{cfg.dataset_name}_"
        f"{cfg.criterion}_params.log"
    )


def _search_record_line(trial: config_lib.TrainConfig, result: dict) -> str:
    return (
        f"dropout: {trial.dropout}, L2_weight: {trial.weight_decay}, "
        f"rerank_weight: {trial.rerank_weight}, class_weight: {trial.class_weight}, "
        f"best_f1: {result['best_f1']}, best_dcg: {result['best_dcg']}"
    )


def _writes(cfg: config_lib.TrainConfig) -> bool:
    """Whether this process writes a search's records: rank 0 of a
    parallel launch, or the one process."""
    if not cfg.data_parallel:
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def _chunk_mesh(k: int, world: int):
    """The JAX package's chunk rule: a chunk of k members over the largest
    divisor of k that the launch's `world` ranks can hold, or None (a chunk
    of 1, or a k with no divisor above 1 within the world, runs on rank 0
    alone). A collective of the whole launch."""
    from rlt_tpu_torch.parallel import data_parallel_mesh

    m = min(k, world)
    while m > 1 and k % m:
        m -= 1
    if m <= 1:
        return None
    logger.info("population chunk of %d sharded over %d processes", k, m)
    return data_parallel_mesh(m)


def parameter_search(cfg: config_lib.TrainConfig, population: int = 0,
                     device: str | torch.device | None = None) -> str:
    """The random / logspace hyper-parameter search (run.py:349-364); returns
    the record file's path, to which it appends one line per trial.

    population=0 (or 1) trains the trials one after another, each a full
    `Trainer` run, for every model; population=K trains them K at a time as
    one population (`population.train_population`): the same trials and the
    same record lines, written when the last chunk is done. The population
    takes trials of any model in either compute dtype, in every search
    mode: a regularizer search's members each drop at their own rate.

    With `cfg.data_parallel` the sequential trials each run data parallel,
    and each population chunk's members are sharded over a mesh of the
    largest divisor of its size that the launch holds (whole members a
    process, no collective in the steps: `_chunk_mesh`, the JAX package's
    rule); rank 0 writes the records."""
    trials = draw_search_trials(cfg)
    record = _search_record_path(cfg)
    if cfg.data_parallel:
        from rlt_tpu_torch.parallel import ensure_process_group

        ensure_process_group(resolve_device(device))
    writes = _writes(cfg)

    def write(trial, result):
        if writes:
            with open(record, "a+") as f:
                f.write("\n" + _search_record_line(trial, result))

    if population > 1:
        from rlt_tpu_torch.population import Member, train_population

        if not cfg.data_parallel:
            members = [Member(seed=cfg.seed, **ov) for ov in trials]
            logger.info("population search, %d trials %d at a time: %s", len(members),
                        population, members)
            out = train_population(cfg, members, chunk_size=population, device=device)
            for ov, row in zip(trials, out["per_member"]):
                write(dataclasses.replace(cfg, **ov), row)
            return record
        import torch.distributed as dist

        world, rank = dist.get_world_size(), dist.get_rank()
        for lo in range(0, len(trials), population):
            chunk = trials[lo:lo + population]
            members = [Member(seed=cfg.seed, **ov) for ov in chunk]
            mesh = _chunk_mesh(len(chunk), world)
            if (mesh.member if mesh is not None else rank == 0):
                logger.info("population search trials %d..%d: %s", lo,
                            lo + len(chunk) - 1, members)
                out = train_population(cfg, members, mesh=mesh, device=device)
                for ov, row in zip(chunk, out["per_member"]):
                    write(dataclasses.replace(cfg, **ov), row)
        return record

    for i, ov in enumerate(trials):
        trial = dataclasses.replace(cfg, **ov)
        logger.info("search trial %d: %s", i, trial)
        write(trial, Trainer(trial, device=device).run())
    return record


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.data_parallel:
        import torch.distributed as dist

        from rlt_tpu_torch.parallel import ensure_process_group, launch
        from rlt_tpu_torch.parallel.mesh import launched

        device = resolve_device(args.device)
        if not (dist.is_initialized() or launched()) and device.type == "cuda" \
                and torch.cuda.device_count() > 1:
            # one process a visible card, each running this CLI
            argv = sys.argv[1:] if argv is None else list(argv)
            return launch(main, torch.cuda.device_count(), argv, backend="nccl")[0]
        ensure_process_group(device)  # one card: a world of one; the CPU: raises
    writes = _writes(cfg)
    if writes:
        logger.info("%s", cfg)
    if cfg.parameter_search:
        record = parameter_search(cfg, population=args.population, device=args.device)
        summary = {"parameter_record": record, "trials": cfg.search_times,
                   "population": args.population}
        if writes:
            print(json.dumps(summary))
        return summary
    trainer = Trainer(cfg, device=args.device)
    summary = dict(trainer.run(profile_dir=args.profile_dir, resume=bool(args.resume)),
                   device=str(trainer.device),
                   config=dataclasses.asdict(cfg))
    if writes:
        print(json.dumps({k: v for k, v in summary.items() if k != "config"}))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
