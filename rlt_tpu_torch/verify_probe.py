"""Representation probing (the JAX package's `verify_probe.py`; the
reference's verify_probe.py).

    python -m rlt_tpu_torch.verify_probe                              # on the card
    python -m rlt_tpu_torch.verify_probe --ft 1 --model-path best_model/probe_base.pt
    python -m rlt_tpu_torch.verify_probe --device cpu --retrieve-data mq2007

Phase 1 trains a ProbeBase (a 2-expert MMOECut, `models/probe.py`) on the
multi-task cut loss with task weights 0.5/0.5 (verify_probe.py:92-130),
writing its weights to `<save_path>/probe_base.pt` at each new best test
F1. Phase 2 freezes it and trains six probe towers on its intermediates, a
classification and a rerank tower each on the BiLSTM output and on each
expert's output, and logs each step's six metrics (AUC, rerank DCG) under
`PROBE_TAGS` (verify_probe.py:170-228). The six towers share one Adam:
their parameters are disjoint, so Adam with coupled L2 updates each exactly
as the reference's six Adams do. `--ft 1 --model-path P` skips phase 1 and
probes the base at P.

On the card phase 1 runs ProbeBase through the kernels K1'/K2' (its BiLSTM,
both directions of a layer a launch) and K5'/K6' (its two experts' 4
heads of dh 64 over the 2 * B rows of the expert stack, dropout inside),
phase 2 its eval forward through K1' and K5'; every step is one CUDA graph
replay (`utils/graphs.py`), the counterpart of the JAX harness's jitted
epochs, and `graphs=False` runs eager. The base's dropout masks and every
batch plan come from one `torch.Generator` seeded from `--seed`. f32 only,
as the JAX harness. With `cfg.log_dir` the base's epoch metrics (tagged
`base_...`) and the probes' step metrics go to `<log_dir>/probe/`.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import os
import time

import numpy as np
import torch

from rlt_tpu_torch.analysis import PROBES, probing_convergence
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.data import DeviceDataset
from rlt_tpu_torch.infer import load_state_dict
from rlt_tpu_torch.models import Probe, ProbeBase
from rlt_tpu_torch.train import load_data, make_optimizer
from rlt_tpu_torch.utils import losses as losses_lib
from rlt_tpu_torch.utils import metrics as metrics_lib
from rlt_tpu_torch.utils.graphs import GraphedSteps, use_graphs
from rlt_tpu_torch.utils.logging import MetricsWriter
from rlt_tpu_torch.utils.platform import resolve_device

logger = logging.getLogger("rlt_tpu_torch.verify_probe")

# the six probes' log tags, in the order of a step's metrics
PROBE_TAGS = tuple(f"probe/{name}" for name in PROBES)


def probe_loss(outputs, y: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The six towers' losses summed: BCE for the classification towers,
    the rerank hinge for the rerank towers."""
    c1, r1, ce1, ce2, re1, re2 = outputs
    bce, rerank = losses_lib.bce_loss, losses_lib.rerank_loss
    return (bce(c1, y, valid=valid) + rerank(r1, y, valid=valid)
            + bce(ce1, y, valid=valid) + bce(ce2, y, valid=valid)
            + rerank(re1, y, valid=valid) + rerank(re2, y, valid=valid))


def probe_metrics(outputs, y: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The six metrics of a step, in `PROBE_TAGS` order, as a (6,) tensor."""
    c1, r1, ce1, ce2, re1, re2 = outputs
    auc, dcg = metrics_lib.taskc_metric, metrics_lib.taskr_metric
    return torch.stack([auc(y, c1, valid=valid), dcg(y, r1, valid=valid),
                        auc(y, ce1, valid=valid), dcg(y, re1, valid=valid),
                        auc(y, ce2, valid=valid), dcg(y, re2, valid=valid)])


class ProbeTrainer:
    """The two phases: `base_epoch` (phase 1, the base's train batches, then
    its test split) and `probe_epoch` (phase 2, the probes' train batches),
    with `run` the reference's loop. `graphs` as `train.Trainer`'s."""

    def __init__(self, cfg: TrainConfig, epochs_base: int = 20, epochs_probe: int = 180,
                 data=None, device: str | torch.device | None = None,
                 graphs: bool | None = None):
        self.cfg = cfg
        self.epochs_base, self.epochs_probe = epochs_base, epochs_probe
        self.device = resolve_device(device)
        self.graphs = graphs = use_graphs(self.device, graphs)
        # probe_base reads the MMOE family's corpora (Probe.py takes MMOECut's pkls)
        corpus = dataclasses.replace(cfg, model_name="probe_base")
        self.data = DeviceDataset.from_host(load_data(corpus) if data is None else data,
                                            cfg.batch_size, self.device)
        self.base = ProbeBase(seq_len=corpus.seq_len, num_tasks=cfg.num_tasks,
                              input_size=corpus.input_size, dropout=cfg.dropout,
                              seed=cfg.seed)
        if cfg.model_path:
            self.base.load_state_dict(load_state_dict(cfg.model_path))
            logger.info("loaded ProbeBase from %s", cfg.model_path)
        self.base.to(self.device)
        self.probe = Probe(seed=cfg.seed + 1).to(self.device)
        self.criterion_base = functools.partial(
            losses_lib.mtcut_loss, metric=cfg.criterion, rerank_weight=0.5,
            classi_weight=0.5, num_tasks=cfg.num_tasks)
        self.base_optimizer = make_optimizer(self.base.parameters(), cfg.lr,
                                             cfg.weight_decay)
        self.probe_optimizer = make_optimizer(self.probe.parameters(), cfg.lr,
                                              cfg.weight_decay)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.writer = MetricsWriter(cfg.log_dir, run_name="probe") if cfg.log_dir else None
        self.best_test_f1 = -float("inf")
        self.best_test_dcg = -float("inf")
        self.f1_record: list[float] = []
        self.dcg_record: list[float] = []
        self.history: list[dict] = []  # phase 1's epoch metrics
        shape = (cfg.batch_size,)
        self._base_graphs = GraphedSteps(
            self._base_train, self._base_test, shape, self.device,
            params=self.base.parameters(), optimizer=self.base_optimizer,
            generators=[self.generator]) if graphs else None
        self._probe_graphs = GraphedSteps(
            self._probe_train, None, shape, self.device, params=self.probe.parameters(),
            optimizer=self.probe_optimizer, generators=[]) if graphs else None

    @property
    def base_path(self) -> str:
        return os.path.join(self.cfg.save_path, "probe_base.pt")

    # -- phase 1 -----------------------------------------------------------

    def _base_train(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        d = self.data
        x, y = d.x_train[idx], d.y_train[idx]
        self.base.train()
        self.base_optimizer.zero_grad()
        _, _, heads = self.base(x, self.generator)
        loss = self.criterion_base(heads, y, valid=valid)
        loss.backward()
        self.base_optimizer.step()
        with torch.no_grad():
            ks = metrics_lib.decode_cut(heads[-1])
            return torch.stack([loss.detach(), metrics_lib.f1_at_k(y, ks, valid=valid),
                                metrics_lib.dcg_at_k(y, ks, valid=valid)])

    @torch.no_grad()
    def _base_test(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        d = self.data
        x, y = d.x_test[idx], d.y_test[idx]
        self.base.eval()
        _, _, heads = self.base(x)
        ks = metrics_lib.decode_cut(heads[-1])
        return torch.stack([self.criterion_base(heads, y, valid=valid),
                            metrics_lib.f1_at_k(y, ks, valid=valid),
                            metrics_lib.dcg_at_k(y, ks, valid=valid)])

    def base_batch(self, split: str, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(loss, f1, dcg) of the base on plan row (idx, valid) of `split`,
        a (3,) f32 tensor of its own; a train batch is one update, its
        metrics the pre-update forward's (dropout on)."""
        if self._base_graphs is not None:
            return self._base_graphs(split, idx, valid)
        return (self._base_train if split == "train" else self._base_test)(idx, valid)

    def base_epoch(self, train_plan=None, test_plan=None) -> dict:
        """Phase 1's epoch: every train batch, then the test split; plans
        from the generator (train first) unless given. The means of the
        batch means, and the per-step train losses."""
        data, generator = self.data, self.generator
        tr_idx, tr_valid = data.plan(generator, "train", *(train_plan or (None, None)))
        te_idx, te_valid = data.plan(generator, "test", *(test_plan or (None, None)))
        train = [self.base_batch("train", i, v) for i, v in zip(tr_idx, tr_valid)]
        test = [self.base_batch("test", i, v) for i, v in zip(te_idx, te_valid)]
        tr = torch.stack(train).cpu().numpy().astype(np.float64)
        te = torch.stack(test).cpu().numpy().astype(np.float64)
        metrics = {f"{split}_{name}": float(np.mean(values[:, i]))
                   for split, values in (("train", tr), ("test", te))
                   for i, name in enumerate(("loss", "f1", "dcg"))}
        metrics["train_loss_steps"] = tr[:, 0].tolist()
        return metrics

    # -- phase 2 -----------------------------------------------------------

    def _probe_train(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        d = self.data
        x, y = d.x_train[idx], d.y_train[idx]
        with torch.no_grad():  # the frozen base, without dropout
            self.base.eval()
            experts_in, experts_o, _ = self.base(x)
        self.probe_optimizer.zero_grad()
        outputs = self.probe(experts_in, experts_o)
        probe_loss(outputs, y, valid).backward()
        self.probe_optimizer.step()
        with torch.no_grad():
            return probe_metrics(outputs, y, valid)

    def probe_batch(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """One update of the six towers on train plan row (idx, valid): the
        six metrics of the pre-update forward, a (6,) f32 tensor of its own."""
        if self._probe_graphs is not None:
            return self._probe_graphs("train", idx, valid)
        return self._probe_train(idx, valid)

    def probe_epoch(self, train_plan=None) -> np.ndarray:
        """Phase 2's epoch over the train split: (batches, 6) step metrics."""
        idx, valid = self.data.plan(self.generator, "train", *(train_plan or (None, None)))
        steps = [self.probe_batch(i, v) for i, v in zip(idx, valid)]
        return torch.stack(steps).cpu().numpy()

    def run(self, ft: bool = False) -> list[np.ndarray]:
        """Phase 1 for `epochs_base` epochs (skipped with `ft`: the base is
        `cfg.model_path`'s), then phase 2 for `epochs_probe`; the per-step
        probe metrics of each phase-2 epoch."""
        if not ft:
            logger.info("Train the Base model on %s", self.device)
            os.makedirs(self.cfg.save_path, exist_ok=True)
            for epoch in range(self.epochs_base):
                start = time.perf_counter()
                m = self.base_epoch()
                self.history.append(m)
                if self.writer is not None:
                    self.writer.log(epoch, {f"base_{k}": v for k, v in m.items()
                                            if k != "train_loss_steps"})
                self.f1_record.append(m["test_f1"])
                self.dcg_record.append(m["test_dcg"])
                if m["test_f1"] > self.best_test_f1:
                    self.best_test_f1 = m["test_f1"]
                    torch.save({k: v.detach().cpu() for k, v in self.base.state_dict().items()},
                               self.base_path)
                self.best_test_dcg = max(self.best_test_dcg, m["test_dcg"])
                logger.info("base epoch %d (%.2fs): test f1=%.5f dcg=%.5f", epoch,
                            time.perf_counter() - start, m["test_f1"], m["test_dcg"])
        logger.info("Train the probes")
        curves = []
        for epoch in range(self.epochs_probe):
            per_step = self.probe_epoch()
            curves.append(per_step)
            if self.writer is not None:
                for s, row in enumerate(per_step):
                    self.writer.log(epoch * len(per_step) + s, dict(zip(PROBE_TAGS, row)))
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        return curves


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    d = TrainConfig()
    p = argparse.ArgumentParser(description="rlt_tpu_torch representation probing")
    p.add_argument("--retrieve-data", type=str, default="robust04")
    p.add_argument("--dataset-name", type=str, default="drmm_tks")
    p.add_argument("--dataset-base", type=str, default=None)
    p.add_argument("--synthetic-queries", type=int, default=d.synthetic_queries)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--criterion", type=str, default="f1")
    p.add_argument("--model-path", type=str, default=None,
                   help="a ProbeBase state_dict file; with --ft 1 phase 1 is skipped")
    p.add_argument("--ft", type=int, default=1)
    p.add_argument("--epochs-base", type=int, default=20)
    p.add_argument("--epochs-probe", type=int, default=180)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=0.005)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-path", type=str, default=d.save_path)
    p.add_argument("--log-dir", type=str, default=None,
                   help="write the metrics log under <log-dir>/probe/")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the kernels) unless cpu (their plain versions)")
    args = p.parse_args(argv)
    cfg = TrainConfig(
        retrieve_data=args.retrieve_data, dataset_name=args.dataset_name,
        dataset_base=args.dataset_base, synthetic_queries=args.synthetic_queries,
        batch_size=args.batch_size, model_name="probe_base", criterion=args.criterion,
        dropout=args.dropout, lr=args.lr, weight_decay=args.weight_decay, seed=args.seed,
        model_path=args.model_path, save_path=args.save_path, log_dir=args.log_dir)
    trainer = ProbeTrainer(cfg, epochs_base=args.epochs_base,
                           epochs_probe=args.epochs_probe, device=args.device)
    curves = trainer.run(ft=bool(args.ft) and args.model_path is not None)
    summary = {"device": str(trainer.device), "base_f1_record": trainer.f1_record,
               "base_dcg_record": trainer.dcg_record}
    if curves:
        summary["probes"] = probing_convergence(curves)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
