"""Auxiliary-task learnability verification (the JAX package's
`verify_bmt.py`; the reference's verify_BMT.py).

    python -m rlt_tpu_torch.verify_bmt --verify-type c             # on the card
    python -m rlt_tpu_torch.verify_bmt --ft 1 --model-name choopy --model-path best_model/choopy.pt
    python -m rlt_tpu_torch.verify_bmt --device cpu --retrieve-data mq2007

Trains a standalone head, TaskC (classification: BCE, per-query AUC) or
TaskR (rerank: hinge, rerank DCG), on the raw ranked-list features (`--ft
0`) or on the frozen trunk of a trained AttnCut or Choopy (`--ft 1`,
verify_BMT.py:66-75): AttnCut's BiLSTM and encoder layer, or Choopy's
position encoding and three encoder layers, without their decision head.
It is evidence that the truncation trunk encodes the auxiliary task. The
trunk runs in eval mode under `torch.no_grad()` (the JAX package's
`stop_gradient`), its weights the random initialisation of `--seed` or a
port state_dict at `--model-path` (what `train --model-persist 1` writes).
On the card the trunk runs the kernels K1' (AttnCut's BiLSTM) and K5' (the
packed attention at dh 64 or 16), and every train and test step of the
head, trunk included, is one CUDA graph replay (`utils/graphs.py`), the
counterpart of the JAX harness's jitted epoch; `graphs=False` runs eager.
f32 only, as the JAX harness.

`run_verification` returns the per-epoch train metric (AUC or DCG), the
record verify_BMT.py:96,145 keeps; the CLI prints it as the JSON line last.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.data import DeviceDataset
from rlt_tpu_torch.infer import load_state_dict
from rlt_tpu_torch.models import TaskC, TaskR, build_model
from rlt_tpu_torch.models.simple import with_position_encoding
from rlt_tpu_torch.train import load_data, make_optimizer
from rlt_tpu_torch.utils import losses as losses_lib
from rlt_tpu_torch.utils import metrics as metrics_lib
from rlt_tpu_torch.utils.graphs import GraphedSteps, use_graphs
from rlt_tpu_torch.utils.platform import resolve_device

logger = logging.getLogger("rlt_tpu_torch.verify_bmt")

TRUNKS = ("attncut", "choopy")


def trunk_apply(model_name: str, trunk: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The frozen trunk's representation of x (verify_BMT.py:66-75): AttnCut
    = BiLSTM + encoder layer, (B, L, 256); Choopy = the scores with the
    position encoding + three encoder layers, (B, L, 128). No decision head."""
    if model_name == "attncut":
        return trunk.attention_layer(trunk.encoding_layer(x))
    if model_name == "choopy":
        return trunk.attention_layer(with_position_encoding(x, trunk.position_encoding))
    raise ValueError(f"no trunk for {model_name!r}: verify_bmt takes {TRUNKS}")


class BMTVerifier:
    """The verification run of `run_verification`: a head (`head`) with its
    Adam, on the features or on a frozen trunk (`trunk`), epoch by epoch
    (`run_epoch`). `graphs` as `train.Trainer`'s."""

    def __init__(self, cfg: TrainConfig, verify_type: str = "r", ft: bool = False,
                 data=None, device: str | torch.device | None = None,
                 graphs: bool | None = None):
        if verify_type not in ("c", "r"):
            raise ValueError(f"verify_type must be 'c' or 'r', got {verify_type!r}")
        self.cfg, self.verify_type, self.ft = cfg, verify_type, ft
        self.device = resolve_device(device)
        self.graphs = graphs = use_graphs(self.device, graphs)
        self.data = DeviceDataset.from_host(load_data(cfg) if data is None else data,
                                            cfg.batch_size, self.device)
        self.trunk = None
        feat_dim = cfg.input_size
        if ft:
            if cfg.model_name not in TRUNKS:
                raise ValueError(f"--ft 1 takes the trunk of {TRUNKS}, not "
                                 f"{cfg.model_name!r}")
            self.trunk = build_model(cfg.model_name, seq_len=cfg.seq_len,
                                     input_size=cfg.input_size, dropout=cfg.dropout,
                                     seed=cfg.seed)
            if cfg.model_path:
                self.trunk.load_state_dict(load_state_dict(cfg.model_path))
                logger.info("loaded the frozen trunk from %s", cfg.model_path)
            self.trunk.to(self.device).eval().requires_grad_(False)
            feat_dim = 128 if cfg.model_name == "choopy" else 256
        head = TaskC if verify_type == "c" else TaskR
        self.head = head(feat_dim, seed=cfg.seed + 1).to(self.device)
        self.criterion = losses_lib.bce_loss if verify_type == "c" else losses_lib.rerank_loss
        self.metric = (metrics_lib.taskc_metric if verify_type == "c"
                       else metrics_lib.taskr_metric)
        self.metric_name = "auc" if verify_type == "c" else "DCG"
        self.optimizer = make_optimizer(self.head.parameters(), cfg.lr, cfg.weight_decay)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.record: list[float] = []
        self._graphed = GraphedSteps(
            self._train, self._test, (cfg.batch_size,), self.device,
            params=self.head.parameters(), optimizer=self.optimizer,
            generators=[]) if graphs else None

    @torch.no_grad()
    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The head's input: x itself, or the frozen trunk's representation."""
        if self.trunk is None:
            return x
        return trunk_apply(self.cfg.model_name, self.trunk, x)

    def _train(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        d = self.data
        x, y = d.x_train[idx], d.y_train[idx]
        self.optimizer.zero_grad()
        out = self.head(self.features(x))
        loss = self.criterion(out, y, valid=valid)
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            return torch.stack([loss.detach(), self.metric(y, out, valid=valid)])

    @torch.no_grad()
    def _test(self, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        d = self.data
        x, y = d.x_test[idx], d.y_test[idx]
        out = self.head(self.features(x))
        return torch.stack([self.criterion(out, y, valid=valid),
                            self.metric(y, out, valid=valid)])

    def batch(self, split: str, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(loss, metric) of plan row (idx, valid) of `split` as a (2,) f32
        tensor of its own; a train batch is one update of the head, its
        metric the pre-update forward's."""
        if self._graphed is not None:
            return self._graphed(split, idx, valid)
        return (self._train if split == "train" else self._test)(idx, valid)

    def run_epoch(self, train_plan=None, test_plan=None) -> dict:
        """Every train batch, then the test split; the plans are drawn from
        the generator (train first) unless given as (idx, valid) pairs.
        Returns the means of the batch values."""
        data, generator = self.data, self.generator
        tr_idx, tr_valid = data.plan(generator, "train", *(train_plan or (None, None)))
        te_idx, te_valid = data.plan(generator, "test", *(test_plan or (None, None)))
        train = [self.batch("train", i, v) for i, v in zip(tr_idx, tr_valid)]
        test = [self.batch("test", i, v) for i, v in zip(te_idx, te_valid)]
        tr = torch.stack(train).cpu().numpy().astype(np.float64)
        te = torch.stack(test).cpu().numpy().astype(np.float64)
        return {"train_loss": float(np.mean(tr[:, 0])), "train_metric": float(np.mean(tr[:, 1])),
                "test_loss": float(np.mean(te[:, 0])), "test_metric": float(np.mean(te[:, 1]))}

    def run(self) -> list[float]:
        """`cfg.epochs` epochs; the per-epoch train metric."""
        for epoch in range(self.cfg.epochs):
            start = time.perf_counter()
            m = self.run_epoch()
            self.record.append(m["train_metric"])
            logger.info("Epoch %d (%.2fs): train loss=%.5f %s=%.6f | test loss=%.5f %s=%.6f",
                        epoch, time.perf_counter() - start, m["train_loss"], self.metric_name,
                        m["train_metric"], m["test_loss"], self.metric_name,
                        m["test_metric"])
        return self.record


def run_verification(cfg: TrainConfig, verify_type: str = "r", ft: bool = False, data=None,
                     device: str | torch.device | None = None) -> list[float]:
    """The per-epoch train metric record (verify_BMT.py:96,145) of a head
    trained on the features (ft False) or on the frozen trunk of
    `cfg.model_name` (ft True)."""
    return BMTVerifier(cfg, verify_type, ft, data=data, device=device).run()


def main(argv=None) -> list[float]:
    logging.basicConfig(level=logging.INFO)
    d = TrainConfig()
    p = argparse.ArgumentParser(description="rlt_tpu_torch auxiliary-task verification")
    p.add_argument("--retrieve-data", type=str, default="robust04")
    p.add_argument("--dataset-name", type=str, default="drmm_tks")
    p.add_argument("--dataset-base", type=str, default=None)
    p.add_argument("--synthetic-queries", type=int, default=d.synthetic_queries)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--model-name", type=str, default="attncut")
    p.add_argument("--verify-type", type=str, default="r", choices=("c", "r"))
    p.add_argument("--model-path", type=str, default=None,
                   help="the frozen trunk: a port state_dict file")
    p.add_argument("--ft", type=int, default=0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--weight-decay", type=float, default=0.0015)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the kernels) unless cpu (their plain versions)")
    args = p.parse_args(argv)
    cfg = TrainConfig(
        retrieve_data=args.retrieve_data, dataset_name=args.dataset_name,
        dataset_base=args.dataset_base, synthetic_queries=args.synthetic_queries,
        batch_size=args.batch_size, model_name=args.model_name, dropout=args.dropout,
        epochs=args.epochs, lr=args.lr, weight_decay=args.weight_decay, seed=args.seed,
        model_path=args.model_path)
    verifier = BMTVerifier(cfg, args.verify_type, bool(args.ft), device=args.device)
    record = verifier.run()
    print(json.dumps({"verify_type": args.verify_type, "ft": bool(args.ft),
                      "model_name": args.model_name, "device": str(verifier.device),
                      "record": record}))
    return record


if __name__ == "__main__":
    main()
