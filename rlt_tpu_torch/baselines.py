"""Classical truncation baselines (the JAX package's `baselines.py`; the
reference's Baseline/*.ipynb as one CLI).

    python -m rlt_tpu_torch.baselines                       # on the card
    python -m rlt_tpu_torch.baselines --device cpu --retrieve-data mq2007

Fixed-k: the metric at a fixed cut (Fixed_k.ipynb cells 4, 12). Greedy-k:
the one k that maximises the mean train curve, applied to the test split
(Greedy_k.ipynb cell 6). Oracle: each test query's best cut, the upper
bound (Oracle.ipynb cell 6). All three read off the (B, L) metric curves
of `utils/metrics.py`, on the device the caller names (the card unless
`device="cpu"`)."""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.data import load_pkl_dataset, synthetic_config, synthetic_dataset
from rlt_tpu_torch.utils import metrics as metrics_lib
from rlt_tpu_torch.utils.platform import resolve_device


def baseline_table(y_train, y_test, fixed_ks=(5, 10, 50),
                   device: str | torch.device | None = None) -> dict:
    """Every classical baseline of one corpus, as one dict: per metric (f1,
    dcg) the oracle, the greedy k and its test score, and each fixed k's."""
    dev = resolve_device(device)
    y_train = torch.as_tensor(np.asarray(y_train, np.float32)).to(dev)
    y_test = torch.as_tensor(np.asarray(y_test, np.float32)).to(dev)
    out: dict = {}
    for metric in ("f1", "dcg"):
        out[f"oracle_{metric}"] = float(metrics_lib.oracle_score(y_test, metric))
        k = int(metrics_lib.greedy_k(y_train, metric))
        out[f"greedy_k_{metric}"] = k
        out[f"greedy_{metric}"] = float(metrics_lib.fixed_k_score(y_test, k, metric))
        for fk in fixed_ks:
            out[f"fixed_{metric}@{fk}"] = float(metrics_lib.fixed_k_score(y_test, fk, metric))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="rlt_tpu_torch classical baselines")
    p.add_argument("--retrieve-data", type=str, default="robust04")
    p.add_argument("--dataset-name", type=str, default="drmm_tks")
    p.add_argument("--dataset-base", type=str, default=None)
    p.add_argument("--fixed-ks", type=int, nargs="+", default=[5, 10, 50])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="cuda unless cpu")
    args = p.parse_args(argv)

    if args.dataset_base:
        data = load_pkl_dataset(args.dataset_base, args.retrieve_data, args.dataset_name,
                                "choopy")
    else:
        cfg = TrainConfig(retrieve_data=args.retrieve_data, dataset_name=args.dataset_name)
        data = synthetic_dataset(seq_len=cfg.seq_len, seed=args.seed,
                                 **synthetic_config(args.retrieve_data, args.dataset_name))
    table = baseline_table(data.y_train, data.y_test, tuple(args.fixed_ks),
                           device=args.device)
    print(json.dumps(table, indent=2))
    return table


if __name__ == "__main__":
    main()
