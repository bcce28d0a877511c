"""Convergence of the port against the JAX package's recorded runs.

    python -m rlt_tpu_torch.convergence --compute-dtype bfloat16

trains each model once per seed (`python -m rlt_tpu_torch.train
--dataset-name drmm_tks_hard --epochs 100 --seed s`, its drmm_tks preset),
`--streams` processes at a time, each run's summary and log written under
`--out-dir`, and prints one JSON line: per model the seeds' best test F1,
their mean, the JAX package's `mean_best_f1` from `RESULTS.json` at the
root of the repo, and the difference. Arguments it does not know go to
every train run (`--device cpu --retrieve-data mq2007` for a quick drive
on the CPU).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
MODELS = ("mmoecut", "moecut", "mtple", "attncut", "mtattncut", "bicut", "choopy",
          "mtchoopy")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", nargs="+", default=list(MODELS), choices=MODELS)
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--dataset-name", default="drmm_tks_hard")
    p.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--streams", type=int, default=4,
                   help="train runs at a time")
    p.add_argument("--out-dir", default="build/convergence")
    return p


def _train(model: str, seed: int, args, extra: list[str], out_dir: Path) -> dict:
    stem = out_dir / f"{model}_{seed}"
    cmd = [sys.executable, "-m", "rlt_tpu_torch.train", "--model-name", model,
           "--dataset-name", args.dataset_name, "--epochs", str(args.epochs),
           "--seed", str(seed), "--compute-dtype", args.compute_dtype,
           "--out", f"{stem}.json", *extra]
    with open(f"{stem}.log", "w") as log:
        proc = subprocess.run(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"{model} seed {seed}: exit {proc.returncode}, see {stem}.log")
    return json.loads(Path(f"{stem}.json").read_text())


def main(argv=None) -> dict:
    args, extra = build_argparser().parse_known_args(argv)
    out_dir = Path(args.out_dir)
    if not out_dir.is_absolute():
        out_dir = REPO / out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = [(m, s) for m in args.models for s in args.seeds]
    with ThreadPoolExecutor(max_workers=args.streams) as pool:
        summaries = list(pool.map(lambda ms: _train(*ms, args, extra, out_dir), runs))
    reference = json.loads((REPO / "RESULTS.json").read_text())
    result = {}
    for model in args.models:
        best = [r["best_f1"] for (m, _), r in zip(runs, summaries) if m == model]
        mean = float(np.mean(best))
        jax_mean = reference[model]["mean_best_f1"]
        result[model] = {"best_f1": best, "mean_best_f1": mean, "jax_mean_best_f1": jax_mean,
                         "diff": mean - jax_mean, "compute_dtype": args.compute_dtype}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
