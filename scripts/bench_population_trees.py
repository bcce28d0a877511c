"""Population epochs of this tree of the port and others, in turns, on the card.

    mkdir -p build/parent && git archive <commit> rlt_tpu_torch | tar -x -C build/parent
    python3 scripts/bench_population_trees.py --tree build/parent --out pop_ab.json

Each round runs one process per tree (the order reversed in odd rounds:
the other trees, this tree, this tree, the others reversed, ...), with the tree's `rlt_tpu_torch`
first on its path; each process builds its tree's kernels, trains a K = 8
population (chip_smoke.py's members: seeds 0-7 with its lr and weight
decay) of MMOECut and of Choopy in float32 and bfloat16 at robust04 width,
each population step one CUDA graph, and times `EPOCHS` epochs after one
warm-up epoch between CUDA events. Prints one JSON line: each tree's epoch
ms by (model, dtype) under its directory's name ("this" for this tree), the
median over the rounds, with each round's value.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("mmoecut", "float32"), ("mmoecut", "bfloat16"), ("choopy", "float32"),
         ("choopy", "bfloat16"))
EPOCHS = 3
MEMBERS = ((3e-5, 0.0), (1e-4, 1e-3), (1e-5, 5e-3), (3e-4, 1e-2))  # chip_smoke.py's

CHILD = """
import json, sys, dataclasses
import torch
from rlt_tpu_torch.config import TrainConfig, apply_preset
from rlt_tpu_torch.population import Member, Population
out = {}
for model_name, dtype in %(cases)r:
    cfg = apply_preset(TrainConfig(model_name=model_name, compute_dtype=dtype))
    cfg = dataclasses.replace(cfg, epochs=1, dropout=cfg.dropout or 0.1)
    members = [Member(seed=i, lr=%(members)r[i %% 4][0], weight_decay=%(members)r[i %% 4][1])
               for i in range(8)]
    pop = Population(cfg, members, device="cuda")
    pop.run_epoch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(%(epochs)d):
        pop.run_epoch()
    end.record()
    end.synchronize()
    out[model_name + "/" + dtype] = start.elapsed_time(end) / %(epochs)d
    del pop
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def run_tree(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    code = CHILD % {"cases": CASES, "members": MEMBERS, "epochs": EPOCHS}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.path.abspath(tree),
                         capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: exit {res.returncode}\n{res.stderr[-3000:]}")
    line = next(ln for ln in res.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", required=True, action="append",
                   help="another tree (a directory holding its rlt_tpu_torch/); repeatable")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    trees = {os.path.basename(os.path.normpath(t)): t for t in args.tree}
    trees["this"] = ROOT
    rounds: dict[str, list[dict]] = {name: [] for name in trees}
    for r in range(args.rounds):
        for name in (list(trees) if r % 2 == 0 else list(trees)[::-1]):
            rounds[name].append(run_tree(trees[name]))
    summary = {name: {case: {"epoch_ms": statistics.median(x[case] for x in runs),
                             "rounds": [x[case] for x in runs]}
                      for case in runs[0]} for name, runs in rounds.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    result = {"card": smi, "epochs": EPOCHS, "members": 8, **summary}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
