#!/usr/bin/env python3
"""On a CUDA card: how far each float32 population member's step losses part
from its own sequential Trainer's, beside how far that Trainer parts from
itself when its init is moved one ulp (`chip_smoke.py::nudged_run`, the
witness the smoke holds a member to where a step loss reads past
STEP_LOSS_REL).

    python3 scripts/probe_population_noise.py [MODEL ...]

For each model (default: all eight) it trains the smoke's population
(`population_config`, POPULATION_MEMBERS at POPULATION_RATES, one graphed
epoch), then each member's graphed Trainer at its rate and the same Trainer
from its init nudged with two seeds. One JSON line a member: its rate and
lr, the step losses' largest relative gap to its Trainer, the L2 gap over
the epoch's steps, the two nudged runs' L2 gaps, and the ratio of the
member's gap to the larger of them.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
from rlt_tpu_torch.models import build_model  # noqa: E402
from rlt_tpu_torch.population import member_config, train_population  # noqa: E402
from rlt_tpu_torch.train import Trainer  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_population_noise: no CUDA card is available", file=sys.stderr)
        return 1
    l2 = np.linalg.norm
    t0 = time.perf_counter()
    for model_name in sys.argv[1:] or smoke.MODELS:
        cfg = smoke.population_config(model_name)
        members = smoke.population_members(smoke.POPULATION_SIZES[0], smoke.POPULATION_RATES)
        out = train_population(cfg, members, device="cuda")
        for m, (member, row) in enumerate(zip(members, out["per_member"])):
            mcfg = member_config(cfg, member)
            trainer = Trainer(mcfg, device="cuda")
            trainer.run()
            seq = np.asarray(trainer.history[0]["train_loss_steps"])
            got = np.asarray(row["history"][0]["train_loss_steps"])
            init = build_model(model_name, seq_len=cfg.seq_len, input_size=cfg.input_size,
                               dropout=cfg.dropout, num_tasks=cfg.num_tasks,
                               seed=member.seed).state_dict()
            nudged = [l2(smoke.nudged_run(mcfg, init, seed) - seq)
                      for seed in (member.seed, member.seed + 100)]
            print(json.dumps({
                "model": model_name, "member": m, "rate": mcfg.dropout, "lr": member.lr,
                "max_rel": float(np.max(np.abs(got - seq) / np.abs(seq))),
                "l2": float(l2(got - seq)), "nudged_l2": [float(x) for x in nudged],
                "of_nudged": float(l2(got - seq) / max(max(nudged), 1e-30)),
                "steps": seq.tolist()}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
