"""Whether a population member's bits depend on how many members share its
population, on the card.

    PYTHONPATH=. python3 scripts/probe_population_bits.py [--dtype float32] [MODEL ...]

For each model (all eight by default), one eager population train step of
K = 8 members (chip_smoke.py's members, at robust04 width) against the same
step of the members split into populations of 4 and of 2, and of the first
4 against populations of 2: each member's loss and every parameter's
gradient, bit for bit. Prints one line a model: for each pair of sizes the
names that differ (empty where every member's bits agree). A population
sharded over processes (`train_population(mesh=)`) trains K / n members a
process, so it is bit-equal to the unsharded one only where these agree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def step(model_name: str, members, dtype: str):
    """One eager population step's member losses and gradients by name."""
    from rlt_tpu_torch.population import Population
    from rlt_tpu_torch.train import forward
    from rlt_tpu_torch.utils import losses as losses_lib

    pop = Population(cs.population_config(model_name, dtype), members, device="cuda",
                     graphs=False)
    idx, valid = pop.plans("train")
    pop.model.train()
    x, y = pop.batch("train", idx[:, 0])
    out = forward(pop.model, x, pop.generators, pop.dtype)
    losses = losses_lib.member_losses(pop.criteria, out, y, valid[:, 0])
    losses.sum().backward()
    return losses.detach(), {n: p.grad for n, p in pop.model.named_parameters()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("models", nargs="*", default=list(cs.MODELS))
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    args = p.parse_args()
    from rlt_tpu_torch.ops import build

    build.LIBRARY.get()
    members = cs.population_members(8)
    for model_name in args.models:
        row = {"model": model_name, "dtype": args.dtype}
        for whole in (8, 4):
            losses, grads = step(model_name, members[:whole], args.dtype)
            for k in (4, 2):
                if k >= whole:
                    continue
                differ = set()
                for lo in range(0, whole, k):
                    part_losses, part = step(model_name, members[lo:lo + k], args.dtype)
                    if not torch.equal(losses[lo:lo + k], part_losses):
                        differ.add("losses")
                    differ |= {n for n in grads if not torch.equal(grads[n][lo:lo + k], part[n])}
                    del part
                row[f"{whole}_against_{k}"] = sorted(differ)
            del grads
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
