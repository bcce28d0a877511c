"""Population training of the port in bfloat16, and the search CLI's
populations, on the CPU.

A bf16 population casts its f32 master parameters and the features inside
each step, as a bf16 Trainer does (`train.forward`), so member m's bf16 run
is its sequential bf16 Trainer's with the products batched over the members:
another rounding of each bf16 gradient, which Adam may turn into a step of
the other sign where a gradient is rounding noise. So each member of every
model is held to its sequential bf16 Trainer by the bf16 rule of
tests/test_torch_bf16_train.py (the replayed bf16 epoch), with d_ref the
same member's sequential f32 Trainer against its bf16 one: the epoch's
updates, over all leaves but those whose gradient is zero by algebra and
the key block of every in_proj_bias, within UPDATE_OF_REF of d_ref's in
L2, and the step losses within 3 |d_ref| plus one bf16 step of the loss,
taken in L2 over the epoch's steps as the updates are over the leaves:
one step's d_ref may be near 0 by chance (at these seeds AttnCut's fourth
step loss reads 1.8e-5 of d_ref against a 2.1e-4 difference, 1.7 bf16
steps, where the epoch's d_ref is 1.3e-3 in L2). Step 1, taken before any
update, is the sequential step's forward: within one bf16 step. Then
the train CLI's population search: every model at `--population 2` in
bf16, and `--mt-search` on MtChoopy and MtAttnCut.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rlt_tpu_torch import train
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.models import MODELS, ZERO_GRAD_LEAVES, build_model
from rlt_tpu_torch.population import Member, member_config, train_population
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

UPDATE_OF_REF = 2.0  # tests/test_torch_bf16_train.py's, and why
MEMBERS_2 = [Member(seed=0, lr=1e-3, weight_decay=0.0),
             Member(seed=1, lr=3e-4, weight_decay=0.01)]


def tiny_cfg(name: str, **kw) -> TrainConfig:
    base = dict(model_name=name, retrieve_data="robust04", seq_len_override=12,
                synthetic_queries=20, batch_size=4, epochs=1, dropout=0.2, lr=1e-3,
                weight_decay=0.0, compute_dtype="bfloat16")
    base.update(kw)
    return TrainConfig(**base)


def without_key_bias(name: str, t: torch.Tensor) -> torch.Tensor:
    if not name.endswith("self_attn.in_proj_bias"):
        return t
    d = t.shape[-1] // 3
    return torch.cat([t[..., :d], t[..., 2 * d:]], dim=-1)


def bf16_step(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_population_matches_sequential_trainers(name):
    """Two bf16 members of distinct seed, lr and weight decay, dropout 0.2
    on, one epoch: f32 masters and summaries in bf16, and each member
    against its sequential bf16 Trainer by the bf16 rule."""
    cfg = tiny_cfg(name)
    out = train_population(cfg, MEMBERS_2, track_best_params=True, device="cpu")
    assert_bf16_members_match_trainers(cfg, MEMBERS_2, out)


def assert_bf16_members_match_trainers(cfg, members, out):
    """Each member of a bf16 population run with `track_best_params`
    against its sequential bf16 Trainer by the bf16 rule, with d_ref its
    sequential f32 Trainer."""
    name = cfg.model_name
    assert all(t.dtype == torch.float32 for t in out["best_state"].values())
    for m, (row, member) in enumerate(zip(out["per_member"], members)):
        assert row["compute_dtype"] == "bfloat16"
        runs = {}
        for dtype in ("bfloat16", "float32"):
            trainer = train.Trainer(member_config(dataclasses.replace(
                cfg, compute_dtype=dtype), member), device="cpu")
            trainer.run()
            runs[dtype] = trainer
        got, want, want32 = (np.asarray(h["train_loss_steps"]) for h in (
            row["history"][0], runs["bfloat16"].history[0], runs["float32"].history[0]))
        assert len(got) == len(want) > 0
        assert abs(got[0] - want[0]) <= bf16_step(want[0])
        l2 = np.linalg.norm
        assert l2(got - want) <= 3 * l2(want - want32) + l2(bf16_step(want)), (m, got, want)
        init = build_model(name, seq_len=cfg.seq_len, input_size=cfg.input_size,
                           dropout=member_config(cfg, member).dropout,
                           seed=member.seed).state_dict()
        state, state32 = (runs[d].model.state_dict() for d in ("bfloat16", "float32"))
        err2 = ref2 = 0.0
        for key, value in out["best_state"].items():
            if key in ZERO_GRAD_LEAVES[name]:
                continue
            pop, seq, seq32 = (without_key_bias(key, t - init[key]).double() for t in (
                value[m], state[key], state32[key]))
            err2 += float((pop - seq).pow(2).sum())
            ref2 += float((seq - seq32).pow(2).sum())
        assert ref2 > 0 and (err2 / ref2) ** 0.5 <= UPDATE_OF_REF, (m, err2, ref2)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_cli_population_search_runs_every_model_in_bf16(tmp_path, name):
    """`--parameter-search 1 --population 2 --compute-dtype bfloat16`: one
    population of the two trials of any model, two record lines."""
    record = tmp_path / "search.log"
    summary = train.main(["--parameter-search", "1", "--population", "2",
                          "--search-times", "2", "--model-name", name,
                          "--compute-dtype", "bfloat16", "--device", "cpu",
                          "--retrieve-data", "mq2007", "--synthetic-queries", "12",
                          "--batch-size", "4", "--epochs", "1",
                          "--parameter-record", str(record)])
    assert summary["population"] == 2
    lines = record.read_text().splitlines()
    assert lines[0] == "" and len(lines) == 3 and all("best_f1: " in line
                                                      for line in lines[1:])


@pytest.mark.parametrize("name", ["mtchoopy", "mtattncut"])
def test_train_cli_mt_search_population(tmp_path, name):
    """`--mt-search 1 --population 2`: the search's first two trials (task
    weights 0.01 and 0.0103 from its logspace) as one population of
    MtChoopy or MtAttnCut, each trial's weights in its record line."""
    record = tmp_path / "search.log"
    train.main(["--parameter-search", "1", "--mt-search", "1", "--population", "2",
                "--search-times", "2", "--model-name", name, "--device", "cpu",
                "--retrieve-data", "mq2007", "--synthetic-queries", "12",
                "--batch-size", "4", "--epochs", "1", "--parameter-record", str(record)])
    trials = train.draw_search_trials(TrainConfig(parameter_search=True, mt_search=True,
                                                  search_times=2))
    lines = record.read_text().splitlines()[1:]
    assert len(lines) == 2
    for line, trial in zip(lines, trials):
        assert (f"rerank_weight: {trial['rerank_weight']}, "
                f"class_weight: {trial['class_weight']}") in line
