"""The port's parallel layouts (rlt_tpu_torch/parallel/) across gloo
processes on the CPU, against the port's one process.

Two launches, a world of two and a world of four
(`tests/parallel_workers.py`, spawned once a module), run every case; the
tests compare what their ranks return with one process run here:

- data parallelism (dp) equals one process at world sizes 2 and 4, for
  MMOECut (whose criterion has the batch-wide rerank hinge) and AttnCut
  with `--loss-override wass` (Sinkhorn over the batch's (B, B) cost), at
  B = 7, which 2 and 4 do not divide (the padding rows enter no
  criterion); and with dropout on, as every mask is drawn whole;
- a batch whose second shard holds no relevant label, where the mean of
  per-shard criteria is not the batch's;
- the replicas stay bit-identical after three steps;
- tp (MMOECut at E = 3, AttnCut, PLECut) and ep (MMOECut at E = 4) on a (2, 2)
  world equal dp (4, 1) with dropout on, loss within 1e-6, and each of
  their steps issues both model-group and data-group collectives;
- the sharded population equals the unsharded one, member by member;
- sharded `--resume` equals an uninterrupted run, under dp and dp x tp, and
  the state it writes loads into one process;
- bf16 under dp, by the port's bf16 training rule (PERF.md §2) against
  d_ref, the one process's bf16 minus its f32 run.

Tolerances, the port's update rule: step losses 1e-5 relative; where a
step reads past it, the run's step losses are held in L2 to 4 times the
one process's own distance from a run of it from the init nudged one ulp
(chip_smoke.py's STEP_NOISE_OF_REF: the parts sum their gradients in
another order, and Adam moves an element whose gradient is rounding noise
by about lr either way); each leaf's update within 1e-2 of the one
process's in L2, leaving out the leaves whose gradient is zero by algebra
(`models.ZERO_GRAD_LEAVES`, the key block of every in_proj_bias).
"""

import math

import numpy as np
import pytest
import torch

import parallel_workers as W
from rlt_tpu_torch.models import ZERO_GRAD_LEAVES
from rlt_tpu_torch.parallel import launch
from rlt_tpu_torch.population import train_population
from rlt_tpu_torch.utils.checkpoint import load_train_state
from torch_threads import one_torch_thread  # noqa: F401

STEP_LOSS_REL = 1e-5
STEP_NOISE_OF_REF = 4.0
UPDATE_REL = 1e-2
LAYOUT_LOSS_ATOL = 1e-6  # tp and ep against dp (JAX: tests/test_parallel.py:251)
BF16_LOSS_OF_REF = 3.0
BF16_UPDATE_OF_REF = 2.0
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return launch(W.world2, 2, str(tmp_path_factory.mktemp("world2")), env=ONE_THREAD)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return launch(W.world4, 4, str(tmp_path_factory.mktemp("world4")), env=ONE_THREAD)


CASES = {"mmoecut": W.config("mmoecut"),
         "attncut_wass": W.config("attncut", loss_override="wass"),
         "dropout": W.config("mmoecut", dropout=0.1)}


@pytest.fixture(scope="module")
def one_process():
    """The one process's run of each case, on one torch thread."""
    torch.set_num_threads(1)
    return {name: W.steps(cfg) for name, cfg in CASES.items()}


def _nudged(state: dict, seed: int = 0) -> dict:
    """Every element one ulp up or down (chip_smoke.py's `nudged`)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in state.items():
        up = torch.rand(t.shape, generator=g) < 0.5
        out[name] = torch.nextafter(t, torch.where(up, math.inf, -math.inf))
    return out


def _without_key_bias(name, t):
    if not name.endswith("self_attn.in_proj_bias"):
        return t
    d = t.shape[-1] // 3
    return torch.cat([t[..., :d], t[..., 2 * d:]], dim=-1)


def _moves(run: dict, init: dict, model_name: str) -> dict:
    return {k: _without_key_bias(k, v - init[k]) for k, v in run["final"].items()
            if k not in ZERO_GRAD_LEAVES[model_name]}


def assert_update_rule(got: dict, want: dict, cfg, model_name: str) -> None:
    """The port's update rule (module docstring)."""
    g, w = got["steps"][:, 0], want["steps"][:, 0]
    rel = np.abs(g - w) / np.abs(w)
    if rel.max() > STEP_LOSS_REL:
        noise = W.steps(cfg, state_dict=_nudged(want["init"]))["steps"][:, 0]
        assert np.linalg.norm(g - w) <= STEP_NOISE_OF_REF * np.linalg.norm(noise - w), (
            g, w, noise)
    moved, ref = _moves(got, want["init"], model_name), _moves(want, want["init"], model_name)
    for k in ref:
        assert (moved[k] - ref[k]).norm() <= UPDATE_REL * ref[k].norm(), k


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["mmoecut", "attncut_wass", "dropout"])
def test_data_parallel_equals_one_process(world, case, world2, world4, one_process):
    ranks = world2 if world == 2 else world4
    got, want = ranks[0][case], one_process[case]
    cfg = CASES[case]
    # the batch's metrics are the one process's: the same cuts on the same rows
    np.testing.assert_allclose(got["steps"][:, 1:], want["steps"][:, 1:], atol=1e-6)
    assert_update_rule(got, want, cfg, cfg.model_name)
    assert got["calls"] == {"data:all_gather": 3 * (3 if cfg.model_name == "mmoecut" else 1),
                            "data:all_reduce": 3}


def test_a_shard_without_relevant_labels(world2):
    """Rank 1's rows hold no relevant label. Each rank gathers the whole
    batch's outputs, so the rerank hinge's means are the batch's: the step
    equals the one process's, where the mean of the two shards' criteria
    is another loss (rank 1's hinge is 0 on its own)."""
    from rlt_tpu_torch.train import Trainer, make_criterion
    from rlt_tpu_torch.utils.losses import rerank_loss

    data, rows = W.no_relevant_dataset()
    cfg = W.config("mmoecut", seed=W.NO_RELEVANT_SEED)
    want = W.steps(cfg, data=data, rows=rows)
    assert_update_rule(world2[0]["no_relevant"], want, cfg, "mmoecut")
    trainer = Trainer(cfg, data=data, device="cpu")
    trainer.model.train()
    idx = torch.as_tensor(rows)
    heads = trainer.model(trainer.data.x_train[idx])
    y = trainer.data.y_train[idx]
    assert y[4:].sum() == 0 and rerank_loss(heads[1], y).item() > 1e-3
    criterion = make_criterion(cfg)
    whole = criterion(heads, y, valid=torch.ones(7)).item()
    shards = [criterion([h[s] for h in heads], y[s], valid=torch.ones(y[s].shape[0])).item()
              for s in (slice(0, 4), slice(4, 7))]
    assert abs(np.mean(shards) - whole) > 1e-3 * whole
    np.testing.assert_allclose(world2[0]["no_relevant"]["steps"][0, 0], whole, rtol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_replicas_stay_bit_identical(world, world2, world4):
    ranks = world2 if world == 2 else world4
    cases = [c for c in ranks[0] if isinstance(ranks[0][c], dict) and "final" in ranks[0][c]]
    assert len(cases) >= 4
    for case in cases:
        for other in ranks[1:]:
            for k, v in ranks[0][case]["final"].items():
                assert torch.equal(v, other[case]["final"][k]), (case, k)


@pytest.mark.parametrize("layout,reference", [("tp", "dropout"), ("ep", "ep_dp"),
                                              ("attncut_tp", "attncut_dp"),
                                              ("mtple_tp", "mtple_dp")])
def test_tp_and_ep_equal_data_parallel(layout, reference, world4):
    """(2, 2) against (4, 1), dropout on: every layout draws the bits of one
    process, so the losses agree to the order of sums."""
    got, want = world4[0][layout], world4[0][reference]
    np.testing.assert_allclose(got["steps"][:, 0], want["steps"][:, 0], rtol=0,
                               atol=LAYOUT_LOSS_ATOL)
    for k, v in want["final"].items():
        assert got["final"][k].shape == v.shape, k


@pytest.mark.parametrize("layout", ["tp", "ep", "attncut_tp", "mtple_tp"])
def test_model_layouts_issue_both_groups_collectives(layout, world4):
    """Each step of a (2, 2) layout sums over the model group (tp's FFN
    partials, ep's expert mixes and the copies' gradients) and gathers and
    sums over the data group (the counterpart of the JAX package's HLO
    test, tests/test_parallel.py:272)."""
    calls = world4[0][layout]["calls"]
    assert calls["model:all_reduce"] >= 2 * W.STEPS
    assert calls["data:all_reduce"] == W.STEPS
    assert calls["data:all_gather"] >= W.STEPS
    assert "model:all_reduce" not in world4[0]["dropout"]["calls"]


@pytest.mark.parametrize("layout,name,local", [
    ("tp", "experts.attention_layer.layers_0.linear1.weight", (3, 1024, 256)),
    ("tp", "experts.attention_layer.layers_0.linear2.weight", (3, 256, 1024)),
    ("tp", "experts.attention_layer.layers_0.linear2.bias", (3, 256)),
    ("ep", "experts.attention_layer.layers_0.linear1.weight", (2, 2048, 256)),
    ("ep", "experts.attention_layer.layers_0.self_attn.in_proj_weight", (2, 768, 256)),
    ("ep", "w_gates", (3, 4096, 4)),
    ("attncut_tp", "attention_layer.layers_0.linear1.bias", (1024,))])
def test_the_layouts_hold_their_shards(layout, name, local, world4):
    """Each rank of a (2, 2) layout holds its slice of a split parameter
    (tp: the FFN's halves; ep: two of the four experts) and all of a
    replicated one, and the gathered state is the whole model's."""
    for rank in world4:
        assert rank[layout]["local"][name] == local
    whole = world4[0][layout]["final"][name].shape
    assert whole == world4[0][layout]["init"][name].shape


def test_bf16_data_parallel_by_the_bf16_rule(world2):
    """dp in bf16 against the one process in bf16, with d_ref the one
    process's bf16 minus its f32 run: step losses within 3 |d_ref| plus one
    bf16 step, the updates over all leaves (but the zero ones) within 2 of
    d_ref's in L2."""
    torch.set_num_threads(1)
    got = world2[0]["bf16"]
    bf16 = W.steps(W.config("mmoecut", compute_dtype="bfloat16"))
    f32 = W.steps(W.config("mmoecut"))
    g, b, f = (r["steps"][:, 0] for r in (got, bf16, f32))
    step = 2.0 ** (np.floor(np.log2(np.abs(b))) - 7)
    assert np.all(np.abs(g - b) <= BF16_LOSS_OF_REF * np.abs(b - f) + step), (g, b, f)
    init = bf16["init"]

    def flat(run):
        return torch.cat([v.reshape(-1) for v in _moves(run, init, "mmoecut").values()])

    assert (flat(got) - flat(bf16)).norm() <= BF16_UPDATE_OF_REF * (
        flat(bf16) - flat(f32)).norm()


def test_sharded_population_equals_the_unsharded_one(world2):
    """K = 4 members, two a rank, against the K = 4 population in one
    process, member by member (JAX: tests/test_population.py:191): bit for
    bit on the CPU, where a batched product's rows do not depend on the
    batch's size. A population of 3 does not divide over 2 ranks."""
    torch.set_num_threads(1)
    want = train_population(W.config("mmoecut", epochs=2, dropout=0.1),
                            W.population_members(), device="cpu")
    for got in (world2[0]["population"], world2[1]["population"]):
        np.testing.assert_array_equal(got["f1_record"], want["f1_record"])
        np.testing.assert_array_equal(got["dcg_record"], want["dcg_record"])
        for a, b in zip(got["per_member"], want["per_member"]):
            assert a["member"] == b["member"]
            for ha, hb in zip(a["history"], b["history"]):
                assert ha == hb
    assert "must divide over the 2-device mesh" in world2[0]["odd_population"]


@pytest.mark.parametrize("world,case", [(2, "resume"), (4, "resume_tp")])
def test_sharded_resume_equals_the_uninterrupted_run(world, case, world2, world4):
    """epochs - 1 epochs, then --resume for the last, under the layout:
    the records and the weights of the uninterrupted run, bit for bit (JAX:
    tests/test_parallel.py:315)."""
    for rank in world2 if world == 2 else world4:
        full, resumed = rank[case]["full"], rank[case]["resumed"]
        assert resumed["f1_record"] == full["f1_record"]
        assert len(full["f1_record"]) in (2, 3)
        for k, v in full["final"].items():
            assert torch.equal(resumed["final"][k], v), k


def test_a_sharded_state_loads_into_one_process(world4, tmp_path_factory):
    """The dp x tp run's state file holds the whole tensors: it is the run's
    gathered state, and a one-process Trainer restores it."""
    from rlt_tpu_torch.train import Trainer

    full = world4[0]["resume_tp"]["full"]
    base = tmp_path_factory.getbasetemp()
    path = next(base.glob("world4*/resume_tp/full/mmoecut.trainstate.pt"))
    payload = load_train_state(str(path)[:-len(".trainstate.pt")])
    assert payload["epoch"] == 1
    for k, v in full["final"].items():
        assert torch.equal(payload["params"][k], v), k
    cfg = W.config("mmoecut", epochs=2, dropout=0.1, save_path=str(path.parent))
    trainer = Trainer(cfg, data=W.dataset(), device="cpu")
    assert trainer.restore() == 2
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, full["final"][k]), k


def test_train_cli_population_search_over_the_launch(world2, tmp_path_factory):
    """`--parameter-search 1 --population 2 --data-parallel 1` over two
    ranks: three trials, a chunk of two sharded one member a rank and a
    chunk of one on rank 0 (the JAX package's chunk rule), each record line
    written once, by rank 0."""
    assert world2[0]["search_cli"]["trials"] == 3
    record = next(tmp_path_factory.getbasetemp().glob("world2*/record.log"))
    lines = record.read_text().strip().splitlines()
    assert len(lines) == 3 and all("best_f1" in line for line in lines)
