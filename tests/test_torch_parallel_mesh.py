"""The process mesh, the sharding rules and the launches of the port's
parallel layouts (rlt_tpu_torch/parallel/), on the CPU.

The counterparts of the JAX package's tests/test_parallel.py:98 (no silent
downscale), :207 (mesh_2d's shape and refusals) and :219 (the sharding rules
by parameter), read here from the port's state_dict names; `gather_rows`'
forward and backward over two gloo processes; the dry run's four layouts
over two processes; and the train CLI's `--data-parallel 1 --model-parallel
2` under torchrun (its member-sharded population search runs in
tests/test_torch_parallel.py's launch).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import parallel_workers as W
from rlt_tpu_torch.models import build_model
from rlt_tpu_torch.parallel import ProcessMesh, launch, local_rows, mesh_2d, padded_batch
from rlt_tpu_torch.parallel.mesh import Group, ensure_process_group
from rlt_tpu_torch.parallel.sharding import param_shardings
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _names(model_name, **kw):
    return {k: tuple(v.shape) for k, v in build_model(
        model_name, seq_len=16, input_size=3, dropout=0.0, **kw).state_dict().items()}


def _mmoecut(num_experts):
    from rlt_tpu_torch.models.mmoe import MMOECut

    return {k: tuple(v.shape) for k, v in MMOECut(
        seq_len=16, input_size=3, num_experts=num_experts).state_dict().items()}


class _Shape:
    def __init__(self, shape):
        self.shape = shape


def _specs(shapes, m):
    return param_shardings({k: _Shape(v) for k, v in shapes.items()}, m)


def test_sharding_rules_tp_and_ep_by_name():
    """E = 3 experts cannot split over 2 -> Megatron tp of the experts' FFN;
    E = 4 -> whole experts on the leading axis; the towers, the BiLSTM, the
    gates and the attention projections stay replicated in both, and
    everything at model_parallel 1."""
    enc = "experts.attention_layer.layers_0."
    tp = _specs(_mmoecut(3), 2)
    assert tp[enc + "linear1.weight"] == 1
    assert tp[enc + "linear1.bias"] == 1
    assert tp[enc + "linear2.weight"] == 2
    assert tp[enc + "linear2.bias"] is None
    assert tp[enc + "self_attn.in_proj_weight"] is None  # torch's q/k/v interleaving
    assert tp["w_gates"] is None
    assert tp["pre_encoding.weight_ih_l0"] is None
    assert tp["tower_cut.linear.weight"] is None
    ep = _specs(_mmoecut(4), 2)
    assert ep[enc + "linear1.weight"] == 0
    assert ep[enc + "self_attn.in_proj_weight"] == 0
    assert ep[enc + "norm2.bias"] == 0
    assert ep["w_gates"] is None
    assert set(_specs(_mmoecut(4), 1).values()) == {None}


@pytest.mark.parametrize("model_name,split", [
    ("attncut", {"attention_layer.layers_0.linear1.weight": 0,
                 "attention_layer.layers_0.linear1.bias": 0,
                 "attention_layer.layers_0.linear2.weight": 1}),
    ("mtple", {"experts.attention_layer.layers_0.linear1.weight": 1,
               "experts.attention_layer.layers_0.linear2.weight": 2,
               "experts.attention_layer.layers_0.linear1.bias": 1}),
    ("choopy", {f"attention_layer.layers_{i}.{leaf}": d for i in range(3)
                for leaf, d in (("linear1.weight", 0), ("linear1.bias", 0),
                                ("linear2.weight", 1))}),
    ("bicut", {})])
def test_sharding_rules_of_the_other_models(model_name, split):
    """The unstacked encoders take tp on their FFNs; PLECut's three experts
    take tp over 2; BiCut has nothing to split."""
    specs = _specs(_names(model_name), 2)
    assert {k: v for k, v in specs.items() if v is not None} == split


def test_plecut_takes_ep_over_three():
    specs = _specs(_names("mtple"), 3)
    assert specs["experts.attention_layer.layers_0.linear1.weight"] == 0
    assert specs["w_gate_0"] is None


def test_no_process_group_no_mesh(monkeypatch):
    """Without a process group there is no mesh, and on the CPU without a
    launcher nothing starts one: no silent single process."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_2d()
    with pytest.raises(RuntimeError, match="needs one process per rank"):
        ensure_process_group("cpu")


def test_local_rows_pad_to_the_data_size():
    """B = 7 over 2 and 4 data ranks: padded to 8, each rank its contiguous
    rows, the padding index 0 (an invalid row)."""
    def mesh(rank, size):
        group = Group("data", tuple(range(size)), None, rank, "gloo")
        return ProcessMesh(size, 1, rank, group, group)

    idx = torch.arange(1, 8)
    assert padded_batch(7, 2) == 8 and padded_batch(7, 4) == 8 and padded_batch(8, 4) == 8
    assert local_rows(idx, mesh(0, 2)).tolist() == [1, 2, 3, 4]
    assert local_rows(idx, mesh(1, 2)).tolist() == [5, 6, 7, 0]
    assert [local_rows(idx, mesh(r, 4)).tolist() for r in range(4)] == [
        [1, 2], [3, 4], [5, 6], [7, 0]]


@pytest.fixture(scope="module")
def world2_meshes():
    return launch(W.mesh_cases, 2, env=ONE_THREAD)


def test_mesh_refuses_silent_downscale_and_uneven_axes(world2_meshes):
    out = world2_meshes[0]
    assert "need 4 devices" in out["mesh_2d_4"]
    assert "must divide" in out["mesh_2d_3"]
    assert "need 3 devices" in out["dp_3"]


def test_mesh_shapes_and_groups(world2_meshes):
    r0, r1 = world2_meshes
    assert r0["dp"] == {"shape": {"data": 2, "model": 1}, "member": True, "rank": 0,
                        "data": (0, 1), "model": (0,)}
    assert r1["grid"] == {"shape": {"data": 1, "model": 2}, "member": True, "rank": 1,
                          "data": (1,), "model": (0, 1)}
    assert r0["dp_1"]["member"] and not r1["dp_1"]["member"]


def test_gather_rows_forward_and_backward(world2_meshes):
    """Rows 0-3 from rank 0 and 4-6 from rank 1 (its fourth row is the
    padding): every rank sees the batch; each rank's gradient is its rows'
    (the padding row's 0)."""
    want = torch.cat([torch.arange(8.).view(4, 2), torch.arange(8.).view(4, 2) + 10])[:7]
    weights = torch.arange(14.).view(7, 2)
    for rank, out in enumerate(world2_meshes):
        assert torch.equal(out["gather"]["y"], want)
    assert torch.equal(world2_meshes[0]["gather"]["grad"], weights[:4])
    assert torch.equal(world2_meshes[1]["gather"]["grad"],
                       torch.cat([weights[4:], torch.zeros(1, 2)]))


def test_launch_raises_a_ranks_error():
    with pytest.raises(Exception, match="rank 1 failed"):
        launch(W.raises_on_rank_1, 2, env=ONE_THREAD)


def test_dryrun_multichip_over_two_cpu_processes():
    """The dry run's four layouts (dp, dp x tp, dp x ep, the sharded
    population) over two gloo processes."""
    from rlt_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2)
    assert [r["world"] for r in out] == [2, 2]
    assert out[0]["dp"] == out[1]["dp"]


def _torchrun(args, tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "rlt_tpu_torch.train", "--device", "cpu", "--retrieve-data", "mq2007",
         "--synthetic-queries", "12", "--batch-size", "5", "--epochs", "1", *args],
        cwd=tmp_path, env=dict(ONE_THREAD_ENV, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]


def test_train_cli_data_and_model_parallel_under_torchrun(tmp_path):
    """`--data-parallel 1 --model-parallel 2` joins a launch of two: one
    summary, printed by rank 0, and the best weights written once, whole."""
    (summary,) = _torchrun(["--model-name", "attncut", "--data-parallel", "1",
                            "--model-parallel", "2", "--model-persist", "1",
                            "--save-path", "m"], tmp_path)
    assert summary["device"] == "cpu" and 0.0 <= summary["best_f1"] <= 1.0
    state = torch.load(tmp_path / "m" / "attncut.pt", weights_only=True)
    assert state["attention_layer.layers_0.linear1.weight"].shape[0] == 2048


def test_plecut_expert_parallel_over_three_equals_data_parallel():
    """ep over 3 ranks of one expert each against dp over 3, dropout on:
    the step losses within 1e-6 (the JAX package's rule), each rank holding
    one expert, the towers' partial mixes summed over the model group."""
    ranks = launch(W.plecut_ep, 3, env=ONE_THREAD)
    got, want = ranks[0]["ep"], ranks[0]["dp"]
    assert abs(got["steps"][:, 0] - want["steps"][:, 0]).max() <= 1e-6
    assert all(r["ep"]["local"]["experts.attention_layer.layers_0.linear1.weight"][0] == 1
               for r in ranks)
    assert got["calls"]["model:all_reduce"] > 0
