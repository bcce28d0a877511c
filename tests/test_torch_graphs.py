"""One CUDA graph per step and per serving bucket (rlt_tpu_torch/utils/graphs.py)
and the busy time of the card as the union of its device intervals
(rlt_tpu_torch/utils/timing.py).

The CPU tests hold what runs without a card: the interval union on
synthetic intervals, the refusal of a busy time above its window, Adam
capturable only on CUDA parameters, graphs refused on the CPU and inside
`plain_ops()`, the snapshot that undoes a warm-up's steps in place (a
Trainer's and a population's), the serving buckets, `--profile-dir`'s
trace of epochs 1-3, and the CPU epoch (eager) equal to the loop it
replaced. The tests that take the `cuda_device` fixture need a card and
skip without one: graphed against eager, bit for bit, for train steps,
population steps and bucket forwards in both dtypes; the
launch counts of a replay; the refusal of a replay inside `plain_ops()`.
The file imports neither JAX nor the JAX package, so that it runs on the
card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py -q
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rlt_tpu_torch.config import TrainConfig, apply_preset
from rlt_tpu_torch.data import synthetic_dataset
from rlt_tpu_torch.infer import Predictor
from rlt_tpu_torch.ops import KERNELS, plain_active, plain_ops
from rlt_tpu_torch.population import Member, Population
from rlt_tpu_torch.serve import TruncationService, bucket_size, bucket_sizes
from rlt_tpu_torch.train import Trainer, eval_step, main, make_optimizer, train_step
from rlt_tpu_torch.utils.graphs import GraphedCall, snapshot
from rlt_tpu_torch.utils.timing import (busy_row, host_share, pick_session, session_busy_ns,
                                       union_ns)
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured on a CUDA device only")
    return torch.device("cuda")


def tiny_cfg(model_name="mmoecut", **kw):
    kw.setdefault("dropout", 0.1)
    return TrainConfig(model_name=model_name, seq_len_override=16, synthetic_queries=12,
                       batch_size=4, **kw)


# ---------------------------------------------------------------------------
# the busy time: a union of device intervals (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("intervals,want", [
    ([], 0),
    ([(0, 10), (20, 25)], 15),              # disjoint
    ([(20, 25), (0, 10)], 15),              # disjoint, out of order
    ([(0, 100), (10, 20), (30, 40)], 100),  # nested
    ([(0, 10), (5, 15), (12, 30)], 30),     # overlapping, chained
    ([(0, 10), (0, 10), (0, 10)], 10),      # identical
    ([(0, 10), (10, 20)], 20),              # touching
    ([(5, 8), (0, 20), (19, 25), (30, 31)], 26),
])
def test_union_ns_merges_overlaps(intervals, want):
    assert union_ns(intervals) == want


def test_union_ns_against_a_timeline():
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 10_000, size=300)
    ends = starts + rng.integers(1, 200, size=300)
    covered = np.zeros(10_300, bool)
    for s, e in zip(starts, ends):
        covered[s:e] = True
    assert union_ns(zip(starts.tolist(), ends.tolist())) == int(covered.sum())


D, H = True, False  # a device record, a host record


@pytest.mark.parametrize("records,want", [
    ([(0, 1, H), (2, 5, D), (5, 9, D), (3, 4, H)], (2, 7)),    # one stream
    ([(5, 9, D), (3, 4, H), (2, 5, D), (0, 1, H)], (2, 7)),    # any order
    ([(0, 1, H), (2, 9, D), (3, 5, D)], (2, 7)),               # overlapping
    ([(0, 1, H), (2, 20, D), (5, 8, D), (10, 12, D)], (3, 18)),  # nested
    ([(0, 1, H), (2, 9, D), (2, 9, D)], (2, 7)),               # identical
    ([(0, 1, H), (-5, -2, D), (2, 5, D)], (1, 3)),             # work from before the session
    ([(0, 1, H), (-5, 3, D), (0, 4, D)], (1, 4)),              # started before it, ended in it
    ([(0, 1, H)], (0, 0)),                                     # no device work
    ([(2, 5, D), (4, 9, D)], (2, 7)),                          # no host record
])
def test_session_busy_ns_counts_the_sessions_own_records(records, want):
    assert session_busy_ns(records) == want
    assert session_busy_ns(iter(records)) == want  # as device_busy hands them over


@pytest.mark.parametrize("records,between,want", [
    ([(0, 1, H), (2, 5, D), (5, 9, D)], (2, 9), (2, 7)),          # all between the marks
    ([(0, 1, H), (2, 5, D), (5, 12, D)], (2, 9), (2, 7)),         # one ends past the mark
    ([(0, 1, H), (2, 5, D), (10, 12, D)], (2, 9), (1, 3)),        # one wholly past it
    ([(0, 1, H), (-5, 3, D), (4, 6, D)], (2, 9), (1, 2)),         # before the session
    ([(0, 1, H), (2, 4, D), (3, 8, D)], (3, 7), (2, 4)),          # overlapping, clipped
])
def test_session_busy_ns_clips_to_the_marks(records, between, want):
    assert session_busy_ns(records, between) == want


@pytest.mark.parametrize("sessions,best,short", [
    # (head spins, records, need, busy ms, window ms)
    ([(256, 100, 50, 7, 1.0), (256, 98, 50, 6, 1.0)], 1, []),       # both complete: lower
    ([(256, 80, 50, 5, 1.0), (256, 100, 50, 7, 1.0)], 1, [0]),      # below 0.9 of its peer
    ([(0, 120, 50, 9, 1.0), (256, 100, 50, 7, 1.0)], 1, [0]),       # late start: no spins
    ([(256, 40, 50, 3, 1.0), (256, 45, 50, 4, 1.0)], None, [0, 1]),  # under the launches
    ([(256, 0, 0, 0, 1.0)], None, [0]),                             # no device record
    ([(256, 95, 50, 6, 1.0), (256, 100, 50, 7, 1.0), (256, 89, 50, 5, 1.0)], 0, [2]),
    # one session's clock misread its work, low or high: the median
    ([(256, 100, 50, 7, 1.0), (256, 100, 50, 3, 1.0), (256, 100, 50, 8, 1.0)], 0, []),
    ([(256, 100, 50, 7, 1.0), (256, 100, 50, 7.2, 1.0), (256, 100, 50, 14, 1.0)], 1, []),
])
def test_pick_session_holds_each_session_to_its_peers(sessions, best, short):
    got, got_short = pick_session(sessions)
    assert got == (None if best is None else sessions[best])
    assert got_short == [sessions[i] for i in short]


def test_busy_above_window_is_refused():
    assert host_share(None, 5.0) is None and host_share(2.0, None) is None
    assert host_share(2.0, 8.0) == pytest.approx(0.75)
    assert host_share(8.0, 8.0) == 0.0
    with pytest.raises(ValueError, match="above"):
        host_share(12.0, 11.68)
    # busy is held to the profiled window of its own session; the stretch is
    # that window over the window timed without the profiler
    busy = dict(busy_ms=12.0, profiled_ms=11.68, records=40.0, sessions=3, short=[])
    row = busy_row(busy, 11.6)
    assert "11.68" in row["failed"] and row["busy_ms"] == 12.0 and "host_share" not in row
    row = busy_row(dict(busy, busy_ms=7.5, profiled_ms=30.0), 25.0)
    assert row["host_share"] == 0.75 and row["stretch"] == pytest.approx(1.2)
    assert "failed" not in row and row["records"] == 40.0
    # every session short: a failed row, with no share
    row = busy_row(dict(busy, busy_ms=None, profiled_ms=None, records=None,
                        short=[20.0] * 6, sessions=6), 3.0)
    assert "6 profiled sessions" in row["failed"] and "host_share" not in row


# ---------------------------------------------------------------------------
# the graph runner's pieces that run without a card (CPU)
# ---------------------------------------------------------------------------

def test_make_optimizer_is_capturable_only_for_cuda_params():
    opt = make_optimizer([torch.nn.Parameter(torch.zeros(3))], 1e-3, 0.01)
    assert opt.defaults["capturable"] is False
    assert (opt.defaults["weight_decay"], opt.defaults["betas"]) == (0.01, (0.9, 0.999))


@pytest.mark.parametrize("owner", ["trainer", "predictor", "population"])
def test_graphs_on_the_cpu_raise(owner):
    cfg = tiny_cfg()
    make = {"trainer": Trainer, "predictor": Predictor,
            "population": lambda c, **kw: Population(c, [Member(seed=0)], **kw)}[owner]
    assert make(cfg, device="cpu").graphs is False  # the CPU's default: eager
    with pytest.raises(ValueError, match="CUDA graphs"):
        make(cfg, device="cpu", graphs=True)


def test_no_capture_inside_plain_ops():
    assert not plain_active()
    with plain_ops():
        assert plain_active()
        with pytest.raises(RuntimeError, match="plain_ops"):
            GraphedCall(lambda: None)
    assert not plain_active()


def test_snapshot_undoes_steps_in_place():
    """What a capture's warm-up moves comes back to the same tensors: the
    parameters, Adam's state (zeroed where the warm-up made it) and the
    generator; a step after the restore equals the first step of a fresh
    trainer bit for bit."""
    def fresh():
        trainer = Trainer(tiny_cfg(), device="cpu")
        idx, valid = trainer.data.plan(trainer.generator, "train")
        return trainer, idx[0], valid[0]

    trainer, idx, valid = fresh()
    params = list(trainer.model.parameters())
    addresses = [p.data_ptr() for p in params]
    restore = snapshot(params, trainer.optimizer, [trainer.generator])
    for _ in range(2):
        trainer.train_batch(idx, valid)
    state_addresses = {k: v.data_ptr() for k, v in trainer.optimizer.state[params[0]].items()}
    restore()
    assert [p.data_ptr() for p in params] == addresses
    assert all(float(v.abs().max()) == 0.0 for s in trainer.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v))
    assert {k: v.data_ptr() for k, v in trainer.optimizer.state[params[0]].items()} \
        == state_addresses
    got = trainer.train_batch(idx, valid)
    ref, ref_idx, ref_valid = fresh()
    want = ref.train_batch(ref_idx, ref_valid)
    assert torch.equal(got, want)
    for (name, p), q in zip(trainer.model.named_parameters(), ref.model.parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad), name
    # and a saved state comes back as it was
    restore = snapshot(params, trainer.optimizer, [trainer.generator])
    saved = {k: v.clone() for k, v in trainer.optimizer.state[params[0]].items()}
    trainer.train_batch(idx, valid)
    restore()
    assert all(torch.equal(trainer.optimizer.state[params[0]][k], v) for k, v in saved.items())


def test_snapshot_undoes_population_steps_in_place():
    """`snapshot` over a population's MemberAdam (its `state`: the moments
    and the step count on the device): two steps undone in place, and the
    step after the restore equals a fresh population's first step bit for
    bit."""
    def fresh():
        pop = Population(tiny_cfg(), [Member(seed=0, lr=1e-3), Member(seed=1, lr=3e-4)],
                         device="cpu")
        idx, valid = pop.plans("train")
        return pop, idx[:, 0], valid[:, 0]

    pop, idx, valid = fresh()
    params = list(pop.model.parameters())
    restore = snapshot(params, pop.optimizer, pop.generators)
    state = pop.optimizer.state[params[0]]
    addresses = {k: v.data_ptr() for k, v in state.items()}
    for _ in range(2):
        pop.train_batch(idx, valid)
    assert float(state["step"]) == 2.0
    restore()
    assert float(state["step"]) == 0.0 and float(state["exp_avg_sq"].abs().max()) == 0.0
    assert {k: v.data_ptr() for k, v in state.items()} == addresses
    got = pop.train_batch(idx, valid)
    ref, ref_idx, ref_valid = fresh()
    assert torch.equal(got, ref.train_batch(ref_idx, ref_valid))
    for (name, p), q in zip(pop.model.named_parameters(), ref.model.parameters()):
        assert torch.equal(p, q), name


def test_bucket_sizes_and_service_warmup():
    assert bucket_sizes(256) == [1, 2, 4, 8, 16, 32, 64, 128, 256]
    assert bucket_sizes(200) == [1, 2, 4, 8, 16, 32, 64, 128, 200]
    assert all(bucket_size(n, 200) in bucket_sizes(200) for n in range(1, 201))
    service = TruncationService(tiny_cfg(), max_batch=8, device="cpu")
    try:
        assert service.warmup() == [1, 2, 4, 8]
        assert service.stats()["dispatches"] == 0  # a warm-up serves no request
    finally:
        service.close()


# ---------------------------------------------------------------------------
# the CPU epoch and the train CLI's trace (CPU)
# ---------------------------------------------------------------------------

def _eager_loop_epoch(trainer) -> dict:
    """The epoch loop `Trainer.run_epoch` replaced: every step issued from
    Python, the batch results stacked at the end."""
    data, generator = trainer.data, trainer.generator
    tr_idx, tr_valid = data.plan(generator, "train")
    te_idx, te_valid = data.plan(generator, "test")
    train = [train_step(trainer.model, trainer.optimizer, trainer.criterion,
                        trainer.model_name, data.x_train[idx], data.y_train[idx], valid,
                        generator, trainer.dtype)
             for idx, valid in zip(tr_idx, tr_valid)]
    test = [eval_step(trainer.model, trainer.criterion, trainer.model_name,
                      data.x_test[idx], data.y_test[idx], valid, trainer.dtype)
            for idx, valid in zip(te_idx, te_valid)]
    tr = torch.stack([torch.stack(s) for s in train]).cpu().numpy().astype(np.float64)
    te = torch.stack([torch.stack(s) for s in test]).cpu().numpy().astype(np.float64)
    metrics = {f"{split}_{name}": float(np.mean(values[:, i]))
               for split, values in (("train", tr), ("test", te))
               for i, name in enumerate(("loss", "f1", "dcg"))}
    metrics["train_loss_steps"] = tr[:, 0].tolist()
    return metrics


@pytest.mark.parametrize("model_name,compute_dtype", [
    ("mmoecut", "float32"), ("choopy", "float32"), ("attncut", "bfloat16")])
def test_cpu_run_epoch_equals_the_eager_loop(model_name, compute_dtype):
    cfg = tiny_cfg(model_name, compute_dtype=compute_dtype)
    got, want = Trainer(cfg, device="cpu"), Trainer(cfg, device="cpu")
    for _ in range(2):
        assert got.run_epoch() == _eager_loop_epoch(want)
    for (name, a), b in zip(got.model.state_dict().items(), want.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_train_cli_profile_dir_traces_epochs_1_to_3(tmp_path):
    """A tiny BiCut run (L 40) of 5 epochs with --profile-dir: one
    torch.profiler trace holding the spans of epochs 1, 2 and 3 alone."""
    out = main(["--model-name", "bicut", "--device", "cpu", "--retrieve-data", "mq2007",
                "--synthetic-queries", "8", "--batch-size", "4", "--epochs", "5",
                "--profile-dir", str(tmp_path)])
    assert out["config"]["epochs"] == 5
    trace = json.loads((tmp_path / "epochs.pt.trace.json").read_text())
    epochs = sorted({e["name"] for e in trace["traceEvents"]
                     if e.get("name", "").startswith("epoch ")})
    assert epochs == ["epoch 1", "epoch 2", "epoch 3"]


# ---------------------------------------------------------------------------
# on the card: graphed against eager
# ---------------------------------------------------------------------------

def _card_trainer(model_name, compute_dtype, graphs):
    cfg = apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04",
                                   compute_dtype=compute_dtype))
    data = synthetic_dataset(num_queries=160, seq_len=cfg.seq_len,
                             num_features=cfg.input_size, seed=cfg.seed)
    return Trainer(cfg, data=data, device="cuda", graphs=graphs)


def _counts():
    return {name: k.launches for name, k in KERNELS.items()}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_name", ["mmoecut", "mtple", "choopy", "bicut"])
def test_graphed_train_steps_equal_eager_on_card(cuda_device, model_name, compute_dtype):
    """Three graphed steps from a fresh Trainer, dropout on, against three
    eager steps from another with the same seed: the step results, the
    gradients, the parameters and Adam's state bit for bit; then a test
    batch. Each replay launches what one eager step launches."""
    graphed = _card_trainer(model_name, compute_dtype, True)
    eager = _card_trainer(model_name, compute_dtype, False)
    assert graphed.cfg.dropout > 0.0 and graphed.optimizer.defaults["capturable"]
    plans = [t.data.plan(t.generator, "train") for t in (graphed, eager)]
    assert all(torch.equal(a, b) for a, b in zip(*plans))
    idx, valid = plans[0]
    for s in range(3):
        before = _counts()
        got = graphed.train_batch(idx[s], valid[s])
        torch.cuda.synchronize()
        graphed_launches = {k: n - before[k] for k, n in _counts().items()}
        before = _counts()
        want = eager.train_batch(idx[s], valid[s])
        torch.cuda.synchronize()
        assert graphed_launches == {k: n - before[k] for k, n in _counts().items()}
        assert torch.equal(got, want), (s, got, want)
    for (name, p), q in zip(graphed.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad), name
        for key, v in graphed.optimizer.state[p].items():
            assert torch.equal(v, eager.optimizer.state[q][key]), (name, key)
    te_idx, te_valid = [t.data.plan(t.generator, "test") for t in (graphed, eager)][0]
    assert torch.equal(graphed.test_batch(te_idx[0], te_valid[0]),
                       eager.test_batch(te_idx[0], te_valid[0]))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_name", ["mmoecut", "mtple", "choopy", "bicut"])
def test_graphed_population_steps_equal_eager_on_card(cuda_device, model_name,
                                                      compute_dtype):
    """Three graphed population steps of two members, dropout on, against
    three eager ones: the (K, 3) results, gradients, parameters and
    MemberAdam's state bit for bit, then a test batch; each replay launches
    what one eager population step launches, which is one sequential
    step's."""
    cfg = apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04",
                                   compute_dtype=compute_dtype))
    cfg = dataclasses.replace(cfg, dropout=cfg.dropout or 0.1)
    data = synthetic_dataset(num_queries=160, seq_len=cfg.seq_len,
                             num_features=cfg.input_size, seed=cfg.seed)
    members = [Member(seed=0, lr=1e-3), Member(seed=1, lr=3e-4, weight_decay=0.01)]
    graphed, eager = (Population(cfg, members, data=data, device="cuda", graphs=g)
                      for g in (True, False))
    plans = [p.plans("train") for p in (graphed, eager)]
    assert all(torch.equal(a, b) for a, b in zip(*plans))
    idx, valid = plans[0]
    for s in range(3):
        launches = []
        for p in (graphed, eager):
            before = _counts()
            out = p.train_batch(idx[:, s], valid[:, s])
            torch.cuda.synchronize()
            launches.append(({k: n - before[k] for k, n in _counts().items()}, out))
        (got_launches, got), (want_launches, want) = launches
        assert got_launches == want_launches and torch.equal(got, want), s
    for (name, p), q in zip(graphed.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad), name
        for key, v in graphed.optimizer.state[p].items():
            assert torch.equal(v, eager.optimizer.state[q][key]), (name, key)
    te = [p.plans("test") for p in (graphed, eager)]
    assert torch.equal(graphed.test_batch(te[0][0][:, 0], te[0][1][:, 0]),
                       eager.test_batch(te[1][0][:, 0], te[1][1][:, 0]))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_name", ["mmoecut", "choopy"])
def test_graphed_buckets_equal_eager_on_card(cuda_device, model_name, compute_dtype):
    cfg = TrainConfig(model_name=model_name, retrieve_data="robust04",
                      compute_dtype=compute_dtype)
    graphed = Predictor(cfg, device="cuda")
    eager = Predictor(cfg, state_dict=graphed.model.state_dict(), device="cuda",
                      graphs=False)
    assert graphed.graphs
    rng = np.random.default_rng(5)
    for b in bucket_sizes(256):
        x = torch.from_numpy(rng.normal(size=(b, cfg.seq_len, cfg.input_size))
                             .astype(np.float32)).to(cuda_device)
        graphed.prepare(b)
        before = _counts()
        ks, dist = (t.clone() for t in graphed._forward(x))
        launches = {k: n - before[k] for k, n in _counts().items()}
        before = _counts()
        want_ks, want_dist = eager._forward(x)
        assert launches == {k: n - before[k] for k, n in _counts().items()}
        assert torch.equal(ks, want_ks) and torch.equal(dist, want_dist), b


def test_replay_inside_plain_ops_raises_on_card(cuda_device):
    predictor = Predictor(TrainConfig(model_name="bicut", retrieve_data="robust04"),
                          device="cuda")
    x = torch.zeros(8, predictor.cfg.seq_len, predictor.cfg.input_size, device=cuda_device)
    predictor._forward(x)
    with plain_ops():
        with pytest.raises(RuntimeError, match="plain_ops"):
            predictor._forward(x)
    trainer = _card_trainer("bicut", "float32", True)
    idx, valid = trainer.data.plan(trainer.generator, "train")
    trainer.train_batch(idx[0], valid[0])
    with plain_ops():
        with pytest.raises(RuntimeError, match="plain_ops"):
            trainer.train_batch(idx[1], valid[1])


def test_make_optimizer_is_capturable_on_card(cuda_device):
    p = torch.nn.Parameter(torch.zeros(3, device=cuda_device))
    assert make_optimizer([p], 1e-3, 0.0).defaults["capturable"] is True


def test_train_cli_profile_dir_on_card(cuda_device, tmp_path):
    main(["--model-name", "bicut", "--synthetic-queries", "70", "--epochs", "4",
          "--profile-dir", str(tmp_path)])
    trace = json.loads((tmp_path / "epochs.pt.trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert {"epoch 1", "epoch 2", "epoch 3"} <= names and "epoch 0" not in names
    assert any(e.get("cat") == "kernel" for e in trace["traceEvents"])


def test_trainer_run_graphed_equals_eager_on_card(cuda_device):
    """Two epochs of `Trainer.run_epoch`, graphed against eager: the epoch
    metrics equal."""
    graphed, eager = (_card_trainer("attncut", "bfloat16", g) for g in (True, False))
    for _ in range(2):
        assert graphed.run_epoch() == eager.run_epoch()
    assert dataclasses.asdict(graphed.cfg) == dataclasses.asdict(eager.cfg)
