"""One CUDA graph per step and per serving bucket (rlt_tpu_torch/utils/graphs.py)
and the busy time of the card as the union of its device intervals
(rlt_tpu_torch/utils/timing.py).

The CPU tests hold what runs without a card: the interval union on
synthetic intervals, the refusal of a busy time above its window, Adam
capturable only on CUDA parameters, graphs refused on the CPU and inside
`plain_ops()`, the snapshot that undoes a warm-up's steps in place, the
serving buckets, `--profile-dir`'s trace of epochs 1-3, and the CPU epoch
(eager) equal to the loop it replaced. The tests that take the
`cuda_device` fixture need a card and skip without one: graphed against
eager, bit for bit, for train steps and bucket forwards in both dtypes; the
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
from rlt_tpu_torch.serve import TruncationService, bucket_size, bucket_sizes
from rlt_tpu_torch.train import Trainer, eval_step, main, make_optimizer, train_step
from rlt_tpu_torch.utils.graphs import GraphedCall, snapshot
from rlt_tpu_torch.utils.timing import busy_row, host_share, session_busy_ns, union_ns


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


def test_busy_above_window_is_refused():
    assert host_share(None, 5.0) is None and host_share(2.0, None) is None
    assert host_share(2.0, 8.0) == pytest.approx(0.75)
    assert host_share(8.0, 8.0) == 0.0
    with pytest.raises(ValueError, match="above"):
        host_share(12.0, 11.68)
    row = busy_row(12.0, 11.68)
    assert "11.68" in row["failed"] and row["busy_ms"] == 12.0 and "host_share" not in row
    assert busy_row(7.5, 30.0) == {"busy_ms": 7.5, "host_share": 0.75}
    assert busy_row(None, 3.0) == {"busy_ms": None, "host_share": None}


# ---------------------------------------------------------------------------
# the graph runner's pieces that run without a card (CPU)
# ---------------------------------------------------------------------------

def test_make_optimizer_is_capturable_only_for_cuda_params():
    opt = make_optimizer([torch.nn.Parameter(torch.zeros(3))], 1e-3, 0.01)
    assert opt.defaults["capturable"] is False
    assert (opt.defaults["weight_decay"], opt.defaults["betas"]) == (0.01, (0.9, 0.999))


@pytest.mark.parametrize("owner", ["trainer", "predictor"])
def test_graphs_on_the_cpu_raise(owner):
    cfg = tiny_cfg()
    make = Trainer if owner == "trainer" else Predictor
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
