"""The port's training remainder and verification harnesses against the JAX
package's, on the CPU: verify_bmt's records on replayed plans, the probing
harness's two phases, `--resume` (3 + 2 epochs against 5, bit for bit),
the metrics log, `--draw`, and the CLIs of baselines, verify_bmt and
verify_probe.

Comparisons with the JAX package run at dropout 0 on the JAX package's
weights and batch plans (`jax.random.permutation`, which torch cannot
draw); the resume checks compare the port with itself, dropout on.
"""

import dataclasses
import json
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu import config as jax_config
from rlt_tpu import verify_bmt as jax_verify_bmt
from rlt_tpu.data import batching as jax_batching
from rlt_tpu.models import AttnCut as JaxAttnCut
from rlt_tpu.models import Choopy as JaxChoopy
from rlt_tpu.models import TaskC as JaxTaskC
from rlt_tpu.models import TaskR as JaxTaskR
from rlt_tpu.utils import logging as jax_logging
from rlt_tpu.utils import plots as jax_plots
from rlt_tpu_torch import train, verify_bmt, verify_probe
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.data import synthetic_dataset
from rlt_tpu_torch.utils import logging as port_logging
from rlt_tpu_torch.utils import plots
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
L = 12
# verify_bmt's per-epoch records (the train metric: AUC or rerank DCG, the
# mean of the steps' pre-update metrics) against the JAX package's on its
# plans and weights: test_torch_train.py's EPOCH_METRIC_ATOL. The forwards
# agree to f32 rounding (HEAD_ATOL there), the AUC counts pairs exactly and
# the DCG sorts the scores, so the records are equal up to the f32 means,
# unless two scores of a list lie within the forwards' gap.
EPOCH_METRIC_ATOL = 1e-6


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The metrics log without its TensorBoard mirror: where TensorFlow is
    installed, torch.utils.tensorboard imports it, seconds a process."""
    monkeypatch.setattr(port_logging, "_summary_writer", lambda log_dir: None)


# ---------------------------------------------------------------------------
# verify_bmt: per-epoch records on the JAX package's plans and weights
# ---------------------------------------------------------------------------

def _bmt_case(model_name: str, verify_type: str, ft: bool, tmp_path):
    """JAX's run_verification and the port's BMTVerifier from the same head,
    trunk and plans; both records."""
    features = 1 if model_name == "choopy" else 3
    cfg_kw = dict(model_name=model_name, seq_len_override=L, input_size_override=features,
                  synthetic_queries=20, batch_size=8, epochs=2, lr=1e-3, weight_decay=0.005,
                  dropout=0.0, seed=3)
    data = synthetic_dataset(num_queries=20, seq_len=L, num_features=features,
                             mean_relevant=4.0, seed=2)
    want = jax_verify_bmt.run_verification(
        jax_config.TrainConfig(**cfg_kw, use_pallas=False), verify_type, ft, data=data)

    # the JAX harness's initialisations and plans (verify_bmt.py:85-150)
    cfg = TrainConfig(**cfg_kw)
    if ft:
        model = (JaxAttnCut(input_size=features, dropout=0.0) if model_name == "attncut"
                 else JaxChoopy(seq_len=L, dropout=0.0))
        key = jax.random.PRNGKey(cfg.seed)
        trunk = jax.jit(model.init)({"params": key, "dropout": key},
                                    jnp.zeros((1, L, features)))["params"]
        path = tmp_path / f"{model_name}.pt"
        torch.save(params_from_jax(_np_tree(trunk)), path)
        cfg = dataclasses.replace(cfg, model_path=str(path))
    feat_dim = (128 if model_name == "choopy" else 256) if ft else features
    head = JaxTaskC() if verify_type == "c" else JaxTaskR()
    head_params = head.init(jax.random.PRNGKey(cfg.seed + 1), jnp.zeros((1, L, feat_dim)))
    verifier = verify_bmt.BMTVerifier(cfg, verify_type, ft, data=data, device="cpu")
    verifier.head.load_state_dict(params_from_jax(_np_tree(head_params["params"])))
    key = jax.random.PRNGKey(cfg.seed + 2)
    got = []
    for _ in range(cfg.epochs):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        plans = [tuple(np.asarray(a) for a in jax_batching.epoch_permutation(k, n, 8))
                 for k, n in ((k1, verifier.data.n_train), (k2, verifier.data.n_test))]
        got.append(verifier.run_epoch(*plans)["train_metric"])
    return got, want


@pytest.mark.parametrize("model_name,verify_type,ft", [
    ("attncut", "c", False), ("attncut", "r", False),
    ("attncut", "c", True), ("attncut", "r", True),
    ("choopy", "c", True), ("choopy", "r", True)])
def test_verify_bmt_records_match_jax(model_name, verify_type, ft, tmp_path):
    got, want = _bmt_case(model_name, verify_type, ft, tmp_path)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=EPOCH_METRIC_ATOL)
    if verify_type == "c":
        assert all(0.0 <= m <= 1.0 for m in got)


def test_verify_bmt_refuses_a_trunk_it_does_not_have():
    cfg = TrainConfig(model_name="mmoecut", seq_len_override=L, synthetic_queries=10,
                      batch_size=4)
    with pytest.raises(ValueError, match="trunk"):
        verify_bmt.BMTVerifier(cfg, "c", ft=True, device="cpu")
    with pytest.raises(ValueError, match="verify_type"):
        verify_bmt.BMTVerifier(cfg, "x", device="cpu")


# ---------------------------------------------------------------------------
# verify_probe: both phases
# ---------------------------------------------------------------------------

def test_probe_trainer_runs_both_phases(tmp_path):
    """Two epochs a phase: the base's records and its best weights on disk,
    the probes' step metrics finite (AUC in [0, 1]), the log's rows; `--ft`
    probes the saved base without phase 1."""
    cfg = TrainConfig(model_name="probe_base", seq_len_override=L, input_size_override=3,
                      synthetic_queries=20, batch_size=8, lr=1e-3, weight_decay=0.0,
                      dropout=0.1, save_path=str(tmp_path / "best"),
                      log_dir=str(tmp_path / "runs"))
    data = synthetic_dataset(num_queries=20, seq_len=L, num_features=3, mean_relevant=4.0)
    trainer = verify_probe.ProbeTrainer(cfg, epochs_base=2, epochs_probe=2, data=data,
                                        device="cpu")
    curves = trainer.run()
    assert len(trainer.f1_record) == 2 and len(curves) == 2
    steps = trainer.data.train_batches
    for per_step in curves:
        assert per_step.shape == (steps, 6) and np.all(np.isfinite(per_step))
        assert np.all((per_step[:, 0::2] >= 0) & (per_step[:, 0::2] <= 1))
    rows = [json.loads(line) for line in
            (tmp_path / "runs" / "probe" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows[:2]] == [0, 1] and "base_test_f1" in rows[0]
    assert len(rows) == 2 + 2 * steps
    assert set(rows[-1]) == {"epoch", "time", *verify_probe.PROBE_TAGS}
    saved = tmp_path / "best" / "probe_base.pt"
    assert saved.is_file()
    again = verify_probe.ProbeTrainer(dataclasses.replace(cfg, model_path=str(saved),
                                                          log_dir=None),
                                      epochs_base=2, epochs_probe=1, data=data, device="cpu")
    assert len(again.run(ft=True)) == 1 and again.f1_record == []


# ---------------------------------------------------------------------------
# --resume: 3 epochs and 2 more are the 5 epochs, bit for bit
# ---------------------------------------------------------------------------

def _resume_cfg(tmp_path, dtype: str, **kw) -> TrainConfig:
    return TrainConfig(model_name="mmoecut", seq_len_override=16, synthetic_queries=24,
                       batch_size=8, dropout=0.1, lr=1e-3, weight_decay=0.005,
                       compute_dtype=dtype, model_persist=True, save_path=str(tmp_path),
                       **kw)


def _adam_state(trainer) -> dict:
    return {name: {k: v.clone() for k, v in trainer.optimizer.state[p].items()}
            for name, p in trainer.model.named_parameters()}


def _assert_resumed_as_whole(resumed, summary, whole) -> None:
    """The resumed epochs 3 and 4, parameters, Adam's state, generator,
    records and summary equal the uninterrupted run's, bit for bit."""
    assert len(resumed.history) == 2
    for epoch in (3, 4):
        assert resumed.history[epoch - 3] == whole.history[epoch], epoch
    for (name, p), q in zip(resumed.model.named_parameters(), whole.model.parameters()):
        assert torch.equal(p, q), name
    got, want = _adam_state(resumed), _adam_state(whole)
    for name in want:
        assert set(got[name]) == set(want[name]) == {"step", "exp_avg", "exp_avg_sq"}
        for k in want[name]:
            assert torch.equal(got[name][k], want[name][k]), (name, k)
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
    assert (resumed.f1_record, resumed.dcg_record) == (whole.f1_record, whole.dcg_record)
    assert summary == whole.summary()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_equals_the_uninterrupted_run(dtype, tmp_path):
    whole = train.Trainer(_resume_cfg(tmp_path / "whole", dtype, epochs=5), device="cpu")
    whole.run()
    first = train.Trainer(_resume_cfg(tmp_path / "split", dtype, epochs=3), device="cpu")
    first.run()
    second = train.Trainer(_resume_cfg(tmp_path / "split", dtype, epochs=5), device="cpu")
    summary = second.run(resume=True)
    _assert_resumed_as_whole(second, summary, whole)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_into_a_trainer_that_has_trained(dtype, tmp_path):
    """Restoring in place into a Trainer that has run an epoch already (its
    parameters, Adam's state and generator moved; on the card its graphs
    captured over them) goes on as the uninterrupted run, bit for bit."""
    whole = train.Trainer(_resume_cfg(tmp_path / "whole", dtype, epochs=5), device="cpu")
    whole.run()
    train.Trainer(_resume_cfg(tmp_path / "split", dtype, epochs=3), device="cpu").run()
    rewound = train.Trainer(_resume_cfg(tmp_path / "split", dtype, epochs=5), device="cpu")
    rewound.run_epoch()
    assert not torch.equal(rewound.generator.get_state(),
                           torch.Generator().manual_seed(rewound.cfg.seed).get_state())
    summary = rewound.run(resume=True)
    _assert_resumed_as_whole(rewound, summary, whole)


def test_resuming_a_finished_run_runs_no_epoch(tmp_path):
    """As the JAX package's tests/test_train.py:230-256: the records and
    bests come back, no epoch runs; a state file the run does not have
    starts from epoch 0."""
    cfg = _resume_cfg(tmp_path, "float32", epochs=3)
    done = train.Trainer(cfg, device="cpu")
    done.run()
    again = train.Trainer(cfg, device="cpu")
    summary = again.run(resume=True)
    assert again.history == [] and len(again.f1_record) == 3
    assert summary["best_f1"] == max(done.f1_record) == done.best_test_f1
    assert summary == done.summary()
    for p, q in zip(again.model.parameters(), done.model.parameters()):
        assert torch.equal(p, q)
    fresh = train.Trainer(dataclasses.replace(cfg, save_path=str(tmp_path / "none"),
                                              epochs=1), device="cpu")
    fresh.run(resume=True)
    assert len(fresh.history) == 1


# ---------------------------------------------------------------------------
# --log-dir and --draw
# ---------------------------------------------------------------------------

def _rows(path: Path) -> list[dict]:
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for row in rows:
        row.pop("time", None)
    return rows


def test_metrics_log_rows_equal_the_jax_writers(tmp_path):
    """The Trainer's JSONL rows equal the JAX package's MetricsWriter's fed
    the same metrics in the JAX trainer's order (train.py:415-419, 459-466),
    but for each row's wall time."""
    cfg = TrainConfig(model_name="attncut", seq_len_override=16, synthetic_queries=24,
                      batch_size=8, epochs=2, log_dir=str(tmp_path / "port"))
    trainer = train.Trainer(cfg, device="cpu")
    summary = trainer.run()
    writer = jax_logging.MetricsWriter(str(tmp_path / "jax"), run_name="attncut",
                                       tensorboard=False)
    for epoch, metrics in enumerate(trainer.history):
        metrics = dict(metrics)
        steps = metrics.pop("train_loss_steps")
        for s, loss in enumerate(steps):
            writer.log_step(epoch * len(steps) + s, "train/loss_step", loss)
        writer.log(epoch, metrics)
    writer.log_summary({k: v for k, v in summary.items() if k != "compute_dtype"})
    writer.close()
    got = _rows(tmp_path / "port" / "attncut" / "metrics.jsonl")
    assert got == _rows(tmp_path / "jax" / "attncut" / "metrics.jsonl")
    assert len(got) == 2 * (trainer.data.train_batches + 1) + 1


class _RecordingSummaryWriter:
    """A SummaryWriter's add_scalar and close, recorded."""

    def __init__(self, log_dir: str):
        self.log_dir, self.calls = log_dir, []

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, value, step))

    def close(self):
        self.calls.append("close")


def test_metrics_log_mirror_gets_the_jax_writers_scalars(tmp_path, monkeypatch):
    """Where a SummaryWriter is there, the port's writer mirrors the JAX
    writer's (tag, value, step) calls in its tag vocabulary, into its run
    directory, and closes it."""
    writers = {}

    def recorder(name):
        def make(log_dir):
            writers[name] = _RecordingSummaryWriter(log_dir)
            return writers[name]
        return make

    monkeypatch.setattr(port_logging, "_summary_writer", recorder("port"))
    monkeypatch.setattr(jax_logging, "_try_summary_writer", recorder("jax"))
    metrics = {"train_loss": 0.5, "train_f1": 0.25, "test_dcg": 1.5, "lr": 1e-3}
    for name, cls in (("port", port_logging.MetricsWriter),
                      ("jax", jax_logging.MetricsWriter)):
        writer = cls(str(tmp_path / name), run_name="attncut")
        writer.log_step(3, "train/loss_step", 0.75)
        writer.log(1, metrics)
        writer.close()
        assert writers[name].log_dir == str(tmp_path / name / "attncut")
    assert writers["port"].calls == writers["jax"].calls
    assert writers["port"].calls == [
        ("train/loss_step", 0.75, 3), ("train/loss_epoch", 0.5, 1),
        ("train/F1_epoch", 0.25, 1), ("test/DCG_epoch", 1.5, 1), ("lr", 1e-3, 1), "close"]


REWARD_RGB, PREDICTION_RGB = (50, 205, 50), (123, 104, 238)


def _png_pixels(path) -> np.ndarray:
    """An 8-bit RGB PNG of unfiltered rows, as `plots.plain_figure` writes
    it, as an (H, W, 3) array."""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    width, height = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    assert data[24:29] == bytes([8, 2, 0, 0, 0])  # 8 bits, RGB
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, 1 + 3 * width)
    assert np.all(rows[:, 0] == 0)
    return rows[:, 1:].reshape(height, width, 3)


def test_draw_curves_match_jax():
    rng = np.random.default_rng(13)
    y = (rng.random((10, 20)) < 0.3).astype(np.float32)
    p = rng.random((10, 20)).astype(np.float32)
    p /= p.sum(axis=1, keepdims=True)
    for metric in ("f1", "dcg"):
        for got, want in zip(plots.reward_and_prediction_curves(y, p, metric),
                             jax_plots.reward_and_prediction_curves(y, p, metric)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("model_name", ["bicut", "mmoecut"])
def test_draw_writes_the_figure(model_name, tmp_path, monkeypatch):
    """Every second epoch from 0 through the eval path in batches: BiCut's
    argmax decisions, a multi-head model's last head."""
    monkeypatch.chdir(tmp_path)
    cfg = TrainConfig(model_name=model_name, seq_len_override=16, synthetic_queries=24,
                      batch_size=3, epochs=3, draw=True)
    trainer = train.Trainer(cfg, device="cpu")
    cuts = trainer.test_predictions()
    assert cuts.shape == (trainer.data.n_test, 16) and cuts.dtype == np.float32
    if model_name == "bicut":
        assert set(np.unique(cuts)) <= {0.0, 1.0}
    else:
        np.testing.assert_allclose(cuts.sum(axis=1), 1.0, atol=1e-5)
    trainer.run()
    figs = sorted(p.name for p in (tmp_path / "figs").iterdir())
    assert figs == [f"{model_name}_js_ar_0.png", f"{model_name}_js_ar_2.png"]
    for name in figs:
        pixels = _png_pixels(tmp_path / "figs" / name)
        for color in (REWARD_RGB, PREDICTION_RGB):
            assert np.all(pixels == color, axis=-1).any(), (name, color)


def test_train_cli_resume_log_dir_and_draw(tmp_path, monkeypatch, capsys):
    """`--model-persist 1 --log-dir --draw 1` for 2 epochs, then `--resume 1`
    for 3: the figure of epoch 0, the state after each epoch, the log's
    rows of both runs; the flags are no longer listed as absent."""
    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu", "--retrieve-data", "mq2007", "--synthetic-queries", "16",
            "--batch-size", "8", "--model-persist", "1", "--save-path", str(tmp_path),
            "--log-dir", str(tmp_path / "runs"), "--draw", "1"]
    train.main(base + ["--epochs", "2"])
    summary = train.main(base + ["--epochs", "3", "--resume", "1"])
    assert np.isfinite(summary["best_f1"])
    state = torch.load(tmp_path / "mmoecut.trainstate.pt", weights_only=True)
    assert state["epoch"] == 2
    assert json.loads((tmp_path / "mmoecut.records.json").read_text())["f1_record"].__len__() == 3
    assert sorted(p.name for p in (tmp_path / "figs").iterdir()) == [
        "mmoecut_js_ar_0.png", "mmoecut_js_ar_2.png"]
    rows = _rows(tmp_path / "runs" / "mmoecut" / "metrics.jsonl")
    assert [r["epoch"] for r in rows if "epoch" in r] == [0, 1, 2]
    assert sum("summary" in r for r in rows) == 2
    epilog = train.build_argparser().epilog
    assert "--data-parallel" in epilog
    assert not any(flag in epilog for flag in ("--resume", "--draw", "--log-dir"))


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def test_verify_bmt_cli_on_cpu(tmp_path):
    """`python -m rlt_tpu_torch.verify_bmt --device cpu` prints its record
    as the last line."""
    cmd = [sys.executable, "-m", "rlt_tpu_torch.verify_bmt", "--device", "cpu",
           "--retrieve-data", "mq2007", "--synthetic-queries", "16", "--batch-size", "8",
           "--epochs", "2", "--verify-type", "c"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=ONE_THREAD_ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu" and len(out["record"]) == 2
    assert all(0.0 <= m <= 1.0 for m in out["record"])


def test_verify_bmt_cli_frozen_trunk_from_a_trainer(tmp_path, capsys):
    """`--ft 1 --model-path` takes the state_dict a Trainer wrote."""
    train.main(["--device", "cpu", "--model-name", "choopy", "--retrieve-data", "mq2007",
                "--synthetic-queries", "16", "--batch-size", "8", "--epochs", "1",
                "--model-persist", "1", "--save-path", str(tmp_path)])
    record = verify_bmt.main(["--device", "cpu", "--model-name", "choopy", "--ft", "1",
                              "--model-path", str(tmp_path / "choopy.pt"),
                              "--retrieve-data", "mq2007", "--synthetic-queries", "16",
                              "--batch-size", "8", "--epochs", "1"])
    assert len(record) == 1 and np.isfinite(record[0])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ft"] is True


def test_verify_probe_cli_on_cpu(tmp_path, capsys):
    summary = verify_probe.main(["--device", "cpu", "--retrieve-data", "mq2007",
                                 "--synthetic-queries", "16", "--batch-size", "8",
                                 "--epochs-base", "1", "--epochs-probe", "1",
                                 "--ft", "0", "--save-path", str(tmp_path)])
    assert summary["device"] == "cpu" and len(summary["base_f1_record"]) == 1
    assert set(summary["probes"]) == {tag.split("/")[1] for tag in verify_probe.PROBE_TAGS}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert (tmp_path / "probe_base.pt").is_file()


@pytest.mark.parametrize("module", ["verify_bmt", "verify_probe"])
def test_harness_clis_default_to_the_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    main, epochs = {"verify_bmt": (verify_bmt.main, ["--epochs", "1"]),
                    "verify_probe": (verify_probe.main, ["--epochs-base", "1"])}[module]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--retrieve-data", "mq2007", "--synthetic-queries", "8"] + epochs)


def test_every_port_module_imports_no_jax():
    """In a fresh interpreter, every module of the port (the harnesses and
    their utilities among them) imports without jax, flax, optax or rlt_tpu,
    and without matplotlib or TensorBoard, which load where they are used."""
    code = """
import importlib, pkgutil, sys
import rlt_tpu_torch
for info in pkgutil.walk_packages(rlt_tpu_torch.__path__, 'rlt_tpu_torch.'):
    importlib.import_module(info.name)
bad = sorted(m for m in sys.modules if m.split('.')[0] in
             ('jax', 'jaxlib', 'flax', 'optax', 'rlt_tpu', 'matplotlib', 'tensorboard',
              'tensorflow'))
assert not bad, bad
assert 'rlt_tpu_torch.verify_probe' in sys.modules
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=ONE_THREAD_ENV)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_snapshot_zeroes_a_state_made_after_it():
    """`utils.graphs.snapshot` restores what it saved and zeroes what Adam
    made after it, also where the optimizer's state (a defaultdict) held an
    empty entry for the parameter at the save, as a lookup leaves it."""
    from rlt_tpu_torch.utils.graphs import snapshot

    p = torch.nn.Parameter(torch.ones(3))
    opt = train.make_optimizer([p], 1e-3, 0.0)
    assert opt.state[p] == {}  # the lookup leaves an empty entry
    restore = snapshot([p], opt)
    p.grad = torch.ones(3)
    opt.step()
    restore()
    assert torch.equal(p.detach(), torch.ones(3))
    assert all(torch.count_nonzero(v) == 0 for v in opt.state[p].values())
    assert set(opt.state[p]) == {"step", "exp_avg", "exp_avg_sq"}


def test_draw_without_matplotlib_writes_a_plain_png(tmp_path, monkeypatch):
    """The figure needs no plotting package (the card's machine has none):
    with matplotlib unimportable it is a valid 1200 x 600 RGB PNG, both
    curves drawn on one y scale inside a 40-pixel margin, the prediction
    (drawn last) through each of its points."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    rng = np.random.default_rng(14)
    y = (rng.random((6, 20)) < 0.3).astype(np.float32)
    p = rng.random((6, 20)).astype(np.float32)
    path = plots.plot_reward_vs_prediction(y, p, metric="f1", epoch=2, model_name="attncut",
                                           div_type="js", aug_reward=False,
                                           out_dir=str(tmp_path))
    assert path == str(tmp_path / "attncut_js_dr_2.png")
    pixels = _png_pixels(path)
    assert pixels.shape == (600, 1200, 3)
    for color in (REWARD_RGB, PREDICTION_RGB):
        assert np.all(pixels == color, axis=-1).sum() > 1200
    curves = plots.reward_and_prediction_curves(y, p, "f1")
    lo, hi = min(c.min() for c in curves), max(c.max() for c in curves)
    xs = np.rint(40 + np.arange(20) * 1120 / 19).astype(int)
    ys = np.rint(560 - (curves[1] - lo) / (hi - lo) * 520).astype(int)
    assert np.all(pixels[ys, xs] == PREDICTION_RGB)
