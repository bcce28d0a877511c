"""The port's training path against the JAX package's, on the CPU.

MMOECut's training forward and `mtcut_loss` gradients on copied weights,
Adam with coupled L2 against the optax chain, and a whole epoch replayed on
the batch plan the JAX package's `epoch_fn` draws. Whole-model comparisons
run at dropout 0: the port's dropout bits are torch's, not `jax.random`'s
(the kernels' attention mask is bit-exact, tests/test_torch_ops.py). The
JAX side runs its plain path (`pallas_supported()` is false on the CPU).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlt_tpu import config as jax_config
from rlt_tpu import train as jax_train
from rlt_tpu.data import batching as jax_batching
from rlt_tpu.models import build_model as jax_build_model
from rlt_tpu_torch import train
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.data import DeviceDataset, epoch_permutation, synthetic_dataset
from rlt_tpu_torch.infer import Predictor
from rlt_tpu_torch.models import build_model, layers
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

# Heads in training mode at dropout 0: as the eval comparison of
# tests/test_torch_models.py (f32 sums in another order, flax LayerNorm's
# E[x^2] - E[x]^2 variance), probabilities in [0, 1].
HEAD_ATOL = 1e-5
# mtcut_loss gradient of each parameter, relative to the parameter's
# gradient max abs: the gates contract 2 * 128 * L BiLSTM outputs, and the
# LayerNorm variance formulas differ in the last bits, which the backward
# through both LayerNorms and the 16-step BiLSTM chains carries. Plus an
# absolute floor: a softmax tower's bias has zero gradient by algebra (the
# softmax is shift-invariant), where both sides give rounding noise ~1e-10.
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-7


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _max_rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# Dropout layers
# ---------------------------------------------------------------------------

def test_relu_dropout_backward_matches_autograd():
    """ReluDropout's output-residual backward equals autograd through
    relu(x) * mask / keep, bit for bit."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 7, 11)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, 7, 11)) < 0.8)
    g = torch.from_numpy(rng.normal(size=(3, 7, 11)).astype(np.float32))
    keep = 0.8
    xa = x.clone().requires_grad_()
    h = layers.ReluDropout.apply(xa, mask, keep)
    h.backward(g)
    xb = x.clone().requires_grad_()
    want = torch.relu(xb) * mask / keep
    want.backward(g)
    assert torch.equal(h, want.detach())
    assert torch.equal(xa.grad, xb.grad)


def test_dropout_masks_follow_the_generator():
    """16-bit scheme: about `keep` of the units survive, scaled by 1 / keep;
    the same generator seed gives the same mask; no generator, no masks."""
    x = torch.ones(64, 300)
    a = layers.dropout(x, 0.1, torch.Generator().manual_seed(3))
    b = layers.dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    assert torch.allclose(a[kept], torch.tensor(1 / 0.9))
    with pytest.raises(ValueError, match="torch.Generator"):
        layers.dropout(x, 0.1, None)


# ---------------------------------------------------------------------------
# MMOECut training forward and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mmoecut16_nodrop():
    model = jax_build_model("mmoecut", seq_len=16, input_size=3, dropout=0.0,
                            use_pallas=False)
    key = jax.random.PRNGKey(4)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((1, 16, 3), jnp.float32))["params"]
    return model, params


def test_mmoecut_training_grads_match_jax(jax_mmoecut16_nodrop):
    """Training-mode heads and the gradient of mtcut_loss for every
    parameter against jax.value_and_grad, on copied weights at dropout 0."""
    jax_model, params = jax_mmoecut16_nodrop
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 16, 3)).astype(np.float32)
    y = (rng.random((3, 16)) < 0.3).astype(np.float32)
    y[:, 0] = 1.0
    valid = np.array([1, 1, 0], np.float32)
    kw = dict(metric="dcg", rerank_weight=0.5, classi_weight=0.5, num_tasks=3)

    def jax_loss(p):
        out = jax_model.apply({"params": p}, jnp.asarray(x), deterministic=False)
        return (jax_train.losses_lib.mtcut_loss(out, jnp.asarray(y),
                                                valid=jnp.asarray(valid), **kw), out)

    (want_loss, want_heads), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    model = build_model("mmoecut", seq_len=16, input_size=3, dropout=0.0)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    model.train()
    heads = model(torch.from_numpy(x))
    for g, w in zip(heads, want_heads):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=HEAD_ATOL)
    loss = train.make_criterion(TrainConfig(model_name="mmoecut", criterion="dcg"))(
        heads, torch.from_numpy(y), valid=torch.from_numpy(valid))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    want = params_from_jax(_np_tree(want_grads))
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + GRAD_FLOOR, name


def test_training_forward_needs_a_generator_and_draws_from_it():
    model = build_model("mmoecut", seq_len=16, input_size=3, dropout=0.1)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 16, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
    a = model(x, torch.Generator().manual_seed(1))
    b = model(x, torch.Generator().manual_seed(1))
    c = model(x, torch.Generator().manual_seed(2))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.allclose(a[-1], c[-1])
    with torch.no_grad():
        eval_out = model.eval()(x)
    assert not torch.allclose(a[-1], eval_out[-1])


# ---------------------------------------------------------------------------
# Optimizer, batch plan, criterion
# ---------------------------------------------------------------------------

def test_adam_with_coupled_l2_matches_optax():
    """torch Adam(weight_decay) against the JAX package's optax chain
    add_decayed_weights -> scale_by_adam -> scale(-lr), over three steps.
    f32 moments and square roots in another order: 1e-7 relative."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    opt = jax_train.make_optimizer(1e-3, 0.01)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = train.make_optimizer([tp], 1e-3, 0.01)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-7, atol=1e-7)


def test_epoch_permutation_pads_with_row_zero():
    g = torch.Generator().manual_seed(8)
    idx, valid = epoch_permutation(g, 19, 8)
    assert idx.shape == valid.shape == (3, 8) and valid.dtype == torch.float32
    assert sorted(idx.flatten()[:19].tolist()) == list(range(19))
    assert idx.flatten()[19:].tolist() == [0] * 5
    assert valid.flatten().tolist() == [1.0] * 19 + [0.0] * 5
    again = epoch_permutation(torch.Generator().manual_seed(8), 19, 8)[0]
    assert torch.equal(idx, again)


def test_fed_batch_plans_are_checked():
    data = DeviceDataset.from_host(synthetic_dataset(num_queries=24, seq_len=16), 8, "cpu")
    assert (data.n_train, data.n_test, data.train_batches) == (19, 5, 3)
    idx, valid = data.plan(None, "train", np.zeros((3, 8), np.int32), np.ones((3, 8)))
    assert idx.dtype == torch.int64 and valid.dtype == torch.float32
    with pytest.raises(ValueError, match="plan must be"):
        data.plan(None, "test", np.zeros((3, 8)), np.ones((3, 8)))


@pytest.mark.parametrize("model_name,num_tasks", [("mmoecut", 2.1), ("mtple", 3)])
def test_make_criterion_covers_the_ported_models(model_name, num_tasks):
    """MMOECut's criterion follows the config's num_tasks, PLECut's keeps
    its three; probe_base, which trains through verify_probe, has none (a
    ValueError, as in the JAX package)."""
    crit = train.make_criterion(TrainConfig(model_name=model_name, num_tasks=2.1))
    assert crit.keywords == dict(metric="dcg", rerank_weight=0.5, classi_weight=0.5,
                                 num_tasks=num_tasks)
    with pytest.raises(ValueError, match=model_name):
        train.make_criterion(TrainConfig(model_name="probe_base"))


# ---------------------------------------------------------------------------
# A whole epoch replayed on the JAX package's batch plan
# ---------------------------------------------------------------------------

# One epoch of 3 train steps (lr 3e-5, coupled L2 0.005) and the test pass at
# L = 16, dropout 0. The step losses and batch metrics are the same numbers
# up to f32 rounding of the forward (HEAD_ATOL) carried through the updates.
EPOCH_LOSS_RTOL = 1e-5
# F1 and DCG at the decoded cuts: equal, but a cut may move where two
# positions of a cut distribution sit within HEAD_ATOL (checked here).
EPOCH_METRIC_ATOL = 1e-6
# Parameters after the epoch: each leaf's update (params minus init) against
# JAX's, in L2 relative to JAX's update norm. Adam's first steps move each
# element by about lr * sign(g), so an element whose gradient is near zero on
# both sides can part the runs by up to 2 lr per step (a max-abs comparison
# reads 3.5e-2 of the largest move here, in linear1.weight); the norm weighs
# those few elements against the whole leaf. The worst leaf reads 1.1e-3
# (in_proj_bias); an update that is missing or wrong after step 1 reads
# about 1.
UPDATE_REL = 1e-2


@pytest.fixture(scope="module")
def replayed_epoch():
    cfg_kw = dict(model_name="mmoecut", seq_len_override=16, synthetic_queries=24,
                  batch_size=8, dropout=0.0, epochs=1, seed=9)
    jcfg = jax_config.TrainConfig(**cfg_kw)
    assert (jcfg.lr, jcfg.weight_decay, jcfg.criterion) == (3e-5, 0.005, "dcg")
    jt = jax_train.Trainer(jcfg)
    init = _np_tree(jt.state.params)
    _, key = jax.random.split(jt.epoch_key)
    tr_key, te_key = jax.random.split(key)
    plans = [jax_batching.epoch_permutation(k, n, 8)
             for k, n in ((tr_key, jt.data.n_train), (te_key, jt.data.n_test))]
    state, jm = jt.epoch_fn(jt.state, jt.data, key)
    jm = jax.device_get(jm)
    pt = train.Trainer(TrainConfig(**cfg_kw), device="cpu",
                       state_dict=params_from_jax(init))
    pm = pt.run_epoch(*[tuple(np.asarray(a) for a in plan) for plan in plans])
    return jm, init, _np_tree(state.params), pm, pt.model


def test_replayed_epoch_matches_jax_metrics(replayed_epoch):
    jm, _, _, pm, _ = replayed_epoch
    np.testing.assert_allclose(pm["train_loss_steps"], np.asarray(jm["train_loss_steps"]),
                               rtol=EPOCH_LOSS_RTOL)
    assert len(pm["train_loss_steps"]) == 3
    for name in ("train_loss", "test_loss"):
        np.testing.assert_allclose(pm[name], float(jm[name]), rtol=EPOCH_LOSS_RTOL)
    for name in ("train_f1", "train_dcg", "test_f1", "test_dcg"):
        np.testing.assert_allclose(pm[name], float(jm[name]), rtol=0,
                                   atol=EPOCH_METRIC_ATOL)


def test_replayed_epoch_matches_jax_params(replayed_epoch):
    _, init, jparams, _, model = replayed_epoch
    init, want = params_from_jax(init), params_from_jax(jparams)
    state = model.state_dict()
    assert set(state) == set(want)
    for name, value in state.items():
        got_move, want_move = value - init[name], want[name] - init[name]
        assert want_move.norm() > 0, name
        assert (got_move - want_move).norm() <= UPDATE_REL * want_move.norm(), name


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def test_trainer_defaults_to_the_card():
    """Without a device the trainer asks for CUDA, and this box has none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.Trainer(TrainConfig(model_name="mmoecut", seq_len_override=16,
                                  synthetic_queries=10))


def test_train_cli_on_cpu(tmp_path):
    """`python -m rlt_tpu_torch.train --device cpu` trains an epoch, writes
    the best weights as a state_dict that the Predictor loads, and prints
    the summary."""
    out = tmp_path / "summary.json"
    cmd = [sys.executable, "-m", "rlt_tpu_torch.train", "--device", "cpu",
           "--retrieve-data", "mq2007", "--synthetic-queries", "24",
           "--batch-size", "8", "--epochs", "2", "--model-persist", "1",
           "--save-path", str(tmp_path), "--out", str(out)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=ONE_THREAD_ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["device"] == "cpu"
    assert np.isfinite(summary["best_f1"]) and np.isfinite(summary["best5_dcg"])
    saved = json.loads(out.read_text())
    assert saved["config"]["dropout"] == 0.1 and saved["config"]["lr"] == 3e-5
    cfg = TrainConfig(model_name="mmoecut", retrieve_data="mq2007",
                      model_path=str(tmp_path / "mmoecut.pt"))
    ks = Predictor(cfg, device="cpu").predict(np.zeros((2, 40, 47), np.float32))
    assert ks.shape == (2,)


def test_convergence_summarises_each_model_against_results(tmp_path, monkeypatch):
    """`python -m rlt_tpu_torch.convergence` trains every (model, seed) and
    prints, per model, the seeds' best F1, their mean and its difference
    from RESULTS.json's mean_best_f1; unknown arguments reach every run."""
    from rlt_tpu_torch import convergence

    calls = []

    def fake_train(model, seed, args, extra, out_dir):
        calls.append((model, seed, args.compute_dtype, tuple(extra), out_dir))
        return {"best_f1": 0.5 + 0.1 * seed}

    monkeypatch.setattr(convergence, "_train", fake_train)
    result = convergence.main(["--models", "bicut", "choopy", "--seeds", "0", "1",
                               "--compute-dtype", "bfloat16", "--out-dir", str(tmp_path),
                               "--device", "cpu"])
    assert sorted(c[:2] for c in calls) == [("bicut", 0), ("bicut", 1), ("choopy", 0),
                                           ("choopy", 1)]
    assert all(c[2:] == ("bfloat16", ("--device", "cpu"), tmp_path) for c in calls)
    reference = json.loads((Path(convergence.REPO) / "RESULTS.json").read_text())
    for model in ("bicut", "choopy"):
        got = result[model]
        assert got["best_f1"] == [0.5, 0.6] and got["mean_best_f1"] == pytest.approx(0.55)
        assert got["diff"] == pytest.approx(0.55 - reference[model]["mean_best_f1"])
