"""The port's bf16 training lane against the JAX package, on the CPU: the
eight models' step-1 loss and gradients, a replayed epoch, the Trainer and
its CLI.

Each model at L = 128 on copied weights, at dropout 0 (the port's dropout
bits are torch's), through the JAX package's kernels in interpret mode (with
the bf16 eval route to XLA attention off and the two BiLSTM directions
fused, as the port runs them) and through the port's plain versions: the
loss and every gradient of one step of `build_epoch_fn`'s loss in bf16 (f32
parameters and features cast to bf16 inside the loss, outputs cast back to
f32 before the criterion) against the port's `train.forward` in bf16, with
d_ref = JAX bf16 - JAX f32 (the f32 step on the JAX plain path), bf16's own
effect on each, as the yardstick (bounds below). Inputs are made with numpy
from fixed seeds.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlt_tpu.ops.attention as jax_attention
from rlt_tpu import config as jax_config
from rlt_tpu import train as jax_train
from rlt_tpu.data import batching as jax_batching
from rlt_tpu.data import datasets as jax_datasets
from rlt_tpu.models import build_model as jax_build_model
from rlt_tpu.models import layers as jax_layers
from rlt_tpu_torch import train
from rlt_tpu_torch.config import PRESETS, TrainConfig
from rlt_tpu_torch.models import ZERO_GRAD_LEAVES, build_model, layers
from rlt_tpu_torch.models.layers import compute_params
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
MODELS = ("mmoecut", "moecut", "mtple", "attncut", "mtattncut", "bicut", "choopy",
          "mtchoopy")
SEQ_LEN = 128  # PALLAS_MIN_SEQ_LEN: the JAX models take their kernels

# Bounds, per gradient leaf, against d_ref = JAX bf16 - JAX f32:
# - Each leaf's RMS error within sqrt(2) of RMS(d_ref), and its max within 3
#   max|d_ref| (the bounds of the bf16 forward's test, tests/test_torch_bf16.py).
#   The port rounds where JAX rounds, op by op (the backward kernels' plain
#   versions, tests/test_torch_bf16_train_ops.py; sigmoid bit for bit), so on
#   equal inputs it agrees with JAX far better than with f32.
# - But one op: a bf16 softmax backward sums its bf16 terms in f32 and rounds
#   once, where XLA on the CPU sums them in bf16 windows, every add rounded
#   (test_softmax_bf16_backward_needs_the_windowed_sum). The backward sums to
#   zero in exact arithmetic and, in bf16, to a residual of about one
#   rounding per row, which JAX's gradients carry inside d_ref; the port's is
#   another draw, as a rule smaller (every leaf but those below reads at most
#   1.31 of d_ref at these seeds; with XLA's windowed sum put in the port's
#   softmax, MMOECut's leaves read up to 1.97: two draws of the larger
#   residual). The weight of a Linear whose output a softmax takes
#   (SOFTMAX_FED_LEAVES: the gates, the cut and rerank towers, the
#   decisions) takes that residual at full weight, summed over the batch's 2
#   lists only: its error is the difference of two draws against d_ref's one
#   draw, which may be small by chance (PLECut's w_gate_2 read 2.51 and
#   MtAttnCut's decision 2.81): RMS and max within SOFTMAX_FED_OF_REF of
#   d_ref's. A wrong softmax backward moves these leaves by their own size,
#   1 / rho (tens) of d_ref.
# - A leaf of fewer than SMALL_LEAF elements (a scalar bias) gives no RMS
#   estimate: its d_ref may be near 0 by chance (MMOECut's rerank-tower
#   bias read 1.8e4 of it). Its yardstick is at least rho times its own
#   size, rho being the median over the model's leaves of RMS(d_ref) /
#   RMS(gradient): the model's relative bf16 noise.
# - The leaves zero by algebra (`ZERO_GRAD_LEAVES`: a bias under a softmax
#   over positions, the rerank bias under its hinge, the LayerNorm bias
#   before AttnCut's and Choopy's decision) are rounding noise in every run
#   (up to 3.7e-2 of the model's largest gradient measured, JAX's, the
#   port's and the card's): each within ZERO_GRAD_REL of it. The key block of
#   every in_proj_bias, zero by algebra too, is left out of its leaf.
# - The loss within 3 of the larger of |d_ref| and the change that rounding
#   the f32 outputs to bf16 makes to it (d_ref of one scalar may be near 0).
# - The LSTM's recurrent weights take K2''s f32 dW_hh^T unrounded, as JAX's
#   custom_vjp hands it to the f32 master: bits below bf16 precision.
RMS_OF_REF = 2.0 ** 0.5
MAX_OF_REF = 3.0
SOFTMAX_FED_OF_REF = 4.0
SMALL_LEAF = 16
ZERO_GRAD_REL = 0.1
LOSS_OF_REF = 3.0
_TOWERS = ("tower_cut.linear.weight", "tower_rerank.linear.weight")
SOFTMAX_FED_LEAVES = {"mmoecut": ("w_gates", *_TOWERS), "moecut": ("w_gates", *_TOWERS),
                      "mtple": ("w_gate_0", "w_gate_1", "w_gate_2", *_TOWERS),
                      "attncut": ("decision.weight",), "mtattncut": ("heads.decision.weight",),
                      "bicut": ("decision.weight",), "choopy": ("decision.weight",),
                      "mtchoopy": ("heads.decision.weight",)}


def _input_size(name: str) -> int:
    return 1 if name in ("choopy", "mtchoopy") else 3


def _heads(output) -> list:
    return list(output) if isinstance(output, (list, tuple)) else [output]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _without_key_bias(name: str, a: np.ndarray) -> np.ndarray:
    if not name.endswith("self_attn.in_proj_bias"):
        return a
    d = a.shape[-1] // 3
    return np.concatenate([a[..., :d], a[..., 2 * d:]], axis=-1)


def _jax_params(name: str, seq_len: int = SEQ_LEN) -> dict:
    """The port's seeded initial weights as a flax parameter tree (the
    inverse of `params_from_jax`: flax's LayerNorm calls its gain `scale`);
    the JAX package draws from the same torch distributions, and these
    cost no JAX init."""
    model = build_model(name, seq_len=seq_len, input_size=_input_size(name), dropout=0.0,
                        seed=3)
    tree = {}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        if leaf == "weight" and path and path[-1].startswith("norm"):
            leaf = "scale"
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.numpy()
    return tree


@pytest.fixture(scope="module", params=MODELS)
def jax_step(request):
    """One JAX model per family at L = 128 on seeded weights and dropout 0:
    one step of `build_epoch_fn`'s loss in bf16 through its kernels in
    interpret mode, and in f32 through its plain path (which agrees with
    its f32 kernels to 1e-5, tests/test_torch_zoo.py, and compiles in half
    the time): (name, params, x, y, valid, {bf16: (loss, grads, outputs)})."""
    name = request.param
    features = _input_size(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RLT_ATTN_XLA_EVAL", "0")
        mp.setenv("RLT_LSTM_FUSE_BIDIR", "1")
        for fn in ("fused_lstm", "fused_lstm_bidir"):
            mp.setattr(jax_layers, fn,
                       functools.partial(getattr(jax_layers, fn), interpret=True))
        for fn in ("fused_attention_packed", "fused_attention"):
            mp.setattr(jax_attention, fn,
                       functools.partial(getattr(jax_attention, fn), interpret=True))
        models = {bf16: jax_build_model(name, seq_len=SEQ_LEN, input_size=features,
                                        dropout=0.0, use_pallas=bf16)
                  for bf16 in (True, False)}
        params = _jax_params(name)
        rng = np.random.default_rng(120)
        x = rng.normal(size=(2, SEQ_LEN, features)).astype(np.float32)
        y = (rng.random((2, SEQ_LEN)) < 0.3).astype(np.float32)
        y[:, 0] = 1.0
        valid = np.ones(2, np.float32)
        criterion = jax_train.make_criterion(jax_config.TrainConfig(model_name=name))

        def loss_fn(p, bf16: bool):  # build_epoch_fn's loss_fn, dropout 0
            xx = jnp.asarray(x)
            if bf16:
                p = jax.tree.map(
                    lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, p)
                xx = xx.astype(jnp.bfloat16)
            out = models[bf16].apply({"params": p}, xx, deterministic=False,
                                     rngs={"dropout": jax.random.PRNGKey(0)})
            out = ([o.astype(jnp.float32) for o in out] if isinstance(out, (list, tuple))
                   else out.astype(jnp.float32))
            return criterion(out, jnp.asarray(y), valid=jnp.asarray(valid)), out

        steps = jax.jit(lambda p: [jax.value_and_grad(
            functools.partial(loss_fn, bf16=bf16), has_aux=True)(p) for bf16 in (True, False)])
        runs = {bf16: (float(loss), {k: v.numpy() for k, v in
                                     params_from_jax(_np_tree(grads)).items()},
                       [np.asarray(o) for o in _heads(out)])
                for bf16, ((loss, out), grads) in zip((True, False), steps(params))}
    return name, params, x, y, valid, runs


def _port_step(name, params, x, y, valid):
    """The port's bf16 step on JAX's weights: (loss, gradients, outputs)."""
    model = build_model(name, seq_len=SEQ_LEN, input_size=_input_size(name), dropout=0.0)
    model.load_state_dict(params_from_jax(params))
    model.train()
    out = train.forward(model, torch.from_numpy(x), torch.Generator(), torch.bfloat16)
    loss = train.make_criterion(TrainConfig(model_name=name))(
        out, torch.from_numpy(y), valid=torch.from_numpy(valid))
    loss.backward()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return loss.item(), {k: p.grad.numpy() for k, p in model.named_parameters()}, out


def test_models_bf16_step_matches_jax(jax_step):
    name, params, x, y, valid, runs = jax_step
    loss, got, out = _port_step(name, params, x, y, valid)
    assert all(o.dtype == torch.float32 for o in _heads(out))
    (want, grads, _), (want32, grads32, out32) = runs[True], runs[False]

    # the loss, against the larger of d_ref and the outputs' rounding's share
    criterion = train.make_criterion(TrainConfig(model_name=name))

    def crit(heads):
        heads = [torch.from_numpy(h) for h in heads]
        return float(criterion(heads if isinstance(out, list) else heads[0],
                               torch.from_numpy(y), valid=torch.from_numpy(valid)))

    rounding = abs(crit([o.astype(np.float32) for o in out32])
                   - crit([torch.from_numpy(o).bfloat16().float().numpy() for o in out32]))
    assert abs(loss - want) <= LOSS_OF_REF * max(abs(want - want32), rounding)

    assert set(got) == set(grads)
    largest = max(np.abs(g).max() for g in grads32.values())
    stats = {}
    for key, g in got.items():
        if key in ZERO_GRAD_LEAVES[name]:
            assert np.abs(g).max() <= ZERO_GRAD_REL * largest, key
            continue
        g, w, w32 = (_without_key_bias(key, np.asarray(a)) for a in (
            g, grads[key], grads32[key]))
        if not np.any(w32):  # a loss term inactive on this batch (a met hinge)
            assert not np.any(g) and not np.any(w), key
            continue
        stats[key] = (g - w, w - w32, w32)
    rho = float(np.median([_rms(d) / _rms(w32) for _, d, w32 in stats.values()]))
    for key, (err, d_ref, w32) in stats.items():
        rms_ref, max_ref = _rms(d_ref), np.abs(d_ref).max()
        if err.size < SMALL_LEAF:
            rms_ref = max(rms_ref, rho * _rms(w32))
            max_ref = max(max_ref, rho * np.abs(w32).max())
        fed = key in SOFTMAX_FED_LEAVES[name]
        rms_of, max_of = (SOFTMAX_FED_OF_REF,) * 2 if fed else (RMS_OF_REF, MAX_OF_REF)
        assert _rms(err) <= rms_of * rms_ref, (key, _rms(err) / rms_ref)
        assert np.abs(err).max() <= max_of * max_ref, (key, np.abs(err).max() / max_ref)
    for key, g in got.items():  # K2''s f32 gradient, unrounded
        if ".weight_hh_" in f".{key}":
            assert np.mean(torch.from_numpy(g).bfloat16().float().numpy() != g) > 0.9, key


# ---------------------------------------------------------------------------
# A MOECut epoch in bf16 at its drmm_tks preset, replayed on the JAX batch plan
# ---------------------------------------------------------------------------

# The updates of the replayed epoch (3 steps): Adam moves each element by
# about lr * sign(g) at first, so the bf16 runs part from the f32 one only
# where a gradient near 0 takes the other sign, and the port's bf16 run from
# JAX's the same way (two roundings): over all leaves (but those zero by
# algebra and the in_proj_bias key blocks), the L2 of the port's update
# minus JAX's bf16 update within UPDATE_OF_REF of d_ref's (JAX bf16 minus JAX
# f32), and the step losses within 3 |d_ref| plus one bf16 step of the loss.
UPDATE_OF_REF = 2.0


@pytest.fixture(scope="module")
def replayed_bf16_epoch():
    """One epoch of 3 train steps and the test pass at L = 16 with MOECut's
    drmm_tks preset (dropout 0.0: no masks are drawn) on 8-list batches, in
    bf16 by the JAX package's `build_epoch_fn` and the port's Trainer, and
    in f32 by JAX's, from the JAX Trainer's data, keys and plans (its
    set-up, written out here without its eager init) and seeded weights."""
    preset = PRESETS["drmm_tks"]["moecut"]
    assert preset["dropout"] == 0.0
    cfg_kw = dict(model_name="moecut", seq_len_override=16, synthetic_queries=24,
                  batch_size=8, epochs=1, seed=10, lr=preset["lr"],
                  weight_decay=preset["weight_decay"], dropout=preset["dropout"])
    jcfg = jax_config.TrainConfig(**cfg_kw)
    data = jax_batching.DeviceDataset.from_host(jax_datasets.synthetic_dataset(
        num_queries=jcfg.synthetic_queries, seq_len=jcfg.seq_len,
        num_features=jcfg.input_size, seed=jcfg.seed,
        **jax_datasets.synthetic_config(jcfg.retrieve_data, jcfg.dataset_name)), 8)
    model = jax_build_model("moecut", seq_len=jcfg.seq_len, input_size=jcfg.input_size,
                            dropout=jcfg.dropout, num_tasks=jcfg.num_tasks)
    criterion = jax_train.make_criterion(jcfg)
    optimizer = jax_train.make_optimizer(jcfg.lr, jcfg.weight_decay)
    _, rng, epoch_key = np.asarray(jax.random.split(jax.random.PRNGKey(jcfg.seed), 3))
    init = _jax_params("moecut", jcfg.seq_len)
    _, key = jax.random.split(epoch_key)
    tr_key, te_key = jax.random.split(key)
    plans = [jax_batching.epoch_permutation(k, n, 8)
             for k, n in ((tr_key, data.n_train), (te_key, data.n_test))]
    jax_runs = {}
    for dtype in ("bfloat16", "float32"):
        epoch_fn, _ = jax_train.build_epoch_fn(
            model, criterion, optimizer, jax_config.TrainConfig(**cfg_kw, compute_dtype=dtype))
        params = jax.tree.map(jnp.asarray, init)
        state = jax_train.TrainState(params, optimizer.init(params), jnp.asarray(rng))
        state, metrics = epoch_fn(state, data, key)
        jax_runs[dtype] = (jax.device_get(metrics), _np_tree(state.params))
    pt = train.Trainer(TrainConfig(**cfg_kw, compute_dtype="bfloat16"), device="cpu",
                       state_dict=params_from_jax(init))
    pm = pt.run_epoch(*[tuple(np.asarray(a) for a in plan) for plan in plans])
    return jax_runs, init, pm, pt.model


def test_replayed_bf16_moecut_epoch_matches_jax(replayed_bf16_epoch):
    jax_runs, init, pm, model = replayed_bf16_epoch
    (jm, jparams), (jm32, jparams32) = jax_runs["bfloat16"], jax_runs["float32"]
    steps, want, want32 = (np.asarray(a) for a in (
        pm["train_loss_steps"], jm["train_loss_steps"], jm32["train_loss_steps"]))
    assert len(steps) == 3
    step = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
    assert np.all(np.abs(steps - want) <= 3 * np.abs(want - want32) + step)
    init, want, want32 = (params_from_jax(t) for t in (init, jparams, jparams32))
    state = model.state_dict()
    assert set(state) == set(want)
    assert all(t.dtype == torch.float32 for t in state.values())
    err2 = ref2 = 0.0
    for key, value in state.items():
        if key in ZERO_GRAD_LEAVES["moecut"]:
            continue
        got, w, w32 = (_without_key_bias(key, (t - init[key]).numpy())
                       for t in (value, want[key], want32[key]))
        err2 += float(np.sum(np.square(got - w, dtype=np.float64)))
        ref2 += float(np.sum(np.square(w - w32, dtype=np.float64)))
    assert ref2 > 0 and (err2 / ref2) ** 0.5 <= UPDATE_OF_REF


# ---------------------------------------------------------------------------
# The Trainer and the train CLI in bf16
# ---------------------------------------------------------------------------

def _tiny(name: str = "mmoecut", **kw) -> TrainConfig:
    return TrainConfig(model_name=name, seq_len_override=16,
                       input_size_override=_input_size(name), synthetic_queries=24,
                       batch_size=8, epochs=1, **kw)


@pytest.mark.parametrize("name", ["mtple", "choopy"])
def test_bf16_trainer_epoch_keeps_f32_masters(name):
    """A bf16 epoch with dropout runs through the bf16 plain versions, moves
    the f32 master parameters, and leaves the state_dict, best_state and
    metrics in float32."""
    trainer = train.Trainer(_tiny(name, dropout=0.1, compute_dtype="bfloat16"),
                            device="cpu")
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    summary = trainer.run()
    assert summary["compute_dtype"] == "bfloat16"
    assert all(np.isfinite(summary[k]) for k in ("best_f1", "best_dcg"))
    state = trainer.model.state_dict()
    assert all(t.dtype == torch.float32 for t in state.values())
    assert all(t.dtype == torch.float32 for t in trainer.best_state.values())
    assert any(not torch.equal(state[k], init[k]) for k in state)
    metrics = trainer.history[0]
    assert all(np.isfinite(v) for k, v in metrics.items() if k != "train_loss_steps")


def test_bf16_step_differs_from_f32_step():
    """The same step in bf16 and in f32 from the same weights: the bf16 one
    is not the f32 one run through a cast at its end."""
    cfg = _tiny("attncut", dropout=0.0)
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        trainer = train.Trainer(cfg, device="cpu")
        data = trainer.data
        idx, valid = data.plan(trainer.generator, "train")
        train.train_step(trainer.model, trainer.optimizer, trainer.criterion, "attncut",
                         data.x_train[idx[0]], data.y_train[idx[0]], valid[0],
                         trainer.generator, dtype)
        grads[dtype] = {k: p.grad.clone() for k, p in trainer.model.named_parameters()}
    g16, g32 = grads[torch.bfloat16], grads[torch.float32]
    assert all(g.dtype == torch.float32 for g in g16.values())
    largest = max(g.abs().max().item() for g in g32.values())
    rel = max((g16[k] - g32[k]).abs().max().item() for k in g32) / largest
    assert 1e-4 < rel < 0.1


def test_train_cli_takes_compute_dtype(tmp_path):
    args = train.build_argparser().parse_args(["--compute-dtype", "bfloat16",
                                               "--model-name", "bicut"])
    assert train.config_from_args(args).compute_dtype == "bfloat16"
    assert train.config_from_args(train.build_argparser().parse_args([])).compute_dtype \
        == "float32"
    with pytest.raises(SystemExit):  # argparse refuses a dtype it does not know
        train.build_argparser().parse_args(["--compute-dtype", "float16"])
    out = tmp_path / "summary.json"
    proc = subprocess.run(
        [sys.executable, "-m", "rlt_tpu_torch.train", "--model-name", "bicut",
         "--device", "cpu", "--retrieve-data", "mq2007", "--synthetic-queries", "24",
         "--batch-size", "8", "--epochs", "1", "--compute-dtype", "bfloat16",
         "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=ONE_THREAD_ENV)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["compute_dtype"] == "bfloat16" and np.isfinite(summary["best_f1"])
    assert json.loads(out.read_text())["config"]["compute_dtype"] == "bfloat16"


def test_compute_params_keeps_the_recurrent_weights_f32():
    """`compute_params` casts every parameter but an LSTM's, which the layer
    casts itself: in a bf16 step its input weights' gradients arrive
    through that cast, rounded to bf16, and its recurrent weights' are
    K2''s f32 sums, unrounded."""
    model = build_model("bicut", seq_len=16, input_size=3, dropout=0.0)
    lstm_params = {f"{prefix}.{n}" for prefix, m in model.named_modules()
                   if isinstance(m, layers.LSTM) for n, _ in m.named_parameters()}
    params = compute_params(model, torch.bfloat16)
    assert lstm_params and set(params) == {k for k, _ in model.named_parameters()}
    for key, p in params.items():
        assert p.dtype == (torch.float32 if key in lstm_params else torch.bfloat16), key
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 16, 3)).astype(np.float32))
    out = train.forward(model, x, None, torch.bfloat16)
    sum(o.square().sum() for o in _heads(out)).backward()
    for key, p in model.named_parameters():
        rounded = torch.equal(p.grad, p.grad.bfloat16().float())
        assert rounded == (".weight_hh_" not in f".{key}"), key
