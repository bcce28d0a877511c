"""MOECut, AttnCut, MtAttnCut and BiCut of the port against the JAX package.

Each model's parameters map leaf for leaf through `params_from_jax`; its
eval heads, cuts and step-1 gradients match the JAX package's plain path on
copied weights (L = 16); AttnCut and MOECut also match the JAX forward
through its Pallas kernels in interpret mode (L = 128); the unstacked
attention's dropout streams (one seed, rows N = B) match the JAX packed
kernel; a MOECut epoch at its drmm_tks preset replays the JAX package's;
`make_criterion` equals the JAX package's for every ported model and loss
override; the train CLI and the Predictor run each model on the CPU. The
port runs on the CPU, where its kernels' plain versions run; inputs are
made with numpy from fixed seeds and handed to both packages.
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
from rlt_tpu import infer as jax_infer
from rlt_tpu import train as jax_train
from rlt_tpu.data import batching as jax_batching
from rlt_tpu.models import build_model as jax_build_model
from rlt_tpu.models import layers as jax_layers
from rlt_tpu_torch import train
from rlt_tpu_torch.config import PRESETS, TrainConfig, apply_preset
from rlt_tpu_torch.infer import Predictor, decode_ks
from rlt_tpu_torch.models import build_model, is_multi_head, layers
from rlt_tpu_torch.ops import attention
from rlt_tpu_torch.serve import TruncationService
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ZOO = ("moecut", "attncut", "mtattncut", "bicut")
PORTED = ZOO + ("mmoecut", "mtple")

# f32 on both sides, as tests/test_torch_models.py's HEAD_ATOL: sums in
# another order (MOECut's gate contracts 2 * 128 * L BiLSTM outputs) and
# flax's LayerNorm variance E[x^2] - E[x]^2 against torch's; every head is
# a probability in [0, 1] but MtAttnCut's rerank head, a logit of O(1).
HEAD_ATOL = 1e-5
# Step-1 gradients, relative to each gradient's max abs, plus a floor for
# the biases of the heads that a softmax over positions or the rerank hinge
# makes zero by algebra (rounding noise on both sides), as
# tests/test_torch_train.py's GRAD_REL and GRAD_FLOOR.
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-7
# The packed attention's o (O(1)) and lse (O(log L)): 64-term dot products
# and L-term softmax sums in another order (tests/test_torch_ops.py).
ATTN_ATOL = 1e-5
# Each parameter's update over the replayed epoch, in L2 relative to JAX's
# update (tests/test_torch_train.py's UPDATE_REL, and why).
UPDATE_REL = 1e-2
EPOCH_LOSS_RTOL = 1e-5


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _features(seed, batch, seq_len):
    return np.random.default_rng(seed).normal(size=(batch, seq_len, 3)).astype(np.float32)


def _labels(seed, batch, seq_len):
    y = (np.random.default_rng(seed).random((batch, seq_len)) < 0.3).astype(np.float32)
    y[:, 0] = 1.0
    return y


def _jax_model(name, seq_len, use_pallas=False, dropout=0.1, seed=0):
    model = jax_build_model(name, seq_len=seq_len, input_size=3, dropout=dropout,
                            use_pallas=use_pallas)
    key = jax.random.PRNGKey(seed)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((1, seq_len, 3), jnp.float32))["params"]
    return model, params


def _port_model(name, seq_len, params, dropout=0.1):
    model = build_model(name, seq_len=seq_len, input_size=3, dropout=dropout)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    return model


def _heads(output):
    return output if isinstance(output, (list, tuple)) else [output]


@pytest.fixture(scope="module", params=ZOO)
def jax_zoo16(request):
    return request.param, *_jax_model(request.param, 16)


def _compare_heads(name, jax_model, params, port_model, x):
    want = jax_model.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = port_model.eval()(torch.from_numpy(x))
    assert isinstance(got, list) == is_multi_head(name)
    assert len(_heads(got)) == len(_heads(want))
    for g, w in zip(_heads(got), _heads(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=HEAD_ATOL)
    np.testing.assert_array_equal(decode_ks(name, got).numpy(),
                                  np.asarray(jax_train.decode_ks(name, want)))


# ---------------------------------------------------------------------------
# Weights, heads and cuts on copied weights
# ---------------------------------------------------------------------------

def test_params_from_jax_covers_every_leaf(jax_zoo16):
    """Every JAX leaf lands on a port key of the same shape and no port key
    is left over: the unstacked encoder has no expert axis, as the JAX
    leaves, and the converter maps them unchanged."""
    name, _, params = jax_zoo16
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    state = params_from_jax(_np_tree(params))
    port_state = build_model(name, seq_len=16, input_size=3, dropout=0.1).state_dict()
    assert set(state) == set(port_state)
    assert len(state) == len(leaves)
    for key, tensor in state.items():
        assert tuple(tensor.shape) == tuple(port_state[key].shape), key
    encoder = {"attncut": "attention_layer", "mtattncut": "encoding_layer"}.get(name)
    if encoder:
        assert tuple(state[f"{encoder}.layers_0.self_attn.in_proj_weight"].shape) == (768, 256)
        assert tuple(state[f"{encoder}.layers_0.norm2.weight"].shape) == (256,)
    if name == "moecut":
        assert tuple(state["w_gates"].shape) == (2 * 128 * 16, 3)


def test_eval_forward_matches_jax_plain_path(jax_zoo16):
    name, jax_model, params = jax_zoo16
    _compare_heads(name, jax_model, params, _port_model(name, 16, params),
                   _features(50, 3, 16))


@pytest.mark.parametrize("name", ["attncut", "moecut"])
def test_matches_jax_kernel_path(monkeypatch, name):
    """The JAX forward through its Pallas kernels (interpret mode): L = 128
    reaches PALLAS_MIN_SEQ_LEN, so the fused LSTM and the head-packed
    attention kernel run (AttnCut's on its unstacked (B, L, D) batch)."""
    monkeypatch.setattr(jax_layers, "fused_lstm",
                        functools.partial(jax_layers.fused_lstm, interpret=True))
    monkeypatch.setattr(
        jax_attention, "fused_attention_packed",
        functools.partial(jax_attention.fused_attention_packed, interpret=True))
    seq_len = 128
    assert seq_len >= jax_attention.PALLAS_MIN_SEQ_LEN
    jax_model, params = _jax_model(name, seq_len, use_pallas=True, seed=1)
    _compare_heads(name, jax_model, params, _port_model(name, seq_len, params),
                   _features(51, 2, seq_len))


@pytest.mark.parametrize("name", ZOO)
def test_step1_grads_match_jax(name):
    """Training-mode heads, the criterion of `make_criterion` and the
    gradient of every parameter against jax.value_and_grad, on copied
    weights at dropout 0 (the port's dropout bits are torch's)."""
    jax_model, params = _jax_model(name, 16, dropout=0.0, seed=4)
    x, y = _features(52, 3, 16), _labels(53, 3, 16)
    valid = np.array([1, 1, 0], np.float32)
    jax_crit = jax_train.make_criterion(jax_config.TrainConfig(model_name=name))

    def jax_loss(p):
        out = jax_model.apply({"params": p}, jnp.asarray(x), deterministic=False)
        return jax_crit(out, jnp.asarray(y), valid=jnp.asarray(valid)), out

    (want_loss, want_out), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    model = _port_model(name, 16, params, dropout=0.0).train()
    out = model(torch.from_numpy(x))
    for g, w in zip(_heads(out), _heads(want_out)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=HEAD_ATOL)
    loss = train.make_criterion(TrainConfig(model_name=name))(
        out, torch.from_numpy(y), valid=torch.from_numpy(valid))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    want = params_from_jax(_np_tree(want_grads))
    for key, p in model.named_parameters():
        assert p.grad is not None, key
        g, w = p.grad.numpy(), want[key].numpy()
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + GRAD_FLOOR, key


# ---------------------------------------------------------------------------
# The unstacked encoder
# ---------------------------------------------------------------------------

def test_unstacked_encoder_layer_matches_jax():
    """One JAX encoder layer against the port's with `experts=None`: the
    same parameter shapes, no expert axis, (B, L, D) out."""
    x = _features(54, 2, 12).repeat(86, axis=-1)[..., :256]
    jax_mod = jax_layers.TransformerEncoderLayer(d_model=256, n_head=4, dropout=0.1)
    params = jax_mod.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    want = jax_mod.apply({"params": params}, jnp.asarray(x), deterministic=True)
    port = layers.TransformerEncoderLayer(256, 4, 2048).eval()
    port.load_state_dict(params_from_jax(_np_tree(params)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_unstacked_attention_dropout_matches_jax_packed_kernel():
    """The unstacked SelfAttention in training at rate 0.1 draws one seed
    and gives row b of its N = B rows the stream seed + b, as the JAX
    package's unstacked SelfAttention: its output equals the JAX packed
    kernel (interpret mode) on the same projections and seed, and K5''s
    plain version at N = B matches that kernel's o and lse."""
    batch, seq_len, d, heads = 5, 128, 256, 4
    attn = layers.SelfAttention(d, heads, generator=torch.Generator().manual_seed(6),
                                dropout=0.1).train()
    with torch.no_grad():
        attn.in_proj_bias.normal_(generator=torch.Generator().manual_seed(7))
    x = np.random.default_rng(55).normal(size=(batch, seq_len, d)).astype(np.float32)
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.Generator().manual_seed(8))
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(8)))
    w, b = attn.in_proj_weight.detach().numpy(), attn.in_proj_bias.detach().numpy()
    q, k, v = (x @ w[i * d:(i + 1) * d].T + b[i * d:(i + 1) * d] for i in range(3))
    pack = attention.packed_group_size(d, heads)
    jax_o, jax_lse = jax_attention._fwd_packed(
        0.1, True, heads, pack, *map(jnp.asarray, (q, k, v)),
        jnp.asarray([seed], jnp.int32))
    out_w, out_b = attn.out_proj_weight.detach().numpy(), attn.out_proj_bias.detach().numpy()
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_o) @ out_w.T + out_b,
                               rtol=0, atol=ATTN_ATOL)
    streams = attention.expert_streams(torch.tensor([seed]), batch)
    o, lse = attention.attention_packed_plain(*map(torch.from_numpy, (q, k, v)), heads,
                                              pack, 0.1, streams)
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_o), rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse), rtol=0, atol=ATTN_ATOL)


# ---------------------------------------------------------------------------
# Criterion dispatch
# ---------------------------------------------------------------------------

def _loss_id(crit):
    if isinstance(crit, functools.partial):
        return crit.func.__name__, crit.keywords
    return crit.__name__, {}


@pytest.mark.parametrize("override", [None, "attncut", "choopy", "div", "wass"])
@pytest.mark.parametrize("name", PORTED)
def test_make_criterion_matches_jax(name, override):
    """The same loss with the same arguments as the JAX package's
    `make_criterion`, for every ported model and loss override (which acts
    on attncut only), at non-default divergence settings."""
    kw = dict(model_name=name, loss_override=override, div_type="kl",
              augmented_reward=False, num_tasks=2.2, rerank_weight=0.25,
              class_weight=0.75, criterion="f1")
    assert _loss_id(train.make_criterion(TrainConfig(**kw))) == _loss_id(
        jax_train.make_criterion(jax_config.TrainConfig(**kw)))


def test_task_weights_of_the_presets():
    """MOECut's criterion takes the fixed 0.5/0.5, not its preset's 0.2/0.8;
    MtAttnCut's takes its preset's 0.5/0.5; AttnCut's preset carries none."""
    moe = apply_preset(TrainConfig(model_name="moecut"))
    assert (moe.rerank_weight, moe.class_weight) == (0.2, 0.8)
    assert train.make_criterion(moe).keywords["rerank_weight"] == 0.5
    assert train.make_criterion(moe).keywords["classi_weight"] == 0.5
    mt = apply_preset(TrainConfig(model_name="mtattncut", rerank_weight=0.1,
                                  class_weight=0.1))
    assert train.make_criterion(mt).keywords == dict(
        metric="dcg", rerank_weight=0.5, classi_weight=0.5, num_tasks=3.0)
    attn = apply_preset(TrainConfig(model_name="attncut"))
    assert (attn.rerank_weight, attn.class_weight) == (0.3, 0.4)  # the defaults
    assert train.make_criterion(attn).keywords == dict(metric="dcg", div_type="js",
                                                       augmented=True)


@pytest.mark.parametrize("name", ["probe_base"])
def test_unported_models_still_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(name, seq_len=16, input_size=1, dropout=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train.make_criterion(TrainConfig(model_name=name))


# ---------------------------------------------------------------------------
# A MOECut epoch at its drmm_tks preset, replayed on the JAX batch plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replayed_moecut_epoch():
    """One epoch of 3 train steps and the test pass at L = 16 with MOECut's
    drmm_tks preset (lr 3e-5, weight decay 2.48e-3, dropout 0.0, so the
    JAX run and the port's draw no masks) on 8-list batches."""
    preset = PRESETS["drmm_tks"]["moecut"]
    assert preset["dropout"] == 0.0
    assert preset == jax_config.PRESETS["drmm_tks"]["moecut"]
    cfg_kw = dict(model_name="moecut", seq_len_override=16, synthetic_queries=24,
                  batch_size=8, epochs=1, seed=10, lr=preset["lr"],
                  weight_decay=preset["weight_decay"], dropout=preset["dropout"])
    jt = jax_train.Trainer(jax_config.TrainConfig(**cfg_kw))
    init = _np_tree(jt.state.params)
    _, key = jax.random.split(jt.epoch_key)
    tr_key, te_key = jax.random.split(key)
    plans = [jax_batching.epoch_permutation(k, n, 8)
             for k, n in ((tr_key, jt.data.n_train), (te_key, jt.data.n_test))]
    state, jm = jt.epoch_fn(jt.state, jt.data, key)
    pt = train.Trainer(TrainConfig(**cfg_kw), device="cpu",
                       state_dict=params_from_jax(init))
    pm = pt.run_epoch(*[tuple(np.asarray(a) for a in plan) for plan in plans])
    return jax.device_get(jm), init, _np_tree(state.params), pm, pt.model


def test_replayed_moecut_epoch_matches_jax_params(replayed_moecut_epoch):
    jm, init, jparams, pm, model = replayed_moecut_epoch
    np.testing.assert_allclose(pm["train_loss_steps"], np.asarray(jm["train_loss_steps"]),
                               rtol=EPOCH_LOSS_RTOL)
    assert len(pm["train_loss_steps"]) == 3
    init, want = params_from_jax(init), params_from_jax(jparams)
    state = model.state_dict()
    assert set(state) == set(want)
    for key, value in state.items():
        got_move, want_move = value - init[key], want[key] - init[key]
        assert want_move.norm() > 0, key
        assert (got_move - want_move).norm() <= UPDATE_REL * want_move.norm(), key


# ---------------------------------------------------------------------------
# Entry points on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_predictor_matches_jax_predictor(name):
    """The port's Predictor on weights copied from the JAX package's: the
    same cuts and distributions (BiCut's (B, L, 2) decision pair, the cut
    head's (B, L) otherwise)."""
    jax_pred = jax_infer.Predictor(jax_config.TrainConfig(
        model_name=name, seq_len_override=16, input_size_override=3, use_pallas=False))
    port = Predictor(TrainConfig(model_name=name, seq_len_override=16,
                                 input_size_override=3), device="cpu",
                     state_dict=params_from_jax(_np_tree(jax_pred.params)))
    x = _features(56, 5, 16)
    ks, dist = port.predict_with_distribution(x)
    want_ks, want_dist = jax_pred.predict_with_distribution(x)
    assert dist.shape == ((5, 16, 2) if name == "bicut" else (5, 16))
    np.testing.assert_array_equal(ks, want_ks)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=HEAD_ATOL)


def test_bicut_serves_its_decision_pairs():
    """`TruncationService` with BiCut: each list's cut is the first-truncate
    rule's, clamped to the list's length, and its distribution is the
    (length, 2) slice of the decision probabilities."""
    svc = TruncationService(TrainConfig(model_name="bicut", seq_len_override=16),
                            max_batch=4, device="cpu")
    rng = np.random.default_rng(57)
    lengths = (16, 5, 11)
    feats = [rng.normal(size=(n, 3)).astype(np.float32) for n in lengths]
    out = svc.truncate({"features": [f.tolist() for f in feats],
                        "return_distribution": True})
    x = np.zeros((4, 16, 3), np.float32)
    for i, f in enumerate(feats):
        x[i, :len(f)] = f
    with torch.no_grad():
        probs = svc.predictor.model.eval()(torch.from_numpy(x))
    assert out["k"] == np.minimum(decode_ks("bicut", probs).numpy()[:3], lengths).tolist()
    for i, n in enumerate(lengths):
        assert np.asarray(out["distribution"][i]).shape == (n, 2)
        np.testing.assert_allclose(out["distribution"][i], probs[i, :n].numpy(),
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", ZOO)
def test_train_cli_on_cpu(tmp_path, name):
    """`python -m rlt_tpu_torch.train --model-name <name> --device cpu`
    trains two epochs with the model's preset, writes the best weights, and
    the Predictor serves them."""
    out = tmp_path / "summary.json"
    cmd = [sys.executable, "-m", "rlt_tpu_torch.train", "--model-name", name,
           "--device", "cpu", "--retrieve-data", "mq2007", "--synthetic-queries", "24",
           "--batch-size", "8", "--epochs", "2", "--model-persist", "1",
           "--save-path", str(tmp_path), "--out", str(out)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=ONE_THREAD_ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["device"] == "cpu"
    assert np.isfinite(summary["best_f1"]) and np.isfinite(summary["best5_dcg"])
    saved = json.loads(out.read_text())["config"]
    preset = PRESETS["drmm_tks"][name]
    assert (saved["model_name"], saved["lr"], saved["dropout"]) == (
        name, preset["lr"], preset["dropout"])
    cfg = TrainConfig(model_name=name, retrieve_data="mq2007",
                      model_path=str(tmp_path / f"{name}.pt"))
    x = _features(58, 2, 40).repeat(cfg.input_size, axis=-1)[..., :cfg.input_size]
    ks, dist = Predictor(cfg, device="cpu").predict_with_distribution(x)
    assert ks.shape == (2,) and np.all((ks >= 1) & (ks <= 40))
    assert np.all(np.isfinite(dist))


def test_train_cli_carries_the_criterion_flags():
    args = train.build_argparser().parse_args(
        ["--model-name", "attncut", "--div-type", "kl", "--augmented-reward", "0",
         "--rerank-weight", "0.1", "--class-weight", "0.9", "--loss-override", "wass",
         "--no-preset"])
    cfg = train.config_from_args(args)
    assert (cfg.div_type, cfg.augmented_reward, cfg.rerank_weight, cfg.class_weight,
            cfg.loss_override) == ("kl", False, 0.1, 0.9, "wass")
