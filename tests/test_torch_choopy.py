"""Choopy and MtChoopy of the port against the JAX package, and the packed
attention at their shape: 8 heads of dh = 16 in one group of pack 8.

The plain versions of K5' and K6' at pack 8 match the JAX package's
`_fwd_packed` / `_bwd_packed` (interpret mode), with and without dropout,
and `head_keep_mask` gives every head its columns of the group's (L, 8 L)
JAX tile. Each model's parameters map leaf for leaf through
`params_from_jax`, `position_encoding` included; its eval heads, cuts and
step-1 gradients match the JAX package's plain path on copied weights
(L = 16), and its eval heads the JAX forward through the packed Pallas
kernel in interpret mode (L = 128); `make_criterion` equals the JAX one for
both and for every `--loss-override` on choopy; the train CLI, the
Predictor and the server's `{"scores": ...}` body run both on the CPU. The
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
from rlt_tpu.models import build_model as jax_build_model
from rlt_tpu_torch import train
from rlt_tpu_torch.config import PRESETS, TrainConfig
from rlt_tpu_torch.infer import Predictor, decode_ks
from rlt_tpu_torch.models import build_model, is_multi_head, layers
from rlt_tpu_torch.ops import attention
from rlt_tpu_torch.serve import TruncationService
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CHOOPY = ("choopy", "mtchoopy")
D, HEADS = 128, 8
PACK = 8  # packed_group_size(128, 8): all eight heads in one group

# f32 on both sides (tests/test_torch_zoo.py): o (O(1)) and lse (O(log L))
# from 16-term dot products and L-term softmax sums in another order; the
# gradients of the packed backward, and every model head (a probability, or
# MtChoopy's rerank logit of O(1)).
ATTN_ATOL = 1e-5
ATTN_BWD_REL = 2e-5
HEAD_ATOL = 1e-5
# Step-1 gradients, relative to each gradient's max abs, plus a floor for
# the biases that the softmax over positions or the rerank hinge makes zero
# by algebra (rounding noise on both sides), as tests/test_torch_zoo.py.
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-7


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _scores(seed, batch, seq_len):
    return np.random.default_rng(seed).normal(size=(batch, seq_len, 1)).astype(np.float32)


def _labels(seed, batch, seq_len):
    y = (np.random.default_rng(seed).random((batch, seq_len)) < 0.3).astype(np.float32)
    y[:, 0] = 1.0
    return y


def _qkv(seed, n, length):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, length, D)).astype(np.float32) for _ in range(3)]


def _jax_model(name, seq_len, num_tasks=3, use_pallas=False, dropout=0.1, seed=0):
    model = jax_build_model(name, seq_len=seq_len, input_size=1, dropout=dropout,
                            num_tasks=num_tasks, use_pallas=use_pallas)
    key = jax.random.PRNGKey(seed)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((1, seq_len, 1), jnp.float32))["params"]
    return model, params


def _port_model(name, seq_len, params, num_tasks=3, dropout=0.1):
    model = build_model(name, seq_len=seq_len, input_size=1, dropout=dropout,
                        num_tasks=num_tasks)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    return model


def _heads(output):
    return output if isinstance(output, (list, tuple)) else [output]


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
# The packed attention at 8 heads of dh = 16, pack 8
# ---------------------------------------------------------------------------

def test_packed_group_of_choopys_heads():
    assert attention.packed_group_size(D, HEADS) == PACK
    assert jax_attention.packed_group_size(D, HEADS) == PACK


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("length", [128, 37])
def test_attention_packed_at_pack_8_matches_jax_kernel(length, rate):
    """The plain K5' against `_fwd_packed(rate, True, 8, 8, ...)` in
    interpret mode on the same seed: o and lse within ATTN_ATOL; with
    dropout the mask acts."""
    q, k, v = _qkv(60, 2, length)
    seed = 2**31 - 2  # row 1's stream wraps past int32
    jax_o, jax_lse = jax_attention._fwd_packed(
        rate, True, HEADS, PACK, *map(jnp.asarray, (q, k, v)),
        jnp.asarray([seed], jnp.int32))
    streams = attention._streams(seed, 2).to(torch.int32)
    o, lse = attention.fused_attention_packed(*map(torch.from_numpy, (q, k, v)),
                                              heads=HEADS, pack=PACK,
                                              dropout_rate=rate, streams=streams)
    assert tuple(lse.shape) == (2, 1, length, PACK)
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_o), rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse), rtol=0, atol=ATTN_ATOL)
    o0, _ = attention.fused_attention_packed(*map(torch.from_numpy, (q, k, v)),
                                             heads=HEADS, pack=PACK)
    assert np.allclose(o.numpy(), o0.numpy(), atol=1e-3) == (rate == 0.0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("length", [128, 37])
def test_attention_packed_bwd_at_pack_8_matches_jax_kernel(length, rate):
    """The plain K6' against `_bwd_packed(rate, True, 8, 8, ...)` in
    interpret mode, both fed the JAX forward's o and lse and the same seed:
    each gradient within ATTN_BWD_REL of its max abs."""
    q, k, v = _qkv(61, 2, length)
    do = np.random.default_rng(62).normal(size=q.shape).astype(np.float32)
    seed = 78
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jseed = jnp.asarray([seed], jnp.int32)
    jax_o, jax_lse = jax_attention._fwd_packed(rate, True, HEADS, PACK, jq, jk, jv, jseed)
    want = jax_attention._bwd_packed(rate, True, HEADS, PACK, jq, jk, jv, jax_o,
                                     jax_lse, jdo, jseed)
    got = attention.attention_packed_bwd(
        *map(torch.from_numpy, (q, k, v, np.array(jax_o), np.array(jax_lse), do)),
        HEADS, PACK, rate, attention._streams(seed, 2).to(torch.int32))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= ATTN_BWD_REL * np.abs(w).max()


@pytest.mark.parametrize("rate", [0.1, 0.4])
def test_head_keep_mask_reads_every_heads_columns_of_the_jax_tile(rate):
    """Head h of the one group reads columns h * L + j of the group's
    (L, 8 L) tile, on the row's own stream (group 0 keeps it)."""
    n, length, seed = 3, 24, 2**31 - 3
    streams = attention._streams(seed, n)
    got = attention.head_keep_mask(streams, HEADS, PACK, length, rate).numpy()
    assert got.shape == (n, HEADS, length, length)
    for b, row in enumerate(np.asarray(jax_attention._streams(seed, n)).reshape(n)):
        tile = np.asarray(jax_attention.keep_mask(jax_attention._group_stream(row, 0),
                                                  (length, PACK * length), rate))
        for h in range(HEADS):
            np.testing.assert_array_equal(got[b, h], tile[:, h * length:(h + 1) * length])


def test_unstacked_attention_dropout_at_pack_8_matches_jax_packed_kernel():
    """Choopy's SelfAttention (d_model 128, 8 heads) in training at rate 0.1
    draws one seed and gives row b the stream seed + b: its output equals
    the JAX packed kernel's (interpret mode) on the same projections and
    seed."""
    batch, seq_len = 3, 64
    attn = layers.SelfAttention(D, HEADS, generator=torch.Generator().manual_seed(63),
                                dropout=0.1).train()
    assert attn.pack == PACK
    with torch.no_grad():
        attn.in_proj_bias.normal_(generator=torch.Generator().manual_seed(64))
    x = np.random.default_rng(65).normal(size=(batch, seq_len, D)).astype(np.float32)
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.Generator().manual_seed(66))
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(66)))
    w, b = attn.in_proj_weight.detach().numpy(), attn.in_proj_bias.detach().numpy()
    q, k, v = (x @ w[i * D:(i + 1) * D].T + b[i * D:(i + 1) * D] for i in range(3))
    jax_o, _ = jax_attention._fwd_packed(0.1, True, HEADS, PACK,
                                         *map(jnp.asarray, (q, k, v)),
                                         jnp.asarray([seed], jnp.int32))
    out_w, out_b = attn.out_proj_weight.detach().numpy(), attn.out_proj_bias.detach().numpy()
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_o) @ out_w.T + out_b,
                               rtol=0, atol=ATTN_ATOL)


# ---------------------------------------------------------------------------
# Weights, heads and cuts on copied weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CHOOPY)
def test_params_from_jax_covers_every_leaf(name):
    """Every JAX leaf lands on a port key of the same shape and no port key
    is left over, the (L, 127) position encoding included."""
    _, params = _jax_model(name, 16)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    state = params_from_jax(_np_tree(params))
    port_state = build_model(name, seq_len=16, input_size=1, dropout=0.1).state_dict()
    assert set(state) == set(port_state)
    assert len(state) == len(leaves)
    for key, tensor in state.items():
        assert tuple(tensor.shape) == tuple(port_state[key].shape), key
    encoder = {"choopy": "attention_layer", "mtchoopy": "encoding_layer"}[name]
    assert tuple(state["position_encoding"].shape) == (16, 127)
    for i in range(3):
        assert tuple(state[f"{encoder}.layers_{i}.self_attn.in_proj_weight"].shape) == (384, 128)
        assert tuple(state[f"{encoder}.layers_{i}.linear1.weight"].shape) == (2048, 128)
    assert f"{encoder}.layers_3.norm1.weight" not in state


def test_seeded_position_encoding_is_standard_normal():
    """The port draws the encoding from N(0, 1), as the JAX package's
    randn_init (with torch's generator, so other numbers)."""
    pe = build_model("choopy", seq_len=300, input_size=1, dropout=0.1,
                     seed=3).position_encoding.detach().numpy()
    assert pe.shape == (300, 127)
    assert abs(pe.mean()) < 0.02 and abs(pe.std() - 1.0) < 0.02
    again = build_model("choopy", seq_len=300, input_size=1, dropout=0.1, seed=3)
    assert torch.equal(again.position_encoding, torch.from_numpy(pe))


@pytest.mark.parametrize("name,num_tasks", [("choopy", 3), ("mtchoopy", 3),
                                            ("mtchoopy", 2.1), ("mtchoopy", 2.2)])
def test_eval_forward_matches_jax_plain_path(name, num_tasks):
    jax_model, params = _jax_model(name, 16, num_tasks=num_tasks, seed=1)
    _compare_heads(name, jax_model, params,
                   _port_model(name, 16, params, num_tasks=num_tasks),
                   _scores(70, 3, 16))


@pytest.mark.parametrize("name,num_tasks", [("choopy", 3), ("mtchoopy", 3),
                                            ("mtchoopy", 2.1), ("mtchoopy", 2.2)])
def test_matches_jax_kernel_path(monkeypatch, name, num_tasks):
    """The JAX forward through its packed Pallas kernel in interpret mode:
    L = 128 reaches PALLAS_MIN_SEQ_LEN, so each of the three encoder layers
    runs `fused_attention_packed` at pack 8."""
    calls, kernel = [], jax_attention.fused_attention_packed

    def interpreted(*args, **kwargs):
        calls.append(kwargs["pack"])
        return kernel(*args, interpret=True, **kwargs)

    monkeypatch.setattr(jax_attention, "fused_attention_packed", interpreted)
    seq_len = 128
    assert seq_len >= jax_attention.PALLAS_MIN_SEQ_LEN
    jax_model, params = _jax_model(name, seq_len, num_tasks=num_tasks, use_pallas=True,
                                   seed=2)
    calls.clear()  # init ran the layers too
    _compare_heads(name, jax_model, params,
                   _port_model(name, seq_len, params, num_tasks=num_tasks),
                   _scores(71, 2, seq_len))
    assert calls == [PACK] * 3


@pytest.mark.parametrize("name,num_tasks", [("choopy", 3), ("mtchoopy", 3),
                                            ("mtchoopy", 2.2)])
def test_step1_grads_match_jax(name, num_tasks):
    """Training-mode heads, the criterion of `make_criterion` and the
    gradient of every parameter against jax.value_and_grad, on copied
    weights at dropout 0 (the port's dropout bits are torch's)."""
    jax_model, params = _jax_model(name, 16, num_tasks=num_tasks, dropout=0.0, seed=4)
    x, y = _scores(72, 3, 16), _labels(73, 3, 16)
    valid = np.array([1, 1, 0], np.float32)
    cfg_kw = dict(model_name=name, num_tasks=num_tasks)
    jax_crit = jax_train.make_criterion(jax_config.TrainConfig(**cfg_kw))

    def jax_loss(p):
        out = jax_model.apply({"params": p}, jnp.asarray(x), deterministic=False)
        return jax_crit(out, jnp.asarray(y), valid=jnp.asarray(valid)), out

    (want_loss, want_out), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    model = _port_model(name, 16, params, num_tasks=num_tasks, dropout=0.0).train()
    out = model(torch.from_numpy(x))
    for g, w in zip(_heads(out), _heads(want_out)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=HEAD_ATOL)
    loss = train.make_criterion(TrainConfig(**cfg_kw))(
        out, torch.from_numpy(y), valid=torch.from_numpy(valid))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    want = params_from_jax(_np_tree(want_grads))
    for key, p in model.named_parameters():
        w = want[key].numpy()
        if p.grad is None:  # the class head, which num_tasks 2.2 leaves out
            assert num_tasks == 2.2 and key.startswith("heads.classi"), key
            assert not w.any(), key
            continue
        g = p.grad.numpy()
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + GRAD_FLOOR, key
    assert np.abs(model.position_encoding.grad.numpy()).max() > 0


# ---------------------------------------------------------------------------
# Criterion dispatch
# ---------------------------------------------------------------------------

def _loss_id(crit):
    if isinstance(crit, functools.partial):
        return crit.func.__name__, crit.keywords
    return crit.__name__, {}


@pytest.mark.parametrize("override", [None, "attncut", "choopy", "div", "wass"])
@pytest.mark.parametrize("name", CHOOPY)
def test_make_criterion_matches_jax(name, override):
    """The same loss with the same arguments as the JAX package's
    `make_criterion`: choopy_loss for choopy, or its override; mtcut_loss
    with the config's task weights for mtchoopy, which no override moves."""
    kw = dict(model_name=name, loss_override=override, div_type="kl",
              augmented_reward=False, num_tasks=2.1, rerank_weight=0.25,
              class_weight=0.75, criterion="f1")
    got = _loss_id(train.make_criterion(TrainConfig(**kw)))
    assert got == _loss_id(jax_train.make_criterion(jax_config.TrainConfig(**kw)))
    if override is None or name == "mtchoopy":
        assert got[0] == {"choopy": "choopy_loss", "mtchoopy": "mtcut_loss"}[name]


def test_probe_base_alone_still_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model("probe_base", seq_len=16, input_size=1, dropout=0.1)
    for name in CHOOPY:
        assert build_model(name, seq_len=16, input_size=1, dropout=0.1) is not None


# ---------------------------------------------------------------------------
# Entry points on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CHOOPY)
def test_predictor_matches_jax_predictor(name):
    """The port's Predictor on weights copied from the JAX package's: the
    same cuts and cut distributions, from scores only (F = 1)."""
    jax_pred = jax_infer.Predictor(jax_config.TrainConfig(
        model_name=name, seq_len_override=16, use_pallas=False))
    cfg = TrainConfig(model_name=name, seq_len_override=16)
    assert cfg.input_size == 1
    port = Predictor(cfg, device="cpu", state_dict=params_from_jax(_np_tree(jax_pred.params)))
    x = _scores(74, 5, 16)
    ks, dist = port.predict_with_distribution(x)
    want_ks, want_dist = jax_pred.predict_with_distribution(x)
    assert dist.shape == (5, 16)
    np.testing.assert_array_equal(ks, want_ks)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=HEAD_ATOL)


@pytest.mark.parametrize("name", CHOOPY)
def test_server_takes_the_scores_body(name):
    """`TruncationService` with a scores-only model: a `{"scores": ...}`
    body of ragged lists gives each list the model's cut, clamped to its
    length, and its cut distribution over its positions."""
    svc = TruncationService(TrainConfig(model_name=name, seq_len_override=16),
                            max_batch=4, device="cpu")
    rng = np.random.default_rng(75)
    lengths = (16, 5, 11)
    scores = [np.sort(rng.random(n))[::-1].astype(np.float32) for n in lengths]
    out = svc.truncate({"scores": [s.tolist() for s in scores],
                        "return_distribution": True})
    x = np.zeros((4, 16, 1), np.float32)
    for i, s in enumerate(scores):
        x[i, :len(s), 0] = s
    with torch.no_grad():
        heads = svc.predictor.model.eval()(torch.from_numpy(x))
    dist = _heads(heads)[-1][..., 0]
    assert out["k"] == np.minimum(decode_ks(name, heads).numpy()[:3], lengths).tolist()
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(out["distribution"][i], dist[i, :n].numpy(),
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", CHOOPY)
def test_train_cli_on_cpu(tmp_path, name):
    """`python -m rlt_tpu_torch.train --model-name <name> --device cpu`
    trains two epochs with the model's drmm_tks preset on scores only,
    writes the best weights, and the Predictor serves them."""
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
    assert (saved["model_name"], saved["lr"], saved["weight_decay"], saved["dropout"]) == (
        name, preset["lr"], preset["weight_decay"], preset["dropout"])
    cfg = TrainConfig(model_name=name, retrieve_data="mq2007",
                      model_path=str(tmp_path / f"{name}.pt"))
    assert cfg.input_size == 1
    ks, dist = Predictor(cfg, device="cpu").predict_with_distribution(
        _scores(76, 2, cfg.seq_len))
    assert ks.shape == (2,) and np.all((ks >= 1) & (ks <= cfg.seq_len))
    assert np.all(np.isfinite(dist))
