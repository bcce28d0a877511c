"""The port's layers and MMOECut against the JAX package on copied weights.

Weights are initialised on the JAX side, converted with
`rlt_tpu_torch.utils.convert.params_from_jax`, and loaded into the port;
inputs are made with numpy and handed to both. The port runs on the CPU,
where its kernels' plain versions run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlt_tpu.ops.attention as jax_attention
from rlt_tpu.models import build_model as jax_build_model
from rlt_tpu.models import layers as jax_layers
from rlt_tpu.train import decode_ks as jax_decode_ks
from rlt_tpu_torch.infer import decode_ks
from rlt_tpu_torch.models import build_model, layers
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

# f32 on both sides. The largest difference comes from the gates: one
# (B, 2*128*L) x (2*128*L, E) contraction summed in another order, and
# flax's LayerNorm variance E[x^2] - E[x]^2 against torch's; both are a few
# ulps of O(1) values. The heads are probabilities in [0, 1].
HEAD_ATOL = 1e-5


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _jax_mmoecut(seq_len, use_pallas, seed=0):
    model = jax_build_model("mmoecut", seq_len=seq_len, input_size=3,
                            dropout=0.1, use_pallas=use_pallas)
    x0 = jnp.zeros((1, seq_len, 3), jnp.float32)
    key = jax.random.PRNGKey(seed)
    params = model.init({"params": key, "dropout": key}, x0)["params"]
    return model, params


@pytest.fixture(scope="module")
def jax_mmoecut16():
    return _jax_mmoecut(16, use_pallas=False)


def _port_mmoecut(seq_len, params):
    model = build_model("mmoecut", seq_len=seq_len, input_size=3, dropout=0.1)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    return model.eval()


def _features(seed, batch, seq_len):
    return np.random.default_rng(seed).normal(size=(batch, seq_len, 3)).astype(np.float32)


def _compare_heads(jax_model, params, port_model, x):
    want = jax_model.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = port_model(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=HEAD_ATOL)
    np.testing.assert_array_equal(decode_ks("mmoecut", got).numpy(),
                                  np.asarray(jax_decode_ks("mmoecut", want)))


def test_params_from_jax_covers_every_leaf(jax_mmoecut16):
    _, params = jax_mmoecut16
    leaves = {"/".join(k.key for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    state = params_from_jax(_np_tree(params))
    port_state = build_model("mmoecut", seq_len=16, input_size=3,
                             dropout=0.1).state_dict()
    assert set(state) == set(port_state)
    assert len(state) == len(leaves)
    for name, tensor in state.items():
        assert tuple(tensor.shape) == tuple(port_state[name].shape), name
    # the expert stack keeps its leading E axis
    key = "experts.attention_layer.layers_0.self_attn.in_proj_weight"
    assert tuple(state[key].shape) == (3, 768, 256)
    assert tuple(state["experts.attention_layer.layers_0.norm1.weight"].shape) == (3, 256)


def test_mmoecut_matches_jax_plain_path(jax_mmoecut16):
    jax_model, params = jax_mmoecut16
    _compare_heads(jax_model, params, _port_mmoecut(16, params), _features(0, 3, 16))


def test_mmoecut_matches_jax_kernel_path(monkeypatch):
    """The JAX forward through its Pallas kernels (interpret mode): L = 128
    reaches PALLAS_MIN_SEQ_LEN, so both the fused LSTM and the head-packed
    attention kernel run."""
    monkeypatch.setattr(jax_layers, "fused_lstm",
                        functools.partial(jax_layers.fused_lstm, interpret=True))
    monkeypatch.setattr(
        jax_attention, "fused_attention_packed",
        functools.partial(jax_attention.fused_attention_packed, interpret=True))
    seq_len = 128
    assert seq_len >= jax_attention.PALLAS_MIN_SEQ_LEN
    jax_model, params = _jax_mmoecut(seq_len, use_pallas=True, seed=1)
    _compare_heads(jax_model, params, _port_mmoecut(seq_len, params),
                   _features(1, 2, seq_len))


@pytest.mark.parametrize("num_layers,bidirectional", [(2, True), (1, False)])
def test_lstm_layer_matches_jax(num_layers, bidirectional):
    x = _features(2, 3, 11)
    jax_mod = jax_layers.LSTM(hidden_size=128, num_layers=num_layers,
                              bidirectional=bidirectional)
    params = jax_mod.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = jax_mod.apply({"params": params}, jnp.asarray(x))
    port = layers.LSTM(3, 128, num_layers, bidirectional)
    port.load_state_dict(params_from_jax(_np_tree(params)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_transformer_encoder_layer_matches_jax():
    """One JAX layer against the port's stacked layer with E = 1 (the JAX
    parameters gain the leading expert axis)."""
    x = _features(3, 2, 12).repeat(86, axis=-1)[..., :256]  # (2, 12, 256)
    jax_mod = jax_layers.TransformerEncoderLayer(d_model=256, n_head=4, dropout=0.1)
    params = jax_mod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want = jax_mod.apply({"params": params}, jnp.asarray(x), deterministic=True)
    port = layers.TransformerEncoderLayer(256, 4, 2048, experts=1).eval()
    stacked = jax.tree.map(lambda a: np.asarray(a)[None], params)
    port.load_state_dict(params_from_jax(stacked))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (1,) + tuple(want.shape)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_unported_models_and_training_forward_raise():
    """Every model of the zoo builds now (probe_base too,
    tests/test_torch_probe.py) and unknown names raise; MMOECut's training
    forward runs (a fresh module is in training mode), given a generator for
    its masks."""
    assert build_model("probe_base", seq_len=16, input_size=3, dropout=0.1) is not None
    with pytest.raises(ValueError, match="unknown model"):
        build_model("nope", seq_len=16, input_size=3, dropout=0.1)
    model = build_model("mmoecut", seq_len=16, input_size=3, dropout=0.1)
    assert model.training
    heads = model(torch.zeros(1, 16, 3), torch.Generator().manual_seed(0))
    assert [tuple(h.shape) for h in heads] == [(1, 16, 1)] * 3
    assert all(torch.isfinite(h).all() for h in heads)
    heads[-1].sum().backward()
    assert model.w_gates.grad is not None


def test_seeded_init_is_deterministic():
    a = build_model("mmoecut", seq_len=16, input_size=3, dropout=0.1, seed=5)
    b = build_model("mmoecut", seq_len=16, input_size=3, dropout=0.1, seed=5)
    c = build_model("mmoecut", seq_len=16, input_size=3, dropout=0.1, seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["w_gates"], sc["w_gates"])
