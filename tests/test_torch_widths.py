"""K1'-K6' at every hidden and head width the JAX package takes, on the CPU.

The width-specialised CUDA kernels take H in {64, 96, 128} (K1', K2'; every
H below 128 padded with zeros to one of them) and dh 16 and 64 packed, 128
per slice (K3'-K6'); `csrc/lstm_any.cu` and `csrc/attention_any_dh.cu` take
every other width (H from 129 to 2048, dh up to 512). On a CPU tensor the
wrappers run their plain versions at any width, held here to the JAX
kernels in interpret mode: K1'/K2' at H 40, 100 and 256 over 1, 2 and 4
directions (4: two population members' BiLSTM layers), and through the
zero-padding that takes H below 128 to a width of the specialised kernels
on the card; K3'/K4' at dh 8, 32 and 200, K5'/K6' at (heads, dh, pack) (8,
8, 4), (4, 32, 4) and (6, 8, 2), in f32 and bf16, with and without
dropout. `ops.INSTANCES` names the instance each width launches. Then the two
configurations of this slice, `MMOECut(encoding_size=256, d_model=512,
n_head=16)` (K1'/K2' at H 256, K5'/K6' at dh 32, pack 4) and
`PLECut(encoding_size=100, d_model=200, n_head=1)` (H 100, K3'/K4' at dh
200), built through `build_model`'s width keywords, against the JAX models
on weights carried across by `params_from_jax`: every leaf, heads and cuts,
and step-1 gradients; a population of two members at a new width against
each member's Trainer. Last, the kernels' refusal of the widths they do not
take names the range. tests/test_torch_card.py holds the CUDA kernels to
the plain versions on a card. Inputs are made with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import rlt_tpu.ops.attention as jax_attention
from rlt_tpu import config as jax_config
from rlt_tpu import train as jax_train
from rlt_tpu.models.mmoe import MMOECut as JaxMMOECut
from rlt_tpu.models.mmoe import PLECut as JaxPLECut
from rlt_tpu.ops import lstm as jax_lstm
from rlt_tpu_torch import train
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.infer import decode_ks
from rlt_tpu_torch.models import build_model, build_population_model
from rlt_tpu_torch import ops
from rlt_tpu_torch.ops import attention, lstm
from rlt_tpu_torch.population import Member, Population, member_config
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

# K1' f32: the plain loop and the JAX kernel sum each step's H-term products
# in another order, up to 256 terms here, over 16 steps (the 128-wide
# tests' 1e-5, tests/test_torch_lstm_bidir.py).
LSTM_ATOL = 1e-5
# K2' f32, relative to each gradient's max abs: 16 reverse steps of (B, 4H)
# x (4H, H) products and dW_hh^T's sum over 15 B rows, in another order.
LSTM_BWD_REL = 2e-5
# K3'-K6' f32: dh-term dot products and L-term softmax sums in another
# order; o is O(1), lse O(log L) (tests/test_torch_plecut.py).
ATTN_ATOL = 1e-5
ATTN_BWD_ATOL = 2e-5
# bf16, as tests/test_torch_bf16.py and test_torch_bf16_train_ops.py state
# them: cs and lse f32 (1e-5); hs and dxw one bf16 ulp of each element
# beyond the f32 order noise (CS_ATOL, DW_REL of the max abs); o, dq, dk, dv
# within 2 bf16 steps of each one's max abs; dW_hh^T f32, 1e-5 of its max
# abs.
CS_ATOL = 1e-5
BF16_ULPS = 1
BF16_ULPS_OF_MAX = 2
DW_REL = 1e-5
# Whole models (tests/test_torch_plecut.py's HEAD_ATOL, GRAD_REL,
# GRAD_FLOOR): heads 1e-5; step-1 gradients 1e-3 of each one's max abs plus
# a floor for the towers' biases, zero by algebra.
HEAD_ATOL = 1e-5
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-7

LENGTH, BATCH = 16, 3
SEED = 2**31 - 3  # the streams of rows 3 and up wrap past int32


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _both(x: np.ndarray, bf16: bool):
    """One float32 array as a JAX array and a torch tensor, both bf16 or both
    float32."""
    if bf16:
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


def _to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of its dtype."""
    t = torch.from_numpy(np.array(_f32(a)))  # a writable copy
    return t.bfloat16() if a.dtype == jnp.bfloat16 else t


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(got: torch.Tensor, want, bf16: bool, atol: float) -> None:
    """f32: within atol; bf16: within 2 bf16 steps of the max abs."""
    got, want = got.float().numpy(), _f32(want)
    limit = BF16_ULPS_OF_MAX * bf16_ulp(np.abs(want).max()) if bf16 else atol
    assert np.abs(got - want).max() <= limit


# ---------------------------------------------------------------------------
# K1' and K2' (plain versions) at H 40, 100, 256 against the JAX kernels
# ---------------------------------------------------------------------------

def _lstm_inputs(seed, hidden, ndir):
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(LENGTH, ndir * BATCH, 4 * hidden)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(ndir * hidden, 4 * hidden)) / np.sqrt(hidden)
         ).astype(np.float32)
    dho = rng.normal(size=(LENGTH, ndir * BATCH, hidden)).astype(np.float32)
    return xw, w, dho


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("hidden,ndir", [(40, 1), (100, 2), (256, 2), (100, 4), (256, 1)])
def test_lstm_matches_jax_kernel_at_any_hidden(hidden, ndir, bf16):
    """The plain K1' and K2' at H outside {64, 96, 128} against
    `_fwd_pallas` / `_bwd_pallas(True, ndir, ...)` on the same operands."""
    fwd, bwd = ((lstm.lstm_fwd_bf16, lstm.lstm_bwd_bf16) if bf16
                else (lstm.lstm_fwd, lstm.lstm_bwd))
    _lstm_against_jax(fwd, bwd, hidden, ndir, bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("hidden,ndir", [(1, 1), (40, 1), (100, 2), (100, 4)])
def test_lstm_padded_to_a_kernel_width_matches_jax_kernel(hidden, ndir, bf16):
    """What the wrappers do on the card below H 128: xw's gate blocks and
    W_hh^T padded with zeros to the next of {64, 96, 128}
    (`at_kernel_width_fwd` / `_bwd`, here around the plain versions), the
    outputs sliced back; held to the JAX kernels at the unpadded width by
    the same tolerances, since a padded unit stays 0 and adds nothing."""
    assert lstm.kernel_hidden(hidden) in lstm.KERNEL_HIDDEN
    _lstm_against_jax(
        lambda xw, w, n: lstm.at_kernel_width_fwd(lstm.lstm_recurrence_plain, xw, w, n),
        lambda *a: lstm.at_kernel_width_bwd(lstm.lstm_bwd_plain, *a), hidden, ndir, bf16)


@pytest.mark.parametrize("wrapper", sorted(ops.PLAIN_VERSIONS))
def test_instance_at_names_the_instance_each_width_launches(wrapper):
    """`ops.INSTANCES`, the one table of instances and wrappers: the LSTM
    wrappers launch their width-specialised instance at every H up to 128
    (padded) and `_any` above it; the attention wrappers theirs at its
    widths and `_any` at every other dh."""
    name = ops.instance_at
    if ops.PLAIN_VERSIONS[wrapper][0] is lstm:
        special, other = (1, 40, 64, 96, 100, 128), (129, 200, 256, lstm.MAX_HIDDEN)
    elif "packed" in wrapper:
        special, other = attention.PACKED_HEAD_DIMS, (1, 8, 32, 128, 200, 512)
    else:
        special, other = (attention.SLICE_HEAD_DIM,), (1, 8, 16, 32, 64, 200, 512)
    assert {name(wrapper, w) for w in special} == {wrapper}
    (any_name,) = {name(wrapper, w) for w in other}
    inst = ops.INSTANCES[any_name]
    assert inst.wrapper == wrapper and inst.widths is None
    assert inst.kernel is not ops.KERNELS[wrapper]


def _lstm_against_jax(fwd, bwd, hidden: int, ndir: int, bf16: bool) -> None:
    xw, w, dho = _lstm_inputs(500 + hidden + ndir, hidden, ndir)
    (jxw, txw), (jw, tw), (jdo, tdo) = (_both(a, bf16) for a in (xw, w, dho))
    want_hs, want_cs = jax_lstm._fwd_pallas(True, ndir, jxw, jw)
    hs, cs = fwd(txw, tw, ndir)
    assert tuple(hs.shape) == (LENGTH, ndir * BATCH, hidden) and cs.dtype == torch.float32
    np.testing.assert_allclose(cs.numpy(), np.asarray(want_cs), rtol=0,
                               atol=CS_ATOL if bf16 else LSTM_ATOL)
    want = _f32(want_hs)
    if bf16:
        # one ulp beyond the f32 order noise that cs shows (CS_ATOL), which an
        # h made tiny by cancellation (c near 0) carries at many of its ulps
        assert np.all(np.abs(hs.float().numpy() - want)
                      <= BF16_ULPS * bf16_ulp(want) + CS_ATOL)
    else:
        np.testing.assert_allclose(hs.numpy(), want, rtol=0, atol=LSTM_ATOL)
    # the backward on the JAX forward's hs and cs
    want_dxw, want_dw = jax_lstm._bwd_pallas(True, ndir, jxw, jw, want_hs, want_cs, jdo)
    dxw, dw = bwd(txw, tw, _to_torch(want_hs), torch.from_numpy(_f32(want_cs)), tdo, ndir)
    assert tuple(dw.shape) == (ndir * hidden, 4 * hidden) and dw.dtype == torch.float32
    want = _f32(want_dxw)
    if bf16:
        # one ulp beyond the f32 order noise, which a dgate made small by
        # cancellation carries at many of its own ulps
        slack = DW_REL * np.abs(want).max()
        assert np.all(np.abs(dxw.float().numpy() - want)
                      <= BF16_ULPS * bf16_ulp(want) + slack)
        assert _rel_err(dw.numpy(), want_dw) <= DW_REL
    else:
        assert _rel_err(dxw.numpy(), want) <= LSTM_BWD_REL
        assert _rel_err(dw.numpy(), want_dw) <= LSTM_BWD_REL


# ---------------------------------------------------------------------------
# K3'/K4' at dh 8, 32, 200 and K5'/K6' at other packs, against the JAX kernels
# ---------------------------------------------------------------------------

def _seed_streams(n: int):
    return (jnp.full((1,), SEED, jnp.int32),
            attention._streams(torch.tensor(SEED), n).to(torch.int32))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dh", [8, 32, 200])
def test_slice_attention_matches_jax_kernel_at_any_dh(dh, rate, bf16):
    """The plain K3' and K4' at dh outside {128} against `_fwd_pallas` /
    `_bwd_pallas`, each slice b * H + h on the stream seed + b * H + h."""
    rng = np.random.default_rng(600 + dh)
    shape = (2, 2, 24, dh)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _both(rng.normal(size=shape).astype(np.float32), bf16) for _ in range(4))
    seed, streams = _seed_streams(4)
    want_o, want_lse = jax_attention._fwd_pallas(rate, True, jq, jk, jv, seed)
    fwd, bwd = ((attention.attention_fwd_bf16, attention.attention_bwd_bf16) if bf16
                else (attention.attention_fwd, attention.attention_bwd))
    o, lse = fwd(tq, tk, tv, rate, streams)
    assert tuple(o.shape) == shape and tuple(lse.shape) == (4, 1, 24)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0, atol=ATTN_ATOL)
    _close(o, want_o, bf16, ATTN_ATOL)
    want = jax_attention._bwd_pallas(rate, True, jq, jk, jv, want_o, want_lse, jdo, seed)
    got = bwd(tq, tk, tv, _to_torch(want_o), torch.from_numpy(_f32(want_lse)), tdo, rate,
              streams)
    for g, w in zip(got, want):
        assert tuple(g.shape) == shape
        _close(g, w, bf16, ATTN_BWD_ATOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("heads,dh,pack", [(8, 8, 4), (4, 32, 4), (6, 8, 2)])
def test_packed_attention_matches_jax_kernel_at_any_dh(heads, dh, pack, rate, bf16):
    """The plain K5' and K6' at dh outside {16, 64} and a pack below the
    heads against `_fwd_packed` / `_bwd_packed`: the lse layout (N, H /
    pack, L, pack) and each group's stream."""
    rng = np.random.default_rng(700 + heads + dh + pack)
    n, length = 3, 24
    shape = (n, length, heads * dh)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _both(rng.normal(size=shape).astype(np.float32), bf16) for _ in range(4))
    seed, streams = _seed_streams(n)
    want_o, want_lse = jax_attention._fwd_packed(rate, True, heads, pack, jq, jk, jv, seed)
    fwd, bwd = ((attention.attention_packed_fwd_bf16, attention.attention_packed_bwd_bf16)
                if bf16 else (attention.attention_packed_fwd, attention.attention_packed_bwd))
    o, lse = fwd(tq, tk, tv, heads, pack, rate, streams)
    assert tuple(lse.shape) == (n, heads // pack, length, pack) == want_lse.shape
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0, atol=ATTN_ATOL)
    _close(o, want_o, bf16, ATTN_ATOL)
    want = jax_attention._bwd_packed(rate, True, heads, pack, jq, jk, jv, want_o, want_lse,
                                     jdo, seed)
    got = bwd(tq, tk, tv, _to_torch(want_o), torch.from_numpy(_f32(want_lse)), tdo, heads,
              pack, rate, streams)
    for g, w in zip(got, want):
        assert tuple(g.shape) == shape
        _close(g, w, bf16, ATTN_BWD_ATOL)


# ---------------------------------------------------------------------------
# The two configurations against the JAX models
# ---------------------------------------------------------------------------

CONFIGS = {
    # K1'/K2' at H 256, K5'/K6' at 16 heads of dh 32 in groups of pack 4
    "mmoecut-wide": ("mmoecut", JaxMMOECut, dict(encoding_size=256, d_model=512, n_head=16)),
    # K1'/K2' at H 100, K3'/K4' at one head of dh 200
    "mtple-dh200": ("mtple", JaxPLECut, dict(encoding_size=100, d_model=200, n_head=1)),
}


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _features(seed):
    return np.random.default_rng(seed).normal(size=(BATCH, LENGTH, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_config_model(request):
    """(config, JAX model at dropout 0, its params): one init a config."""
    name, cls, widths = CONFIGS[request.param]
    model = cls(seq_len=LENGTH, input_size=3, dropout=0.0, use_pallas=False, **widths)
    key = jax.random.PRNGKey(7)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((1, LENGTH, 3), jnp.float32))["params"]
    return request.param, model, params


def _port(config: str, params) -> torch.nn.Module:
    name, _, widths = CONFIGS[config]
    model = build_model(name, seq_len=LENGTH, input_size=3, dropout=0.0, **widths)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    return model


def test_widths_reach_the_any_width_kernels(jax_config_model):
    """The configurations' widths are the ones the width-specialised
    instances do not take: their kernels on the card are the `_any` ones."""
    config, _, params = jax_config_model
    model = _port(config, params)
    hidden = model.pre_encoding.hidden_size
    assert hidden not in lstm.KERNEL_HIDDEN and hidden <= lstm.MAX_HIDDEN
    attn = model.experts.attention_layer.layers_0.self_attn
    dh = attn.d_model // attn.n_head
    if config == "mmoecut-wide":
        assert (attn.pack, dh) == (4, 32) and dh not in attention.PACKED_HEAD_DIMS
    else:
        assert attn.pack is None and dh == 200 != attention.SLICE_HEAD_DIM


def test_params_from_jax_covers_every_leaf(jax_config_model):
    config, _, params = jax_config_model
    name, _, widths = CONFIGS[config]
    leaves = jax.tree_util.tree_leaves(params)
    state = params_from_jax(_np_tree(params))
    port_state = build_model(name, seq_len=LENGTH, input_size=3, dropout=0.0,
                             **widths).state_dict()
    assert set(state) == set(port_state) and len(state) == len(leaves)
    for key, tensor in state.items():
        assert tuple(tensor.shape) == tuple(port_state[key].shape), key


def test_heads_and_cuts_match_jax(jax_config_model):
    config, jax_model, params = jax_config_model
    name = CONFIGS[config][0]
    x = _features(800)
    want = jax_model.apply({"params": params}, jnp.asarray(x), deterministic=True)
    port = _port(config, params).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=HEAD_ATOL)
    np.testing.assert_array_equal(decode_ks(name, got).numpy(),
                                  np.asarray(jax_train.decode_ks(name, want)))


def test_step1_gradients_match_jax(jax_config_model):
    """Training-mode heads, the criterion and every parameter's gradient
    against `jax.value_and_grad`, at dropout 0."""
    config, jax_model, params = jax_config_model
    name = CONFIGS[config][0]
    rng = np.random.default_rng(810)
    x = _features(811)
    y = (rng.random((BATCH, LENGTH)) < 0.3).astype(np.float32)
    y[:, 0] = 1.0
    valid = np.array([1, 1, 0], np.float32)
    jax_crit = jax_train.make_criterion(jax_config.TrainConfig(model_name=name,
                                                               criterion="dcg"))

    def jax_loss(p):
        out = jax_model.apply({"params": p}, jnp.asarray(x), deterministic=False)
        return jax_crit(out, jnp.asarray(y), valid=jnp.asarray(valid))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    model = _port(config, params).train()
    loss = train.make_criterion(TrainConfig(model_name=name, criterion="dcg"))(
        model(torch.from_numpy(x)), torch.from_numpy(y), valid=torch.from_numpy(valid))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    want = params_from_jax(_np_tree(want_grads))
    for key, p in model.named_parameters():
        g, w = p.grad.numpy(), want[key].numpy()
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + GRAD_FLOOR, key


def test_population_at_a_new_width_matches_its_members():
    """Two PLECut-dh200 members as one `Population` (its `model`,
    `build_population_model(..., **widths)`: K1'/K2' at H 100 over 2K
    directions, K3'/K4' over the members' slices) against each member's
    own `Trainer` (`model=build_model(..., seed, **widths)`) for one epoch
    at dropout 0: the first step's loss, before any update, and every
    step's loss within the sequential test's bound
    (tests/test_torch_population.py: Adam moves an element whose gradient
    is rounding noise by about lr either way)."""
    name, _, widths = CONFIGS["mtple-dh200"]
    cfg = TrainConfig(model_name=name, retrieve_data="robust04", seq_len_override=LENGTH,
                      synthetic_queries=8, batch_size=4, epochs=1, dropout=0.0, lr=1e-3,
                      weight_decay=0.0)
    members = [Member(seed=1), Member(seed=2)]
    model = build_population_model(name, seq_len=LENGTH, input_size=cfg.input_size,
                                   dropout=0.0, seeds=[m.seed for m in members], **widths)
    got = Population(cfg, members, device="cpu", model=model).run_epoch()
    for m, epoch in zip(members, got):
        c = member_config(cfg, m)
        trainer = train.Trainer(c, device="cpu", model=build_model(
            name, seq_len=LENGTH, input_size=c.input_size, dropout=0.0, seed=m.seed,
            **widths))
        want = trainer.run_epoch()["train_loss_steps"]
        np.testing.assert_allclose(epoch["train_loss_steps"][0], want[0], rtol=1e-6)
        np.testing.assert_allclose(epoch["train_loss_steps"], want, rtol=2e-4)


# ---------------------------------------------------------------------------
# The widths no kernel takes raise, with the range named
# ---------------------------------------------------------------------------

def _card_tensor(mode, *shape, dtype=torch.float32):
    """A tensor that claims to lie on the card and holds nothing: enough for
    the wrappers' checks, which run before any launch."""
    return FakeTensor(mode, torch.empty(*shape, dtype=dtype, device="meta"),
                      torch.device("cuda"))


def test_widths_past_the_kernels_raise_with_the_range():
    mode = FakeTensorMode()
    hidden = lstm.MAX_HIDDEN + 1
    xw, w = _card_tensor(mode, 2, 1, 4 * hidden), _card_tensor(mode, hidden, 4 * hidden)
    with pytest.raises(ValueError, match=rf"1 <= H <= {lstm.MAX_HIDDEN}"):
        lstm.lstm_fwd(xw, w)
    dh = attention.MAX_HEAD_DIM + 8
    q = _card_tensor(mode, 1, 1, 4, dh)
    with pytest.raises(ValueError, match=rf"1 <= dh <= {attention.MAX_HEAD_DIM}"):
        attention.attention_fwd(q, q, q)
    qp = _card_tensor(mode, 1, 4, 2 * dh)
    with pytest.raises(ValueError, match=rf"1 <= dh <= {attention.MAX_HEAD_DIM}"):
        attention.attention_packed_fwd(qp, qp, qp, 2, 2)
