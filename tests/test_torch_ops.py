"""The port's kernel ops (rlt_tpu_torch.ops) against the JAX package's
Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor the port's wrappers run their plain PyTorch versions, so
these tests hold the plain versions to the JAX kernels;
tests/test_torch_card.py holds the CUDA kernels to the plain versions on a
card. Inputs are made with numpy from fixed seeds and handed to both
packages.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu.ops import attention as jax_attention
from rlt_tpu.ops import lstm as jax_lstm
from rlt_tpu_torch import ops
from rlt_tpu_torch.ops import attention, build, lstm
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)


def _lstm_inputs(seed, length, batch, hidden):
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(length, batch, 4 * hidden)).astype(np.float32)
    w_hh_t = (rng.uniform(-1, 1, size=(hidden, 4 * hidden))
              / np.sqrt(hidden)).astype(np.float32)
    return xw, w_hh_t


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=shape)).astype(np.float32) for _ in range(3)]


def _per_head_reference(q, k, v, heads, pack):
    """numpy float64 per-head softmax attention -> o, lse (JAX layout)."""
    n, length, d = q.shape
    dh = d // heads
    split = lambda t: t.astype(np.float64).reshape(n, length, heads, dh).transpose(0, 2, 1, 3)  # noqa: E731
    s = split(q) @ split(k).transpose(0, 1, 3, 2) / np.sqrt(dh)
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    o = (e / e.sum(-1, keepdims=True)) @ split(v)
    lse = (m + np.log(e.sum(-1, keepdims=True)))[..., 0]
    lse = lse.reshape(n, heads // pack, pack, length).transpose(0, 1, 3, 2)
    return o.transpose(0, 2, 1, 3).reshape(n, length, d), lse


# f32 recurrence over 16 steps; the two frameworks sum the (B, H) @ (H, 4H)
# product in different orders, a few ulps per step.
LSTM_ATOL = 1e-5


def test_fused_lstm_matches_jax_kernel():
    xw, w_hh_t = _lstm_inputs(0, length=16, batch=3, hidden=128)
    want = np.asarray(jax_lstm.fused_lstm(jnp.asarray(xw), jnp.asarray(w_hh_t),
                                          interpret=True))
    got = lstm.fused_lstm(torch.from_numpy(xw), torch.from_numpy(w_hh_t))
    assert got.shape == (16, 3, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LSTM_ATOL)


def test_lstm_fwd_cells_match_jax_kernel():
    """cs (the backward's saved cells) equals the Pallas kernel's second output."""
    xw, w_hh_t = _lstm_inputs(1, length=12, batch=5, hidden=128)
    hs_j, cs_j = jax_lstm._fwd_pallas(True, 1, jnp.asarray(xw), jnp.asarray(w_hh_t))
    hs, cs = lstm.lstm_fwd(torch.from_numpy(xw), torch.from_numpy(w_hh_t))
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), rtol=0, atol=LSTM_ATOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), rtol=0, atol=LSTM_ATOL)


# (2, 128, 256) f32: both sides take 128-term dot products and 128-term
# softmax sums in different orders; outputs are O(1).
ATTN_ATOL = 1e-5


def test_fused_attention_packed_matches_jax_kernel():
    q, k, v = _qkv(2, (2, 128, 256))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_o = np.asarray(jax_attention.fused_attention_packed(
        jq, jk, jv, heads=4, pack=2, interpret=True))
    _, want_lse = jax_attention._fwd_packed(0.0, True, 4, 2, jq, jk, jv,
                                            jnp.zeros((1,), jnp.int32))
    o, lse = attention.fused_attention_packed(
        *map(torch.from_numpy, (q, k, v)), heads=4, pack=2)
    assert o.shape == (2, 128, 256) and lse.shape == (2, 2, 128, 2)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=ATTN_ATOL)


def test_per_head_max_survives_far_apart_heads():
    """Head 0's scores are all exactly 128, head 1's are O(1): more than 120
    below, in one group of 2. The JAX kernel subtracts the group-wide max,
    so every exp of head 1 underflows and the group's o is not finite (the
    0/0 of head 1 reaches head 0 through the block-masked PV product); the
    port's
    per-head max keeps it finite and equal to a float64 per-head softmax.
    (Head 0's q = k = 4 makes its scores exact, so no float32 rounding of
    large scores enters the comparison.)"""
    rng = np.random.default_rng(3)
    n, length, heads, pack, dh = 1, 16, 2, 2, 64
    q, k, v = (rng.normal(size=(n, length, heads * dh)).astype(np.float32)
               for _ in range(3))
    q[..., :dh] = 4.0
    k[..., :dh] = 4.0  # head 0: 64 * 16 / sqrt(64) = 128 for every key
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jax_o, _ = jax_attention._fwd_packed(0.0, True, heads, pack, jq, jk, jv,
                                         jnp.zeros((1,), jnp.int32))
    assert not np.all(np.isfinite(np.asarray(jax_o)[..., dh:]))  # the premise

    o, lse = attention.fused_attention_packed(*map(torch.from_numpy, (q, k, v)),
                                              heads=heads, pack=pack)
    want_o, want_lse = _per_head_reference(q, k, v, heads, pack)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.numpy(), want_o, rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("d,heads,want", [(256, 4, 2), (128, 8, 8), (256, 2, None),
                                          (100, 3, None)])
def test_packed_group_size_matches_jax(d, heads, want):
    assert attention.packed_group_size(d, heads) == want
    assert jax_attention.packed_group_size(d, heads) == want


def test_cpu_tensors_take_the_plain_version_without_counting():
    """A CPU tensor never reaches a kernel launcher, forward or backward:
    the counts stay put and no library is built."""
    kernels = list(ops.KERNELS.values())
    before = [k.launches for k in kernels]
    xw, w_hh_t = (torch.from_numpy(a).requires_grad_()
                  for a in _lstm_inputs(4, length=3, batch=2, hidden=32))
    lstm.fused_lstm(xw, w_hh_t).sum().backward()
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(5, (2, 8, 128)))
    o, _ = attention.fused_attention_packed(q, k, v, heads=2, pack=2, dropout_rate=0.1,
                                            streams=torch.tensor([1, 2], dtype=torch.int32))
    o.sum().backward()
    qs, ks, vs = (torch.from_numpy(a).requires_grad_() for a in _qkv(6, (1, 2, 8, 128)))
    o, _ = attention.fused_attention(qs, ks, vs, dropout_rate=0.1,
                                     streams=torch.tensor([3, 4], dtype=torch.int32))
    o.sum().backward()
    assert xw.grad is not None and q.grad is not None and qs.grad is not None
    assert [k.launches for k in kernels] == before


def test_plain_ops_routes_every_kernel_and_restores():
    """The reference runs on the card swap every wrapper in KERNELS for its
    plain version, so none of them can compare a kernel with itself. An
    `_any` instance (a width the width-specialised one does not take) is
    launched by its twin's wrapper (`ops.INSTANCES`)."""
    assert set(ops.KERNELS) == set(ops.INSTANCES)
    assert set(ops.PLAIN_VERSIONS) == {inst.wrapper for inst in ops.INSTANCES.values()}
    assert {name for name, inst in ops.INSTANCES.items() if inst.widths} == set(
        ops.PLAIN_VERSIONS)
    wrappers = {name: getattr(module, name) for name, (module, _) in
                ops.PLAIN_VERSIONS.items()}
    with ops.plain_ops():
        for name, (module, plain) in ops.PLAIN_VERSIONS.items():
            assert getattr(module, name) is plain is not wrappers[name], name
    assert all(getattr(module, name) is wrappers[name]
               for name, (module, _) in ops.PLAIN_VERSIONS.items())


def test_wrappers_reject_what_they_do_not_take():
    q, k, v = map(torch.from_numpy, _qkv(6, (1, 8, 128)))
    with pytest.raises(ValueError, match="streams"):
        attention.fused_attention_packed(q, k, v, heads=2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="not divisible by pack"):
        attention.fused_attention_packed(q, k, v, heads=2, pack=3)
    with pytest.raises(ValueError, match="equal"):
        attention.fused_attention_packed(q, k[:, :4], v, heads=2)
    with pytest.raises(ValueError, match=r"\(H, 4H\)"):
        lstm.fused_lstm(torch.zeros(4, 2, 512), torch.zeros(128, 256))
    with pytest.raises(ValueError, match="expects xw"):
        lstm.fused_lstm(torch.zeros(2, 4, 2, 512), torch.zeros(128, 512))
    with pytest.raises(ValueError, match="dropout_rate"):
        attention.fused_attention_packed(q, k, v, heads=2, dropout_rate=1.0,
                                         streams=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="dho"):
        lstm.lstm_bwd(torch.zeros(4, 2, 512), torch.zeros(128, 512),
                      torch.zeros(4, 2, 128), torch.zeros(4, 2, 128),
                      torch.zeros(3, 2, 128))


# ---------------------------------------------------------------------------
# The training slice: keep_mask, K5' with dropout, K6', K2'
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 2, 2**31 - 1])
@pytest.mark.parametrize("gi", [0, 1, 2])
@pytest.mark.parametrize("rate", [0.1, 0.4])
def test_keep_mask_is_bit_exact(seed, gi, rate):
    """The torch twin against the JAX package's keep_mask on its
    _group_stream(_streams(seed, n)[b], gi), for the rows b of a batch;
    seeds near 2^31 - 1 wrap the stream and gi = 2 wraps the group offset."""
    n, shape = 3, (16, 2 * 16)
    want = np.stack([np.asarray(jax_attention.keep_mask(
        jax_attention._group_stream(row, gi), shape, rate))
        for row in jax_attention._streams(seed, n).reshape(n)])
    streams = attention._streams(seed, n)
    np.testing.assert_array_equal(
        np.asarray(attention._streams(seed, n)),
        np.asarray(jax_attention._streams(seed, n)).reshape(n))
    got = attention.keep_mask(attention._group_stream(streams, gi), shape, rate)
    assert got.shape == (n,) + shape and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_expert_streams_wrap_to_int32():
    seeds = torch.tensor([5, 2**31 - 2])
    got = attention.expert_streams(seeds, 3)
    assert got.dtype == torch.int32
    assert got.tolist() == [5, 6, 7, 2**31 - 2, 2**31 - 1, -2**31]


# f32, L = 128: dot products and softmax sums in another order, outputs O(1).
# With dropout the kept weights are scaled by 1 / (1 - rate) on both sides.
ATTN_BWD_ATOL = 2e-5


@pytest.mark.parametrize("heads,pack", [(4, 2), (6, 2)])
def test_fused_attention_packed_dropout_matches_jax_kernel(heads, pack):
    """The plain K5' with dropout against `_fwd_packed(rate, True, ...)`
    (interpret mode) on the same seed: o and lse within ATTN_ATOL. Six heads
    in groups of two run three head groups (gi = 2)."""
    q, k, v = _qkv(20, (2, 128, heads * 64))
    seed = 2**31 - 2  # the streams of row 1 wrap past int32
    jax_o, jax_lse = jax_attention._fwd_packed(
        0.1, True, heads, pack, *map(jnp.asarray, (q, k, v)),
        jnp.asarray([seed], jnp.int32))
    o, lse = attention.fused_attention_packed(
        *map(torch.from_numpy, (q, k, v)), heads=heads, pack=pack, dropout_rate=0.1,
        streams=attention._streams(seed, 2).to(torch.int32))
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_o), rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse), rtol=0, atol=ATTN_ATOL)
    o0, _ = attention.fused_attention_packed(*map(torch.from_numpy, (q, k, v)),
                                             heads=heads, pack=pack)
    assert not np.allclose(o.numpy(), o0.numpy(), atol=1e-3)  # the mask acts


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("heads,pack", [(4, 2), (6, 2)])
def test_attention_packed_bwd_matches_jax_kernel(rate, heads, pack):
    """The plain K6' against `_bwd_packed(rate, True, ...)` in interpret
    mode, both fed the JAX forward's o and lse and the same seed."""
    q, k, v = _qkv(21, (2, 128, heads * 64))
    do = np.random.default_rng(22).normal(size=q.shape).astype(np.float32)
    seed = 77
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jseed = jnp.asarray([seed], jnp.int32)
    jax_o, jax_lse = jax_attention._fwd_packed(rate, True, heads, pack, jq, jk, jv, jseed)
    want = jax_attention._bwd_packed(rate, True, heads, pack, jq, jk, jv, jax_o,
                                     jax_lse, jdo, jseed)
    got = attention.attention_packed_bwd(
        *map(torch.from_numpy, (q, k, v, np.array(jax_o), np.array(jax_lse), do)),
        heads, pack, rate, attention._streams(seed, 2).to(torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATTN_BWD_ATOL)


# f32 over 16 reverse steps; dW_hh^T sums 45 (t, b) products. The two sides
# sum the (B, 4H) x (4H, H) products and dW_hh^T in different orders.
LSTM_BWD_ATOL = 1e-5


def test_lstm_bwd_matches_jax_kernel():
    """The plain K2' against `lstm._bwd_pallas(True, 1, ...)` on the JAX
    forward's hs and cs."""
    xw, w_hh_t = _lstm_inputs(23, length=16, batch=3, hidden=128)
    dho = np.random.default_rng(24).normal(size=(16, 3, 128)).astype(np.float32)
    hs, cs = jax_lstm._fwd_pallas(True, 1, jnp.asarray(xw), jnp.asarray(w_hh_t))
    want_dxw, want_dw = jax_lstm._bwd_pallas(True, 1, jnp.asarray(xw),
                                             jnp.asarray(w_hh_t), hs, cs,
                                             jnp.asarray(dho))
    dxw, dw = lstm.lstm_bwd(*map(torch.from_numpy, (xw, w_hh_t, np.array(hs),
                                                    np.array(cs), dho)))
    np.testing.assert_allclose(dxw.numpy(), np.asarray(want_dxw), rtol=0,
                               atol=LSTM_BWD_ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), rtol=0,
                               atol=LSTM_BWD_ATOL)


def test_fused_lstm_grad_matches_jax():
    """Gradients of a loss through the port's LSTMRecurrence against
    jax.grad through the Pallas custom_vjp (interpret mode)."""
    import jax

    xw, w_hh_t = _lstm_inputs(25, length=12, batch=2, hidden=128)
    weights = np.random.default_rng(26).normal(size=(12, 2, 128)).astype(np.float32)

    def jax_loss(a, b):
        return jnp.sum(jax_lstm.fused_lstm(a, b, interpret=True) * weights)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(xw), jnp.asarray(w_hh_t))
    txw, tw = (torch.from_numpy(a).requires_grad_() for a in (xw, w_hh_t))
    (lstm.fused_lstm(txw, tw) * torch.from_numpy(weights)).sum().backward()
    for g, w in zip((txw.grad, tw.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=LSTM_BWD_ATOL)


def test_lstm_recurrence_gradcheck():
    """float64 finite differences against the plain backward, tiny shapes."""
    rng = np.random.default_rng(27)
    xw = torch.from_numpy(rng.normal(size=(5, 2, 16))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(4, 16)) / 2).requires_grad_()
    assert torch.autograd.gradcheck(lstm.LSTMRecurrence.apply, (xw, w))


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_attention_packed_gradcheck(rate):
    """float64 finite differences against the plain backward, tiny shapes,
    with and without the dropout mask (a fixed function of the streams)."""
    rng = np.random.default_rng(28)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 5, 8))).requires_grad_()
               for _ in range(3))
    streams = torch.tensor([3, 2**31 - 1], dtype=torch.int32)

    def fn(q, k, v):
        return attention.fused_attention_packed(q, k, v, heads=4, pack=2,
                                                dropout_rate=rate, streams=streams)[0]

    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_source_hash_follows_headers(tmp_path):
    """An edit to a .cuh header changes the build hash, so the library is
    rebuilt; the headers are hashed but not compiled on their own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = build.source_hash(csrc)
    assert before == build.source_hash(build.CSRC)
    header = csrc / "keep_mask.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert build.source_hash(csrc) != before
    assert all(src.suffix == ".cu" for src in build._sources(csrc))
