"""The port's kernel ops (rlt_tpu_torch.ops) against the JAX package's
Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor the port's wrappers run their plain PyTorch versions, so
these tests hold the plain versions to the JAX kernels;
tests/test_torch_card.py holds the CUDA kernels to the plain versions on a
card. Inputs are made with numpy from fixed seeds and handed to both
packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu.ops import attention as jax_attention
from rlt_tpu.ops import lstm as jax_lstm
from rlt_tpu_torch.ops import attention, lstm


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
    """A CPU tensor never reaches a kernel launcher: the counts stay put and
    no library is built."""
    before = (lstm.LSTM_FWD.launches, attention.ATTENTION_PACKED_FWD.launches)
    xw, w_hh_t = _lstm_inputs(4, length=3, batch=2, hidden=32)
    lstm.fused_lstm(torch.from_numpy(xw), torch.from_numpy(w_hh_t))
    attention.fused_attention_packed(*map(torch.from_numpy, _qkv(5, (2, 8, 128))),
                                     heads=2, pack=2)
    assert (lstm.LSTM_FWD.launches,
            attention.ATTENTION_PACKED_FWD.launches) == before


def test_wrappers_reject_what_they_do_not_take():
    q, k, v = map(torch.from_numpy, _qkv(6, (1, 8, 128)))
    with pytest.raises(NotImplementedError, match="dropout"):
        attention.fused_attention_packed(q, k, v, heads=2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="not divisible by pack"):
        attention.fused_attention_packed(q, k, v, heads=2, pack=3)
    with pytest.raises(ValueError, match="equal"):
        attention.fused_attention_packed(q, k[:, :4], v, heads=2)
    with pytest.raises(ValueError, match=r"\(H, 4H\)"):
        lstm.fused_lstm(torch.zeros(4, 2, 512), torch.zeros(128, 256))
    with pytest.raises(ValueError, match="expects xw"):
        lstm.fused_lstm(torch.zeros(2, 4, 2, 512), torch.zeros(128, 512))
