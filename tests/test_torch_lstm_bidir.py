"""The two-direction LSTM recurrence (ndir = 2) of the port against the JAX
package, and K2''s order of work emulated on the CPU.

The port's `lstm_fwd` / `lstm_bwd` take the JAX kernels' layout: both
directions of a BiLSTM layer folded into the batch axis, xw (L, 2B, 4H) and
W_hh^T (2H, 4H). On a CPU tensor they run their plain versions, held here
to `rlt_tpu.ops.lstm._fwd_pallas(True, 2, ...)` / `_bwd_pallas(True, 2,
...)` and to `fused_lstm_bidir(interpret=True)`; the bidirectional `LSTM`
module, which runs one two-direction op per layer, is held to the JAX
module on weights carried across by `params_from_jax`.
tests/test_torch_card.py holds the CUDA kernels to the plain versions on a
card. Inputs are made with numpy from fixed seeds.

The last test replays, in float32 torch on the CPU, the order in which the
redesigned K2' (`rlt_tpu_torch/csrc/lstm_bwd.cu`) computes: the gates and
their activations in a parallel pre-pass, folded into coefficients; dgates
on the reverse chain as linear in (dh, dc) with those coefficients; the
carried dh as four quarters of the 4H-term contraction (gate q's H columns
each) summed pairwise, (q0 + q1) + (q2 + q3), as the kernel's two xor
shuffles sum them; dW_hh^T as chunked partial products summed in chunk
order. It must agree with `lstm_bwd_plain` within the card's LSTM_BWD_REL,
the rehearsal of the kernel's arithmetic that a machine without a card can
give.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu.models import layers as jax_layers
from rlt_tpu.ops import lstm as jax_lstm
from rlt_tpu_torch.models import layers
from rlt_tpu_torch.ops import lstm
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

HIDDEN = 128
# f32 recurrence over 12 steps; the two frameworks sum the per-direction
# (B, H) x (H, 4H) products in different orders, a few ulps per step.
LSTM_ATOL = 1e-5
# the backward, relative to each gradient's max abs: 12 reverse steps of
# (B, 4H) x (4H, H) products and dW_hh^T's sum over 11 B (t, b) terms, in
# different orders
LSTM_BWD_REL = 2e-5
# the card's tolerance for K2' against its plain version (tests/test_torch_card.py)
CARD_LSTM_BWD_REL = 1e-4


def _bidir_inputs(seed, length, batch):
    """Both directions' xw (L, 2B, 4H) and W_hh^T (2H, 4H), and dho (L, 2B, H)."""
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(length, 2 * batch, 4 * HIDDEN)).astype(np.float32)
    w_hh_t = (rng.uniform(-1, 1, size=(2 * HIDDEN, 4 * HIDDEN))
              / np.sqrt(HIDDEN)).astype(np.float32)
    dho = rng.normal(size=(length, 2 * batch, HIDDEN)).astype(np.float32)
    return xw, w_hh_t, dho


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("batch", [3, 5])
def test_lstm_fwd_ndir2_matches_jax_kernel(batch):
    xw, w_hh_t, _ = _bidir_inputs(40 + batch, 12, batch)
    hs_j, cs_j = jax_lstm._fwd_pallas(True, 2, jnp.asarray(xw), jnp.asarray(w_hh_t))
    hs, cs = lstm.lstm_fwd(torch.from_numpy(xw), torch.from_numpy(w_hh_t), ndir=2)
    assert hs.shape == cs.shape == (12, 2 * batch, HIDDEN)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), rtol=0, atol=LSTM_ATOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), rtol=0, atol=LSTM_ATOL)


@pytest.mark.parametrize("batch", [3, 5])
def test_lstm_bwd_ndir2_matches_jax_kernel(batch):
    """The plain K2' at ndir = 2 against `_bwd_pallas(True, 2, ...)` on the
    JAX forward's hs and cs."""
    xw, w_hh_t, dho = _bidir_inputs(50 + batch, 12, batch)
    hs, cs = jax_lstm._fwd_pallas(True, 2, jnp.asarray(xw), jnp.asarray(w_hh_t))
    want_dxw, want_dw = jax_lstm._bwd_pallas(True, 2, jnp.asarray(xw),
                                             jnp.asarray(w_hh_t), hs, cs,
                                             jnp.asarray(dho))
    dxw, dw = lstm.lstm_bwd(*map(torch.from_numpy, (xw, w_hh_t, np.array(hs),
                                                    np.array(cs), dho)), ndir=2)
    assert dw.shape == (2 * HIDDEN, 4 * HIDDEN)
    assert _rel_err(dxw, want_dxw) <= LSTM_BWD_REL
    assert _rel_err(dw, want_dw) <= LSTM_BWD_REL


def test_fused_lstm_bidir_matches_jax():
    """Outputs and gradients of `fused_lstm_bidir` against the JAX function
    (interpret mode), through the port's LSTMRecurrence at ndir = 2."""
    rng = np.random.default_rng(60)
    length, batch = 12, 3
    xw_f, xw_r = (rng.normal(size=(length, batch, 4 * HIDDEN)).astype(np.float32)
                  for _ in range(2))
    w_f, w_r = ((rng.uniform(-1, 1, size=(HIDDEN, 4 * HIDDEN)) / np.sqrt(HIDDEN))
                .astype(np.float32) for _ in range(2))
    probe_f, probe_r = (rng.normal(size=(length, batch, HIDDEN)).astype(np.float32)
                        for _ in range(2))

    def jax_loss(af, ar, wf, wr):
        hf, hr = jax_lstm.fused_lstm_bidir(af, ar, wf, wr, interpret=True)
        return jnp.sum(hf * probe_f) + jnp.sum(hr * probe_r), (hf, hr)

    args = tuple(map(jnp.asarray, (xw_f, xw_r, w_f, w_r)))
    (_, want_hs), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                                  has_aux=True)(*args)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xw_f, xw_r, w_f, w_r)]
    hs_f, hs_r = lstm.fused_lstm_bidir(*leaves)
    ((hs_f * torch.from_numpy(probe_f)).sum()
     + (hs_r * torch.from_numpy(probe_r)).sum()).backward()
    for got, want in zip((hs_f, hs_r), want_hs):
        assert got.shape == (length, batch, HIDDEN)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=LSTM_ATOL)
    for leaf, want in zip(leaves, want_grads):
        assert _rel_err(leaf.grad, want) <= LSTM_BWD_REL


def test_lstm_recurrence_ndir2_gradcheck():
    """float64 finite differences against the plain backward at ndir = 2,
    tiny shapes (L = 4, B = 2 per direction, H = 4)."""
    rng = np.random.default_rng(61)
    xw = torch.from_numpy(rng.normal(size=(4, 4, 16))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(8, 16)) / 2).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: lstm.LSTMRecurrence.apply(a, b, 2), (xw, w))


@pytest.mark.parametrize("fuse_bidir", [True, False])
def test_bilstm_module_matches_jax_kernel_path(monkeypatch, fuse_bidir):
    """The port's 2-layer bidirectional LSTM (one ndir = 2 op per layer)
    against the JAX module with its Pallas kernels in interpret mode, both
    with the JAX package's fused two-direction path (RLT_LSTM_FUSE_BIDIR=1)
    and with its two one-direction launches; outputs and the gradients of
    every weight."""
    if fuse_bidir:
        monkeypatch.setenv("RLT_LSTM_FUSE_BIDIR", "1")
    else:
        monkeypatch.delenv("RLT_LSTM_FUSE_BIDIR", raising=False)
    monkeypatch.setattr(jax_layers, "fused_lstm",
                        functools.partial(jax_layers.fused_lstm, interpret=True))
    monkeypatch.setattr(jax_layers, "fused_lstm_bidir",
                        functools.partial(jax_layers.fused_lstm_bidir, interpret=True))
    rng = np.random.default_rng(62)
    x = rng.normal(size=(3, 11, 3)).astype(np.float32)
    probe = rng.normal(size=(3, 11, 2 * HIDDEN)).astype(np.float32)
    jax_mod = jax_layers.LSTM(hidden_size=HIDDEN, num_layers=2, use_pallas=True)
    params = jax_mod.init(jax.random.PRNGKey(63), jnp.asarray(x))["params"]

    def jax_loss(p):
        out = jax_mod.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * probe), out

    (_, want), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    port = layers.LSTM(3, HIDDEN, 2, bidirectional=True)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    before = lstm.LSTMRecurrence.apply
    calls = []
    monkeypatch.setattr(lstm.LSTMRecurrence, "apply",
                        lambda *a: calls.append(a[2]) or before(*a))
    got = port(torch.from_numpy(x))
    assert calls == [2, 2]  # one two-direction op per layer
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=LSTM_ATOL)
    (got * torch.from_numpy(probe)).sum().backward()
    grads = params_from_jax(jax.tree.map(np.asarray, want_grads))
    for name, p in port.named_parameters():
        assert _rel_err(p.grad, grads[name]) <= LSTM_BWD_REL, name


# ---------------------------------------------------------------------------
# K2''s order of work
# ---------------------------------------------------------------------------

def _per_dir(a: torch.Tensor, ndir: int, axis: int = 0) -> tuple:
    """Each direction's slice of `a` along `axis`."""
    return a.split(a.shape[axis] // ndir, dim=axis)


def k2_emulated(xw, w_hh_t, hs, cs, dho, ndir):
    """K2''s arithmetic in K2''s order, float32: (L, ndir B, 4H) xw, (ndir H,
    4H) W_hh^T, hs, cs, dho (L, ndir B, H) -> dxw, dW_hh^T."""
    length, rows, gates4 = xw.shape
    hidden = gates4 // 4
    batch = rows // ndir
    w_dirs = _per_dir(w_hh_t, ndir)
    # 1. the pre-pass: every step's gates and activations at once, folded
    # into the chain's coefficients
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
    gates = xw + torch.cat([h @ w for h, w in zip(_per_dir(h_prev, ndir, 1), w_dirs)], dim=1)
    i, f, g, o = gates.split(hidden, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    tanh_c = torch.tanh(cs)
    coef = [g * (i * (1 - i)), c_prev * (f * (1 - f)), i * (1 - g * g),
            tanh_c * (o * (1 - o))]
    gam = o * (1 - tanh_c * tanh_c)
    # 2. the chain: only what depends on the carries
    dxw = torch.empty_like(xw)
    dh_carry = dc_carry = torch.zeros(rows, hidden)
    for t in range(length - 1, -1, -1):
        dh = dho[t] + dh_carry
        dc = dc_carry + dh * gam[t]
        dc_carry = dc * f[t]
        dgates = torch.cat([dc * coef[0][t], dc * coef[1][t], dc * coef[2][t],
                            dh * coef[3][t]], dim=-1)
        dxw[t] = dgates
        quarters = [torch.cat([dg[:, q * hidden:(q + 1) * hidden]
                               @ w[:, q * hidden:(q + 1) * hidden].T
                               for dg, w in zip(_per_dir(dgates, ndir), w_dirs)])
                    for q in range(4)]
        dh_carry = (quarters[0] + quarters[1]) + (quarters[2] + quarters[3])
    # 3. dW_hh^T per direction: chunks of the (L - 1) B rows, summed in order
    splits = lstm.dw_splits(length, batch)
    dws = []
    for a, b in zip(_per_dir(hs[:-1], ndir, 1), _per_dir(dxw[1:], ndir, 1)):
        a, b = a.reshape(-1, hidden), b.reshape(-1, gates4)
        chunk = -(-a.shape[0] // splits)
        dw = torch.zeros(hidden, gates4)
        for s in range(splits):
            dw = dw + a[s * chunk:(s + 1) * chunk].T @ b[s * chunk:(s + 1) * chunk]
        dws.append(dw)
    return dxw, torch.cat(dws)


@pytest.mark.parametrize("ndir", [1, 2])
def test_k2_order_of_work_meets_card_tolerance(ndir):
    """At the main path's L = 300 (B = 4 per direction): the emulated
    kernel against `lstm_bwd_plain`, within the card's LSTM_BWD_REL of each
    gradient's max abs, and both against a float64 run."""
    length, batch = 300, 4
    rng = np.random.default_rng(64 + ndir)
    xw = torch.from_numpy(rng.normal(size=(length, ndir * batch, 4 * HIDDEN))
                          .astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, size=(ndir * HIDDEN, 4 * HIDDEN))
                          / np.sqrt(HIDDEN)).astype(np.float32))
    dho = torch.from_numpy(rng.normal(size=(length, ndir * batch, HIDDEN))
                           .astype(np.float32))
    hs, cs = lstm.lstm_recurrence_plain(xw, w, ndir)
    got = k2_emulated(xw, w, hs, cs, dho, ndir)
    want = lstm.lstm_bwd_plain(xw, w, hs, cs, dho, ndir)
    exact = lstm.lstm_bwd_plain(*(t.double() for t in (xw, w, hs, cs, dho)), ndir)
    for g, p, e in zip(got, want, exact):
        assert _rel_err(g, p) <= CARD_LSTM_BWD_REL
        assert _rel_err(g, e) <= CARD_LSTM_BWD_REL
