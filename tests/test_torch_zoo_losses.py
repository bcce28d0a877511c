"""The rest of the port's loss zoo against the JAX package's: bicut_loss,
choopy_loss, attncut_loss, div_loss in every form, wass_dist_loss and the
registry (mtcut_loss and its parts: tests/test_torch_losses.py).

Outputs and labels are made with numpy from fixed seeds and handed to both;
each loss's value and its gradient with respect to the output are
compared, with and without a `valid` row mask, the JAX side through
`jax.value_and_grad`, the port's through autograd, both in float32 on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu.utils import losses as jax_losses
from rlt_tpu_torch.utils import losses
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

# f32 sums over L = 20 positions and B = 5 rows in another order; the
# reward targets' softmaxes differ in the last bits. Values within 1e-5
# relative, gradients within 1e-5 of their max abs.
VALUE_RTOL = 1e-5
GRAD_REL = 1e-5
# Sinkhorn: 100 log-domain iterations at eps = 1e-3 divide each cost by
# eps, so an f32 rounding of the cost is 1e3 times larger in the exponents.
# The f32 values agree within 1e-6 relative, but the f32 gradients part by
# up to 1.2e-3 of their max abs after 100 unfrozen iterations; in float64
# both the values and the gradients agree within 5e-8. So the value is held
# at 1e-4 relative in f32, and value and gradient at 1e-4 in float64.
WASS_REL = 1e-4

B, L = 5, 20
VALID = np.array([1, 1, 1, 1, 0], np.float32)  # a padded last row


def _softmax(z, axis):
    e = np.exp(z - z.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


def _labels(rng):
    labels = (rng.random((B, L)) < 0.3).astype(np.float32)
    labels[:, 0], labels[:, 1] = 1.0, 0.0
    return labels


def _compare(jax_fn, port_fn, output, labels, valid, value_rtol=VALUE_RTOL,
             grad_rel=GRAD_REL):
    """Value within `value_rtol` relative and gradient within `grad_rel` of
    its max abs (the gradient unchecked when `grad_rel` is None)."""
    jv = None if valid is None else jnp.asarray(valid)
    want, want_grad = jax.value_and_grad(
        lambda o: jax_fn(o, jnp.asarray(labels), valid=jv))(jnp.asarray(output))
    t = torch.from_numpy(output).requires_grad_()
    got = port_fn(t, torch.from_numpy(labels),
                  valid=None if valid is None else torch.from_numpy(valid))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=value_rtol)
    if grad_rel is not None:
        want_grad = np.asarray(want_grad)
        assert np.abs(t.grad.numpy() - want_grad).max() <= grad_rel * np.abs(want_grad).max()
    return got.item()


@pytest.mark.parametrize("valid", [None, VALID], ids=["all", "masked"])
@pytest.mark.parametrize("metric", ["nci", "f1"])
def test_bicut_loss_matches_jax(metric, valid):
    """BiCut's (B, L, 2) decision pairs: rows with truncates in the middle,
    a row whose last truncate is at its first position, and a row where
    every position says continue (nothing masked)."""
    rng = np.random.default_rng(60)
    output = _softmax(rng.normal(size=(B, L, 2)), axis=-1)
    output[1, :, 1] = np.maximum(output[1, :, 1], 0.6)  # all continue
    output[1, :, 0] = 1.0 - output[1, :, 1]
    output[2, 1:, 1] = np.maximum(output[2, 1:, 1], 0.6)  # truncate only at 0
    output[2, 1:, 0] = 1.0 - output[2, 1:, 1]
    output[2, 0] = (0.9, 0.1)
    labels = _labels(rng)
    value = _compare(lambda o, y, valid: jax_losses.bicut_loss(o, y, metric=metric,
                                                              valid=valid),
                     lambda o, y, valid: losses.bicut_loss(o, y, metric=metric,
                                                           valid=valid),
                     output, labels, valid)
    assert value != 0.0
    decisions = output.argmax(-1)
    assert decisions[1].sum() == L and decisions[2].sum() == L - 1


@pytest.mark.parametrize("valid", [None, VALID], ids=["all", "masked"])
@pytest.mark.parametrize("metric", ["f1", "dcg"])
@pytest.mark.parametrize("name", ["choopy", "attncut"])
def test_choopy_and_attncut_losses_match_jax(name, metric, valid):
    rng = np.random.default_rng(61)
    output = _softmax(2 * rng.normal(size=(B, L, 1)), axis=1)
    labels = _labels(rng)
    _compare(lambda o, y, valid: getattr(jax_losses, f"{name}_loss")(
                 o, y, metric=metric, valid=valid),
             lambda o, y, valid: getattr(losses, f"{name}_loss")(
                 o, y, metric=metric, valid=valid),
             output, labels, valid)


@pytest.mark.parametrize("valid", [None, VALID], ids=["all", "masked"])
@pytest.mark.parametrize("augmented", [True, False])
@pytest.mark.parametrize("div_type", ["kl", "js"])
def test_div_loss_matches_jax(div_type, augmented, valid):
    rng = np.random.default_rng(62)
    output = _softmax(2 * rng.normal(size=(B, L, 1)), axis=1)
    labels = _labels(rng)
    kw = dict(metric="dcg", div_type=div_type, augmented=augmented)
    _compare(lambda o, y, valid: jax_losses.div_loss(o, y, valid=valid, **kw),
             lambda o, y, valid: losses.div_loss(o, y, valid=valid, **kw),
             output, labels, valid)


def test_div_loss_defaults_are_the_jax_packages():
    """div_loss defaults to KL at tau 0.85 with augmentation, as the JAX
    package's; mtcut_loss asks for JS explicitly."""
    rng = np.random.default_rng(63)
    output = torch.from_numpy(_softmax(2 * rng.normal(size=(B, L, 1)), axis=1))
    labels = torch.from_numpy(_labels(rng))
    kl = losses.div_loss(output, labels, div_type="kl", tau=0.85, augmented=True)
    assert losses.div_loss(output, labels).item() == kl.item()
    np.testing.assert_allclose(
        losses.div_loss(output, labels).item(),
        float(jax_losses.div_loss(jnp.asarray(output.numpy()), jnp.asarray(labels.numpy()))),
        rtol=VALUE_RTOL)
    js = losses.div_loss(output, labels, div_type="js", augmented=True)
    heads = [output, output, output]
    total = losses.mtcut_loss(heads, labels, rerank_weight=0.0, classi_weight=0.0)
    assert total.item() == js.item() != kl.item()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("valid", [None, VALID], ids=["all", "masked"])
@pytest.mark.parametrize("threshold", [1e-1, 1e-7], ids=["freezes", "runs_out"])
def test_wass_dist_loss_matches_jax(threshold, valid, dtype):
    """Sinkhorn with convergence freezing (the default threshold stops the
    updates early) and with a threshold no step meets (all 100 run): the
    value in float32, value and gradient in float64 (WASS_REL)."""
    rng = np.random.default_rng(64)
    output = _softmax(2 * rng.normal(size=(B, L, 1)), axis=1).astype(dtype)
    labels = _labels(rng).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        _compare(lambda o, y, valid: jax_losses.wass_dist_loss(o, y, threshold=threshold,
                                                               valid=valid),
                 lambda o, y, valid: losses.wass_dist_loss(o, y, threshold=threshold,
                                                           valid=valid),
                 output, labels, valid, value_rtol=WASS_REL,
                 grad_rel=WASS_REL if dtype == np.float64 else None)


def test_loss_registry_matches_jax():
    assert set(losses.LOSSES) == set(jax_losses.LOSSES)
    for name, fn in losses.LOSSES.items():
        assert fn.__name__ == jax_losses.LOSSES[name].__name__
    loss = losses.make_loss("div", metric="f1", div_type="js")
    assert loss.func is losses.div_loss and loss.keywords == dict(metric="f1",
                                                                  div_type="js")
