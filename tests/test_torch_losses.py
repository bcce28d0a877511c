"""The port's losses (rlt_tpu_torch.utils.losses) against the JAX package's.

Heads and labels are made with numpy from fixed seeds and handed to both;
values and gradients with respect to the heads are compared, the JAX side
through `jax.value_and_grad`, the port's through autograd. Both sides run in
float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu.utils import losses as jax_losses
from rlt_tpu.utils import metrics as jax_metrics
from rlt_tpu_torch.utils import losses, metrics
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

# f32 sums over L = 20 positions and B = 5 rows of O(1) terms, in another
# order; the softmaxes of the reward targets differ in the last bits. The
# KL gradient -q/p reaches ~10, so gradients are compared relatively too.
VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6

B, L = 5, 20


def _heads(seed, num_tasks=3):
    """Sigmoid class head, softmax rerank head, softmax cut head (B, L, 1),
    and binary labels whose rows all hold a relevant and an irrelevant doc."""
    rng = np.random.default_rng(seed)

    def softmax(z):
        e = np.exp(z - z.max(1, keepdims=True))
        return (e / e.sum(1, keepdims=True)).astype(np.float32)

    heads = {"class": (1 / (1 + np.exp(-rng.normal(size=(B, L, 1))))).astype(np.float32),
             "rerank": softmax(rng.normal(size=(B, L, 1))),
             "cut": softmax(2 * rng.normal(size=(B, L, 1)))}
    labels = (rng.random((B, L)) < 0.3).astype(np.float32)
    labels[:, 0], labels[:, 1] = 1.0, 0.0
    names = {3: ("class", "rerank", "cut"), 2.1: ("class", "cut"),
             2.2: ("rerank", "cut")}[num_tasks]
    return [heads[n] for n in names], labels


VALID = np.array([1, 1, 1, 1, 0], np.float32)  # a padded last row


def _compare(jax_fn, port_fn, heads, labels, valid):
    """Value and gradient with respect to every head."""
    want, want_grads = jax.value_and_grad(
        lambda hs: jax_fn(hs, jnp.asarray(labels), None if valid is None else jnp.asarray(valid)))(
        [jnp.asarray(h) for h in heads])
    t_heads = [torch.from_numpy(h).requires_grad_() for h in heads]
    got = port_fn(t_heads, torch.from_numpy(labels),
                  None if valid is None else torch.from_numpy(valid))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_RTOL, atol=VALUE_ATOL)
    for h, w in zip(t_heads, want_grads):
        np.testing.assert_allclose(h.grad.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    return got.item()


@pytest.mark.parametrize("metric", ["f1", "dcg"])
@pytest.mark.parametrize("num_tasks", [3, 2.1, 2.2])
@pytest.mark.parametrize("valid", [None, VALID], ids=["all", "masked"])
def test_mtcut_loss_matches_jax(metric, num_tasks, valid):
    heads, labels = _heads(1, num_tasks)
    kw = dict(metric=metric, rerank_weight=0.5, classi_weight=0.5, num_tasks=num_tasks)
    _compare(lambda hs, y, v: jax_losses.mtcut_loss(hs, y, valid=v, **kw),
             lambda hs, y, v: losses.mtcut_loss(hs, y, valid=v, **kw),
             heads, labels, valid)


def test_div_loss_matches_jax():
    """mtcut_loss's divergence: JS to the augmented target (tau 0.85). The
    other divergences: tests/test_torch_zoo_losses.py."""
    heads, labels = _heads(2)
    _compare(lambda hs, y, v: jax_losses.div_loss(hs[-1], y, metric="dcg", div_type="js",
                                                  augmented=True, valid=v),
             lambda hs, y, v: losses.div_loss(hs[-1], y, metric="dcg", div_type="js",
                                              augmented=True, valid=v),
             heads[-1:], labels, VALID)


def test_kl_batchmean_matches_jax():
    rng = np.random.default_rng(3)
    log_input = np.log(rng.dirichlet(np.ones(L), size=B)).astype(np.float32)
    target = rng.dirichlet(np.ones(L), size=B).astype(np.float32)
    target[0, :3] = 0.0  # zero targets take the _TINY clamp
    w = VALID
    want = jax_losses._kl_batchmean(jnp.asarray(log_input), jnp.asarray(target),
                                    jnp.asarray(w), jnp.sum(jnp.asarray(w)))
    got = losses._kl_batchmean(torch.from_numpy(log_input), torch.from_numpy(target),
                               torch.from_numpy(w), torch.from_numpy(w).sum())
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_RTOL, atol=VALUE_ATOL)


@pytest.mark.parametrize("case", ["mixed", "no_positives", "no_negatives"])
def test_rerank_loss_matches_jax(case):
    heads, labels = _heads(4)
    if case == "no_positives":
        labels[:] = 0.0
    elif case == "no_negatives":
        labels[:] = 1.0
    value = _compare(lambda hs, y, v: jax_losses.rerank_loss(hs[0], y, valid=v),
                     lambda hs, y, v: losses.rerank_loss(hs[0], y, valid=v),
                     heads[1:2], labels, VALID)
    if case != "mixed":
        assert value == 0.0


def test_rerank_loss_hinge_is_active():
    """A batch whose irrelevant docs score above its relevant ones: the
    hinge is positive and its gradient reaches both groups."""
    heads, labels = _heads(5)
    rerank = np.where(labels[..., None] == 1.0, 0.01, 0.09).astype(np.float32)
    value = _compare(lambda hs, y, v: jax_losses.rerank_loss(hs[0], y, valid=v),
                     lambda hs, y, v: losses.rerank_loss(hs[0], y, valid=v),
                     [rerank], labels, VALID)
    assert value > 0.0


@pytest.mark.parametrize("saturated", [False, True])
def test_bce_loss_matches_jax(saturated):
    """With saturated elements (p exactly 0 on a relevant doc, 1 on an
    irrelevant one) the log terms clamp at -100 and those elements take a
    zero gradient on both sides."""
    heads, labels = _heads(6)
    p = heads[0]
    if saturated:
        p[0, 0, 0], labels[0, 0] = 0.0, 1.0
        p[1, 2, 0], labels[1, 2] = 1.0, 0.0
    value = _compare(lambda hs, y, v: jax_losses.bce_loss(hs[0], y, valid=v),
                     lambda hs, y, v: losses.bce_loss(hs[0], y, valid=v),
                     [p], labels, VALID)
    assert np.isfinite(value)
    if saturated:
        t = torch.from_numpy(p).requires_grad_()
        losses.bce_loss(t, torch.from_numpy(labels), valid=torch.from_numpy(VALID)).backward()
        assert t.grad[0, 0, 0] == 0.0 and t.grad[1, 2, 0] == 0.0
        assert value > 100.0 / (4 * L)  # the clamped -100 terms count


@pytest.mark.parametrize("metric", ["f1", "dcg"])
def test_reward_matrix_matches_jax(metric):
    _, labels = _heads(7)
    labels[2] = 0.0  # a list with no relevant doc
    np.testing.assert_allclose(
        metrics.reward_matrix(torch.from_numpy(labels), metric).numpy(),
        np.asarray(jax_metrics.reward_matrix(jnp.asarray(labels), metric)),
        rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown reward metric"):
        metrics.reward_matrix(torch.from_numpy(labels), "ndcg")
