"""The port's probing modules (ProbeBase, Probe, TaskC, TaskR) and the
verify_probe steps against the JAX package's, on the CPU.

Weights go across with `params_from_jax`. Whole-model comparisons run at
dropout 0 (the port's dropout bits are torch's); the JAX side runs its
plain path (`use_pallas=False`), as `pallas_supported()` is false on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlt_tpu import config as jax_config
from rlt_tpu import verify_probe as jax_verify_probe
from rlt_tpu.data import batching as jax_batching
from rlt_tpu.models import Probe as JaxProbe
from rlt_tpu.models import ProbeBase as JaxProbeBase
from rlt_tpu.models import TaskC as JaxTaskC
from rlt_tpu.models import TaskR as JaxTaskR
from rlt_tpu.utils import losses as jax_losses
from rlt_tpu_torch import verify_probe
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.data import synthetic_dataset
from rlt_tpu_torch.models import (
    POPULATION_MODELS,
    Probe,
    ProbeBase,
    TaskC,
    TaskR,
    build_model,
    check_population_model,
)
from rlt_tpu_torch.train import make_optimizer
from rlt_tpu_torch.utils import losses
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401

L, F = 16, 3
# The heads and intermediates at dropout 0, as test_torch_train.py's
# HEAD_ATOL: f32 sums in another order, flax LayerNorm's E[x^2] - E[x]^2
# variance; every output is O(1).
HEAD_ATOL = 1e-5
# A phase-1 step's gradients, relative to each parameter's gradient max abs,
# with the absolute floor for the softmax towers' biases (zero gradient by
# algebra): test_torch_train.py's GRAD_REL and GRAD_FLOOR.
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-7
# Phase 2's step metrics over an epoch replayed on the JAX plan: the step-1
# forward is the same up to HEAD_ATOL, later steps carry Adam's updates of
# the same gradients; the AUC counts pairs of scores and the rerank DCG
# sorts them, and no two scores of a list lie within the forwards' gap on
# this data, so both agree to their f32 sums.
PROBE_METRIC_ATOL = 1e-5


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_probe_base():
    model = JaxProbeBase(seq_len=L, input_size=F, dropout=0.0, num_experts=2,
                         use_pallas=False)
    key = jax.random.PRNGKey(3)
    # jitted: eager flax runs the BiLSTM's scan op by op
    params = jax.jit(model.init)({"params": key, "dropout": key},
                                 jnp.zeros((1, L, F)))["params"]
    return model, params


def _inputs(seed: int, batch: int = 4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, L, F)).astype(np.float32)
    y = (rng.random((batch, L)) < 0.3).astype(np.float32)
    y[:, 0] = 1.0
    y[:, -1] = 0.0
    return x, y


def test_probe_base_is_built_and_keeps_jax_names(jax_probe_base):
    _, params = jax_probe_base
    port = build_model("probe_base", seq_len=L, input_size=F, dropout=0.1)
    assert isinstance(port, ProbeBase)
    want = params_from_jax(_np_tree(params))
    got = port.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].shape == value.shape, name
    assert tuple(port.w_gates.shape) == (3, 2 * 128 * L, 2)
    # the gates are N(0, 1), as the JAX module's randn_init
    assert abs(port.w_gates.std().item() - 1.0) < 0.05


def test_probe_base_outputs_match_jax(jax_probe_base):
    model, params = jax_probe_base
    x, _ = _inputs(4)
    ei, eo, heads = jax.jit(model.apply, static_argnums=2)({"params": params},
                                                          jnp.asarray(x), True)
    port = build_model("probe_base", seq_len=L, input_size=F, dropout=0.0)
    port.load_state_dict(params_from_jax(_np_tree(params)))
    with torch.no_grad():
        got_ei, got_eo, got_heads = port.eval()(torch.from_numpy(x))
    assert tuple(got_eo.shape) == (2, 4, L, 256)
    for g, w in [(got_ei, ei), (got_eo, eo)] + list(zip(got_heads, heads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=HEAD_ATOL)


def test_probe_base_step_gradients_match_jax(jax_probe_base):
    """Phase 1's loss, mtcut_loss at 0.5/0.5 on the heads, and its gradient
    for every parameter, training mode at dropout 0."""
    model, params = jax_probe_base
    x, y = _inputs(5)
    valid = np.array([1, 1, 1, 0], np.float32)
    kw = dict(metric="f1", rerank_weight=0.5, classi_weight=0.5, num_tasks=3)

    def jax_loss(p):
        out = model.apply({"params": p}, jnp.asarray(x), deterministic=False)
        return jax_losses.mtcut_loss(out[-1], jnp.asarray(y), valid=jnp.asarray(valid),
                                     **kw), out

    (want_loss, want_out), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)
    port = build_model("probe_base", seq_len=L, input_size=F, dropout=0.0)
    port.load_state_dict(params_from_jax(_np_tree(params)))
    _, _, heads = port.train()(torch.from_numpy(x))
    for g, w in zip(heads, want_out[-1]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=HEAD_ATOL)
    loss = losses.mtcut_loss(heads, torch.from_numpy(y), valid=torch.from_numpy(valid), **kw)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    want = params_from_jax(_np_tree(want_grads))
    for name, p in port.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + GRAD_FLOOR, name


def test_probe_towers_and_task_heads_match_jax(jax_probe_base):
    model, params = jax_probe_base
    x, _ = _inputs(6)
    ei, eo, _ = jax.jit(model.apply, static_argnums=2)({"params": params}, jnp.asarray(x),
                                                       True)
    ei, eo = np.array(ei), np.array(eo)
    jax_probe = JaxProbe()
    probe_params = jax_probe.init(jax.random.PRNGKey(7), ei, eo)["params"]
    want = jax_probe.apply({"params": probe_params}, ei, eo)
    port = Probe()
    port.load_state_dict(params_from_jax(_np_tree(probe_params)))
    with torch.no_grad():
        got = port(torch.from_numpy(ei), torch.from_numpy(eo))
    assert len(got) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == (4, L, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=HEAD_ATOL)
    feats = np.random.default_rng(8).normal(size=(4, L, 256)).astype(np.float32)
    for jax_head, head in ((JaxTaskC(), TaskC(256)), (JaxTaskR(), TaskR(256))):
        p = jax_head.init(jax.random.PRNGKey(9), jnp.asarray(feats))["params"]
        head.load_state_dict(params_from_jax(_np_tree(p)))
        with torch.no_grad():
            got = head(torch.from_numpy(feats))
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_head.apply({"params": p},
                                                                          feats)),
                                   rtol=0, atol=HEAD_ATOL)


@pytest.fixture(scope="module")
def replayed_probe_epoch(tmp_path_factory):
    """JAX's phase-2 epoch and the port's on the same plan, base and probe
    weights (the JAX ProbeTrainer's init, carried across). The JAX trainer
    always opens its metrics log: it goes to a directory of this test's."""
    cfg_kw = dict(model_name="probe_base", seq_len_override=L, input_size_override=F,
                  synthetic_queries=20, batch_size=4, dropout=0.0, lr=1e-3,
                  weight_decay=0.005, log_dir=None)
    data = synthetic_dataset(num_queries=20, seq_len=L, num_features=F, mean_relevant=4.0,
                             seed=1)
    jcfg = jax_config.TrainConfig(**{**cfg_kw, "use_pallas": False,
                                     "log_dir": str(tmp_path_factory.mktemp("jax_runs"))})
    jt = jax_verify_probe.ProbeTrainer(jcfg, epochs_base=0, epochs_probe=1, data=data)
    key = jax.random.PRNGKey(11)
    plan = jax_batching.epoch_permutation(key, jt.data.n_train, 4)
    _, want = jt._probe_epoch(jt.probe_state, jt.base_state.params, key)
    pt = verify_probe.ProbeTrainer(TrainConfig(**cfg_kw), epochs_base=0, epochs_probe=1,
                                   data=data, device="cpu")
    pt.base.load_state_dict(params_from_jax(_np_tree(jt.base_state.params)))
    pt.probe.load_state_dict(params_from_jax(_np_tree(jt.probe_state.params)))
    got = pt.probe_epoch(tuple(np.asarray(a) for a in plan))
    return np.asarray(want), got


def test_replayed_probe_epoch_matches_jax(replayed_probe_epoch):
    want, got = replayed_probe_epoch
    assert verify_probe.PROBE_TAGS == jax_verify_probe.PROBE_TAGS  # the metrics' order
    assert got.shape == want.shape == (4, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBE_METRIC_ATOL)
    aucs = got[:, 0::2]
    assert np.all((aucs >= 0) & (aucs <= 1))


def test_one_adam_over_the_towers_equals_six_adams():
    """Adam with coupled L2 over the six disjoint towers at once updates each
    tower bit for bit as an Adam of its own, over three steps."""
    one, six = Probe(seed=2), Probe(seed=2)
    joint = make_optimizer(one.parameters(), 1e-3, 0.005)
    apart = [make_optimizer(tower.parameters(), 1e-3, 0.005) for tower in six.children()]
    assert len(apart) == 6
    rng = np.random.default_rng(12)
    for _ in range(3):
        for p, q in zip(one.parameters(), six.parameters()):
            g = torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32))
            p.grad, q.grad = g.clone(), g.clone()
        joint.step()
        for opt in apart:
            opt.step()
    for (name, p), q in zip(one.named_parameters(), six.parameters()):
        assert torch.equal(p, q), name
    # and the same holds for optax's chain, the JAX harness's one optimizer
    params = {f"t{i}": jnp.asarray(rng.normal(size=(3,)).astype(np.float32))
              for i in range(6)}
    opt = optax.chain(optax.add_decayed_weights(0.005), optax.scale_by_adam(),
                      optax.scale(-1e-3))
    grads = {k: jnp.asarray(rng.normal(size=(3,)).astype(np.float32)) for k in params}
    updates, _ = opt.update(grads, opt.init(params), params)
    for k in params:
        alone, _ = opt.update(grads[k], opt.init(params[k]), params[k])
        assert np.array_equal(np.asarray(updates[k]), np.asarray(alone)), k


def test_probe_base_trains_through_verify_probe_only():
    assert "probe_base" not in POPULATION_MODELS
    with pytest.raises(ValueError, match="verify_probe"):
        check_population_model("probe_base")
    with pytest.raises(ValueError, match="verify_probe"):
        build_model("probe_base", seq_len=L, input_size=F, dropout=0.1, members=2)
