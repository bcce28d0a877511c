"""Each of the port's parallel layouts against the JAX package's sharded
step of the same layout.

The JAX package runs its layouts as one GSPMD program over a mesh of 4 of
the 8 virtual CPU devices (tests/conftest.py): dp over (4,), dp x tp over
(2, 2) at E = 3 and dp x ep over (2, 2) at E = 4, parameters laid out by
`rlt_tpu.parallel.param_shardings`. The port runs the same layouts as four
gloo processes (`tests/parallel_workers.py::jax_layouts`), from the JAX
package's initial weights (flax params carry torch's names and layouts),
on the same eight lists, at rate 0. One step each: the loss within 1e-5
relative; each parameter's gradient within 1e-3 of its max abs plus 1e-7
(tests/test_torch_train.py's rule for the mtcut gradient against
jax.value_and_grad: the gates contract 2 * 128 * L BiLSTM outputs, and the
LayerNorm variance formulas differ in the last bits); each parameter after
the Adam step within lr / 10 of JAX's, but the leaves whose gradient is
zero by algebra, which Adam moves by about lr on rounding noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import parallel_workers as W
from rlt_tpu import config as jax_config
from rlt_tpu import train as jax_train
from rlt_tpu.models.mmoe import MMOECut as JaxMMOECut
from rlt_tpu.parallel import data_parallel_mesh, mesh_2d, param_shardings
from rlt_tpu_torch.models import ZERO_GRAD_LEAVES
from rlt_tpu_torch.parallel import launch
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-7


def _jax_step(model_parallel: int, num_experts: int, params, x, y):
    """The JAX package's sharded train step (as __graft_entry__.py's
    build_dryrun_step builds it, at rate 0 on given weights): loss, grads
    and the params after one update, on the host."""
    devices = jax.devices("cpu")[:4]
    mesh = (mesh_2d(4, model_parallel, devices=devices) if model_parallel > 1
            else data_parallel_mesh(4, devices=devices))
    model = JaxMMOECut(seq_len=W.SEQ_LEN, input_size=W.FEATURES, dropout=0.0,
                       num_experts=num_experts, use_pallas=False)
    cfg = jax_config.TrainConfig(model_name="mmoecut")
    criterion = jax_train.make_criterion(cfg)
    optimizer = jax_train.make_optimizer(cfg.lr, cfg.weight_decay)
    params = jax.tree.map(jax.device_put, params, param_shardings(params, mesh))
    batch = NamedSharding(mesh, P("data"))
    x, y = jax.device_put(x, batch), jax.device_put(y, batch)
    valid = jax.device_put(jnp.ones(x.shape[0]), batch)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            out = model.apply({"params": p}, x, deterministic=False)
            return criterion(out, y, valid=valid)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = optimizer.update(grads, opt_state, params)
        return loss, grads, optax.apply_updates(params, updates)

    with mesh:
        loss, grads, new = step(params, optimizer.init(params))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return float(loss), to_np(grads), to_np(new)


@pytest.fixture(scope="module")
def layouts():
    """The JAX package's initial weights at E = 3 and 4, the port's four
    ranks' steps from them, and the JAX package's sharded steps."""
    data = W.dataset()
    x = np.asarray(data.x_train[:W.JAX_BATCH], np.float32)
    y = np.asarray(data.y_train[:W.JAX_BATCH], np.float32)
    inits = {}
    for e in (3, 4):
        model = JaxMMOECut(seq_len=W.SEQ_LEN, input_size=W.FEATURES, dropout=0.0,
                           num_experts=e, use_pallas=False)
        key = jax.random.PRNGKey(e)
        inits[e] = model.init({"params": key, "dropout": key},
                              jnp.zeros((1, W.SEQ_LEN, W.FEATURES)))["params"]
    state_dicts = {e: params_from_jax(jax.tree.map(np.asarray, p)) for e, p in inits.items()}
    port = launch(W.jax_layouts, 4, state_dicts, env={"OMP_NUM_THREADS": "1"})[0]
    want = {name: _jax_step(m, e, inits[e], x, y) for name, (m, e) in W.JAX_LAYOUTS.items()}
    return port, want


@pytest.mark.parametrize("layout", list(W.JAX_LAYOUTS))
def test_layout_loss_matches_the_jax_sharded_step(layout, layouts):
    port, want = layouts
    np.testing.assert_allclose(port[layout]["steps"][0, 0], want[layout][0], rtol=LOSS_RTOL)


@pytest.mark.parametrize("layout", list(W.JAX_LAYOUTS))
def test_layout_gradients_match_the_jax_sharded_step(layout, layouts):
    port, want = layouts
    grads = params_from_jax(want[layout][1])
    assert set(grads) == set(port[layout]["grads"])
    for name, w in grads.items():
        g, w = port[layout]["grads"][name].numpy(), w.numpy()
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + GRAD_FLOOR, name


@pytest.mark.parametrize("layout", list(W.JAX_LAYOUTS))
def test_layout_update_matches_the_jax_sharded_step(layout, layouts):
    port, want = layouts
    new = params_from_jax(want[layout][2])
    lr = jax_config.TrainConfig().lr
    for name, w in new.items():
        if name in ZERO_GRAD_LEAVES["mmoecut"]:
            continue
        got = port[layout]["final"][name].numpy()
        key_bias = name.endswith("self_attn.in_proj_bias")
        if key_bias:  # its key block: zero by algebra
            d = got.shape[-1] // 3
            got, w = (np.concatenate([a[..., :d], a[..., 2 * d:]], -1) for a in (got, w.numpy()))
        np.testing.assert_allclose(got, np.asarray(w), rtol=0, atol=lr / 10, err_msg=name)
