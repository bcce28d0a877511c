"""Population training of the seven other models of the port, in float32,
against the JAX package and against the port's own sequential Trainer.

The JAX package trains K members of any of its eight models as one
`jax.vmap`ped program; the port writes the member axis out on every leaf
(`models.build_population_model`). For BiCut, Choopy, AttnCut, MtChoopy,
MtAttnCut, MOECut and PLECut (MMOECut's cases are
tests/test_torch_population.py's), on the CPU, where the kernels' plain
versions run:

- the member-batched model on two JAX members' weights
  (`population_params_from_jax` of `jax.vmap`ped inits) against
  `jax.jit(jax.vmap(jax.value_and_grad(loss)))` of the JAX model on its
  plain path at dropout 0 (the port's dropout bits are torch's): the
  training-mode heads, each member's loss and every gradient leaf;
- `train_population` with dropout on against one sequential port Trainer a
  member at the member's seed, learning rate and weight decay: member m
  draws its sequential run's bits, so the two agree to float32 reduction
  order (the port's own contract, ROADMAP.md C4);
- MtChoopy members that search their task weights (`--mt-search`), each
  against its Trainer at its own weights;
- the unstacked and per-slice attentions with members: member m's dropout
  streams are its own model's;
- the refusal of a member's dropout rate outside [0, 1) (members of
  different rates train: tests/test_torch_member_dropout.py).

Inputs are made with numpy from fixed seeds and handed to both packages.
tests/test_torch_population_zoo_bf16.py holds the bf16 populations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu import config as jax_config
from rlt_tpu import train as jax_train
from rlt_tpu.models import build_model as jax_build_model
from rlt_tpu_torch import train
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.models import build_model, build_population_model, layers
from rlt_tpu_torch.population import Member, member_config, train_population
from rlt_tpu_torch.utils.convert import population_params_from_jax
from rlt_tpu_torch.utils.losses import member_losses
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

FAMILIES = ("bicut", "choopy", "attncut", "mtchoopy", "mtattncut", "moecut", "mtple")
SEQ_LEN = 16
SEEDS = (3, 8)
# tests/test_torch_population.py's tolerances, and why: heads and step-1
# gradients against JAX on copied weights (tests/test_torch_zoo.py's
# HEAD_ATOL, GRAD_REL and GRAD_FLOOR); a member against its sequential
# Trainer, the same bits with the products batched over the members.
HEAD_ATOL = 1e-5
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-7
# Each member's loss within 1e-5 relative, as tests/test_torch_population.py
# holds MMOECut's, or LOSS_FLOOR: a DCG reward takes -1 / log2(j + 2) for an
# irrelevant document, so a loss can be a sum of terms of O(0.1) that
# cancel to O(1e-3), whose sum order moves it by an ulp of the terms.
LOSS_RTOL = 1e-5
LOSS_FLOOR = 1e-7
SUMMARY_ATOL = 1e-6
STEP_LOSS_RTOL = 1e-5


def input_size(name: str) -> int:
    return 1 if name in ("choopy", "mtchoopy") else 3


def heads(output) -> list:
    return list(output) if isinstance(output, (list, tuple)) else [output]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=FAMILIES)
def jax_family(request):
    """One family's JAX model at L = 16 on its plain path, dropout 0, the
    two members' inits stacked by a jitted `jax.vmap`."""
    name = request.param
    model = jax_build_model(name, seq_len=SEQ_LEN, input_size=input_size(name),
                            dropout=0.0, use_pallas=False)
    sample = jnp.zeros((1, SEQ_LEN, input_size(name)), jnp.float32)

    def init(seed):
        key = jax.random.PRNGKey(seed)
        return model.init({"params": key, "dropout": key}, sample)["params"]

    return name, model, jax.jit(jax.vmap(init))(jnp.asarray(SEEDS, jnp.uint32))


def test_member_batched_model_matches_jax_vmap(jax_family):
    """The family's model with two members, on the JAX members' weights:
    training-mode heads, each member's loss of `make_criterion` and every
    step-1 gradient leaf, member by member, against
    `jax.jit(jax.vmap(jax.value_and_grad(loss)))`."""
    name, model, params = jax_family
    rng = np.random.default_rng(90)
    x = rng.normal(size=(2, 3, SEQ_LEN, input_size(name))).astype(np.float32)
    y = (rng.random((2, 3, SEQ_LEN)) < 0.3).astype(np.float32)
    y[..., 0] = 1.0
    valid = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    crit = jax_train.make_criterion(jax_config.TrainConfig(model_name=name))

    def loss(p, xb, yb, vb):
        out = model.apply({"params": p}, xb, deterministic=False)
        return crit(out, yb, valid=vb), out

    (want_loss, want_out), want_grads = jax.jit(jax.vmap(jax.value_and_grad(
        loss, has_aux=True)))(params, *map(jnp.asarray, (x, y, valid)))
    port = build_population_model(name, seq_len=SEQ_LEN, input_size=input_size(name),
                                  dropout=0.0, seeds=[0, 0]).train()
    port.load_state_dict(population_params_from_jax(_np_tree(params)))
    out = port(torch.from_numpy(x), [torch.Generator(), torch.Generator()])
    assert len(heads(out)) == len(heads(want_out))
    for got, want in zip(heads(out), heads(want_out)):
        assert got.shape == want.shape and got.shape[:2] == (2, 3)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=HEAD_ATOL)
    losses = member_losses(train.make_criterion(TrainConfig(model_name=name)), out,
                           torch.from_numpy(y), torch.from_numpy(valid))
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want_loss),
                               rtol=LOSS_RTOL, atol=LOSS_FLOOR)
    losses.sum().backward()
    want = population_params_from_jax(_np_tree(want_grads))
    assert set(want) == {k for k, _ in port.named_parameters()}
    for key, p in port.named_parameters():
        for m in range(2):
            g, w = p.grad[m].numpy(), want[key][m].numpy()
            assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + GRAD_FLOOR, (key, m)


def tiny_cfg(name: str, **kw) -> TrainConfig:
    base = dict(model_name=name, retrieve_data="robust04", seq_len_override=12,
                synthetic_queries=20, batch_size=4, epochs=1, dropout=0.2, lr=1e-3,
                weight_decay=0.0)
    base.update(kw)
    return TrainConfig(**base)


MEMBERS_2 = [Member(seed=0, lr=1e-3, weight_decay=0.0),
             Member(seed=1, lr=3e-4, weight_decay=0.01)]


def assert_members_match_trainers(cfg, members, out):
    """Each member's summary and step losses against a sequential port
    Trainer at the member's config (its own corpus, weights and generator)."""
    for row, member in zip(out["per_member"], members):
        trainer = train.Trainer(member_config(cfg, member), device="cpu")
        seq = trainer.run()
        for key in ("best_f1", "best_dcg", "best5_f1", "best5_dcg"):
            assert abs(row[key] - seq[key]) <= SUMMARY_ATOL, (member, key)
        assert row["compute_dtype"] == seq["compute_dtype"] == cfg.compute_dtype
        for pop_epoch, seq_epoch in zip(row["history"], trainer.history, strict=True):
            np.testing.assert_allclose(pop_epoch["train_loss_steps"],
                                       seq_epoch["train_loss_steps"], rtol=STEP_LOSS_RTOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_population_matches_sequential_trainers(name):
    """Two members of distinct seed, lr and weight decay, dropout 0.2 on,
    one epoch, against their sequential Trainers."""
    cfg = tiny_cfg(name)
    out = train_population(cfg, MEMBERS_2, device="cpu")
    assert out["f1_record"].shape == (2, cfg.epochs)
    assert_members_match_trainers(cfg, MEMBERS_2, out)


def test_mt_search_members_take_their_task_weights():
    """MtChoopy members at distinct rerank and class weights (an
    `--mt-search` population): each member's criterion is its own, held to
    its Trainer at its weights; the two members' step losses differ."""
    cfg = tiny_cfg("mtchoopy")
    members = [Member(seed=2, rerank_weight=0.01, class_weight=5.0),
               Member(seed=2, rerank_weight=7.5, class_weight=0.02)]
    out = train_population(cfg, members, device="cpu")
    assert_members_match_trainers(cfg, members, out)
    steps = [row["history"][0]["train_loss_steps"] for row in out["per_member"]]
    assert not np.allclose(steps[0], steps[1])


@pytest.mark.parametrize("name,op", [("attncut", "fused_attention_packed"),
                                     ("choopy", "fused_attention_packed"),
                                     ("mtple", "fused_attention")])
def test_member_dropout_streams_are_each_members_own(monkeypatch, name, op):
    """The attention with members draws each member's seeds from its own
    generator, as many as its own model draws: one for the unstacked
    encoders (AttnCut's at dh 64, Choopy's three layers at dh 16), one an
    expert for PLECut's per-slice attention. Every launch's streams are the
    members' sequential streams one after another, and the training-mode
    heads with dropout on are the sequential models' heads."""
    streams = []
    real = getattr(layers, op)

    def spy(*args, **kw):
        streams.append(kw["streams"].clone())
        return real(*args, **kw)

    monkeypatch.setattr(layers, op, spy)
    x = np.random.default_rng(91).normal(
        size=(2, 3, SEQ_LEN, input_size(name))).astype(np.float32)
    pop = build_population_model(name, seq_len=SEQ_LEN, input_size=input_size(name),
                                 dropout=0.3, seeds=SEEDS).train()
    out = pop(torch.from_numpy(x), [torch.Generator().manual_seed(40 + m) for m in (0, 1)])
    member_streams, streams[:] = list(streams), []
    seq_out = []
    for m, seed in enumerate(SEEDS):
        model = build_model(name, seq_len=SEQ_LEN, input_size=input_size(name),
                            dropout=0.3, seed=seed).train()
        seq_out.append(model(torch.from_numpy(x[m]), torch.Generator().manual_seed(40 + m)))
    layers_n = len(member_streams)
    assert layers_n == (3 if name == "choopy" else 1) and len(streams) == 2 * layers_n
    for i, got in enumerate(member_streams):
        assert torch.equal(got, torch.cat([streams[i], streams[layers_n + i]]))
    for m in range(2):
        for got, want in zip(heads(out), heads(seq_out[m])):
            np.testing.assert_allclose(got[m].detach().numpy(), want.detach().numpy(),
                                       rtol=0, atol=HEAD_ATOL)


def test_population_refuses_a_dropout_rate_per_member():
    """A member's own dropout rate trains (tests/test_torch_member_dropout.py)
    unless it lies outside [0, 1)."""
    cfg = tiny_cfg("attncut")
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            train_population(cfg, [Member(seed=0, dropout=rate), Member(seed=1)],
                             device="cpu")
