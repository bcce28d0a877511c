"""Population training of the port against the JAX package, and against the
port's own sequential Trainer.

The JAX package trains K members as one `jax.vmap`ped program, under which
its Pallas LSTM kernels run batched over the members. The port writes the
member axis out: K members' BiLSTM layers are one LSTM op at ndir = 2K
(`ops.lstm.fused_lstm_bidir` over a member axis), and `MMOECut(members=K)`
carries K in front of every leaf. Here, on the CPU, where the kernels' plain
versions run:

- the plain K1'/K2' at ndir = 2K (K = 3) against `jax.vmap` of the JAX
  kernels in interpret mode, and the member-axis `fused_lstm_bidir` with its
  gradients against `jax.vmap` of the JAX function;
- the member-batched MMOECut on K = 2 JAX inits (`population_params_from_jax`)
  against `jax.vmap(jax.value_and_grad(loss))` of the JAX model at dropout 0
  (the port's dropout bits are torch's): heads and step-1 gradients;
- the port's population of 3 members with dropout on against 3 sequential
  port Trainers: member m draws its sequential run's bits, so the two agree
  to float32 reduction order (the port's own contract, ROADMAP.md C4);
- the search trials and record lines against the JAX package's, chunking,
  the refusals, and the train CLI's population search.

Inputs are made with numpy from fixed seeds and handed to both packages.
tests/test_torch_card.py holds the kernels at ndir = 2K to their plain
versions on a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu import config as jax_config
from rlt_tpu import train as jax_train
from rlt_tpu.models import build_model as jax_build_model
from rlt_tpu.ops import lstm as jax_lstm
from rlt_tpu_torch import train
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.models import ZERO_GRAD_LEAVES, build_population_model
from rlt_tpu_torch.ops import lstm
from rlt_tpu_torch.population import Member, train_population
from rlt_tpu_torch.utils.convert import population_params_from_jax, stack_state_dicts
from rlt_tpu_torch.utils.losses import member_losses
from torch_threads import one_torch_thread, torch_threads  # noqa: F401

HIDDEN = 128
MEMBERS = 3
# The recurrence in float32 over L = 8 steps: each step's (B, H) x (H, 4H)
# products summed in another order by the two frameworks, a few ulps a
# step; outputs O(1). The gradients relative to each one's max abs.
LSTM_ATOL = 1e-5
LSTM_BWD_REL = 1e-5
# Whole-model heads and step-1 gradients against JAX on copied weights:
# tests/test_torch_zoo.py's HEAD_ATOL, GRAD_REL and GRAD_FLOOR, and why.
HEAD_ATOL = 1e-5
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-7
# A population member against its sequential Trainer: the same bits, the
# products batched over members (another float32 summation order).
SUMMARY_ATOL = 1e-6
STEP_LOSS_RTOL = 1e-5
UPDATE_REL = 1e-2
SEQ_LEN = 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _member_lstm_inputs(seed, length, batch):
    """Per member m: xw (L, 2B, 4H) and W_hh^T (2H, 4H) of its two
    directions, and dho (L, 2B, H), stacked on a leading member axis."""
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(MEMBERS, length, 2 * batch, 4 * HIDDEN)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(MEMBERS, 2 * HIDDEN, 4 * HIDDEN))
         / np.sqrt(HIDDEN)).astype(np.float32)
    dho = rng.normal(size=(MEMBERS, length, 2 * batch, HIDDEN)).astype(np.float32)
    return xw, w, dho


def _to_port_layout(a):
    """(K, L, 2B, .) per member -> (L, 2K B, .), direction 2m + s."""
    k, length, rows, width = a.shape
    return torch.from_numpy(np.ascontiguousarray(a.transpose(1, 0, 2, 3))
                            .reshape(length, k * rows, width))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_member_batched_lstm_kernels_match_jax_vmap():
    """The plain K1' and K2' at ndir = 2K against `jax.vmap` of
    `_fwd_pallas(True, 2, ...)` and `_bwd_pallas(True, 2, ...)` over K
    members: hs and cs within LSTM_ATOL, dxw and dW_hh^T within
    LSTM_BWD_REL of their max abs."""
    length, batch = 8, 3
    xw, w, dho = _member_lstm_inputs(70, length, batch)
    hs_j, cs_j = jax.vmap(lambda a, b: jax_lstm._fwd_pallas(True, 2, a, b))(
        jnp.asarray(xw), jnp.asarray(w))
    dxw_j, dw_j = jax.vmap(lambda *a: jax_lstm._bwd_pallas(True, 2, *a))(
        jnp.asarray(xw), jnp.asarray(w), hs_j, cs_j, jnp.asarray(dho))
    xw_p, w_p = _to_port_layout(xw), torch.from_numpy(w.reshape(-1, 4 * HIDDEN))
    ndir = 2 * MEMBERS
    hs, cs = lstm.lstm_fwd(xw_p, w_p, ndir)
    for got, want in ((hs, hs_j), (cs, cs_j)):
        np.testing.assert_allclose(got.numpy(), _to_port_layout(np.asarray(want)).numpy(),
                                   rtol=0, atol=LSTM_ATOL)
    dxw, dw = lstm.lstm_bwd(xw_p, w_p, _to_port_layout(np.asarray(hs_j)),
                            _to_port_layout(np.asarray(cs_j)), _to_port_layout(dho), ndir)
    assert dw.shape == (ndir * HIDDEN, 4 * HIDDEN)
    assert _rel_err(dxw, _to_port_layout(np.asarray(dxw_j))) <= LSTM_BWD_REL
    assert _rel_err(dw, np.asarray(dw_j).reshape(-1, 4 * HIDDEN)) <= LSTM_BWD_REL


def test_member_fused_lstm_bidir_matches_jax_vmap():
    """`fused_lstm_bidir` over a member axis ((K, L, B, 4H) inputs, (K, H,
    4H) weights, one op at ndir = 2K) against `jax.vmap` of the JAX
    function in interpret mode, outputs and gradients through `jax.vjp`."""
    rng = np.random.default_rng(71)
    length, batch = 8, 3
    xw_f, xw_r = (rng.normal(size=(MEMBERS, length, batch, 4 * HIDDEN))
                  .astype(np.float32) for _ in range(2))
    w_f, w_r = ((rng.uniform(-1, 1, size=(MEMBERS, HIDDEN, 4 * HIDDEN)) / np.sqrt(HIDDEN))
                .astype(np.float32) for _ in range(2))
    probe_f, probe_r = (rng.normal(size=(MEMBERS, length, batch, HIDDEN))
                        .astype(np.float32) for _ in range(2))
    fn = jax.vmap(lambda *a: jax_lstm.fused_lstm_bidir(*a, interpret=True))
    want_hs, vjp = jax.vjp(fn, *map(jnp.asarray, (xw_f, xw_r, w_f, w_r)))
    want_grads = vjp(tuple(map(jnp.asarray, (probe_f, probe_r))))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xw_f, xw_r, w_f, w_r)]
    hs_f, hs_r = lstm.fused_lstm_bidir(*leaves)
    ((hs_f * torch.from_numpy(probe_f)).sum()
     + (hs_r * torch.from_numpy(probe_r)).sum()).backward()
    for got, want in zip((hs_f, hs_r), want_hs):
        assert got.shape == (MEMBERS, length, batch, HIDDEN)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=LSTM_ATOL)
    for leaf, want in zip(leaves, want_grads):
        assert _rel_err(leaf.grad, want) <= LSTM_BWD_REL


@pytest.fixture(scope="module")
def jax_mmoecut():
    """The JAX MMOECut at L = 16 on its plain path, dropout 0, with two
    members' inits stacked by `jax.vmap` (seeds 3 and 8)."""
    model = jax_build_model("mmoecut", seq_len=SEQ_LEN, input_size=3, dropout=0.0,
                            use_pallas=False)
    sample = jnp.zeros((1, SEQ_LEN, 3), jnp.float32)

    def init(seed):
        key = jax.random.PRNGKey(seed)
        return model.init({"params": key, "dropout": key}, sample)["params"]

    return model, jax.jit(jax.vmap(init))(jnp.asarray([3, 8], jnp.uint32))


def test_member_batched_mmoecut_matches_jax_vmap(jax_mmoecut):
    """MMOECut with two members, on the JAX members' weights: training-mode
    heads, each member's loss of `make_criterion` and every step-1 gradient
    leaf, member by member, against `jax.vmap(jax.value_and_grad(loss))`."""
    model, params = jax_mmoecut
    rng = np.random.default_rng(72)
    x = rng.normal(size=(2, 3, SEQ_LEN, 3)).astype(np.float32)
    y = (rng.random((2, 3, SEQ_LEN)) < 0.3).astype(np.float32)
    y[..., 0] = 1.0
    valid = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    crit = jax_train.make_criterion(jax_config.TrainConfig(model_name="mmoecut"))

    def loss(p, xb, yb, vb):
        out = model.apply({"params": p}, xb, deterministic=False)
        return crit(out, yb, valid=vb), out

    (want_loss, want_out), want_grads = jax.jit(jax.vmap(jax.value_and_grad(
        loss, has_aux=True)))(params, *map(jnp.asarray, (x, y, valid)))
    port = build_population_model("mmoecut", seq_len=SEQ_LEN, input_size=3, dropout=0.0,
                                  seeds=[0, 0]).train()
    port.load_state_dict(population_params_from_jax(_np_tree(params)))
    out = port(torch.from_numpy(x), [torch.Generator(), torch.Generator()])
    assert len(out) == 3 and out[0].shape == (2, 3, SEQ_LEN, 1)
    for got, want in zip(out, want_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=HEAD_ATOL)
    losses = member_losses(train.make_criterion(TrainConfig(model_name="mmoecut")), out,
                           torch.from_numpy(y), torch.from_numpy(valid))
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want_loss), rtol=1e-5)
    losses.sum().backward()
    want = population_params_from_jax(_np_tree(want_grads))
    for key, p in port.named_parameters():
        for m in range(2):
            g, w = p.grad[m].numpy(), want[key][m].numpy()
            assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + GRAD_FLOOR, (key, m)


def _tiny_cfg(**kw) -> TrainConfig:
    base = dict(model_name="mmoecut", retrieve_data="robust04", seq_len_override=12,
                synthetic_queries=20, batch_size=4, epochs=2, dropout=0.2, lr=1e-3,
                weight_decay=0.0)
    base.update(kw)
    return TrainConfig(**base)


MEMBERS_3 = [Member(seed=0, lr=1e-3, weight_decay=0.0),
             Member(seed=1, lr=3e-4, weight_decay=0.01),
             Member(seed=2, lr=2e-3, weight_decay=0.003)]


# The torch threads of `test_population_matches_sequential_trainers`: each
# thread count sums in its own order, whatever the cores, and Adam moves an
# element whose gradient is rounding noise by about lr either way, so the
# step losses' agreement depends on it. Worst step loss relative to the
# sequential Trainer's on an 8-core x86 box: 1.9e-4 at 1-3 threads, 7.5e-6
# at 4 and 6, 2.9e-6 at 8.
SEQUENTIAL_THREADS = 8


def test_population_matches_sequential_trainers():
    """Three members of distinct seed, lr and weight decay, dropout 0.2 on,
    two epochs: each member's summary and every step loss against a
    sequential port Trainer at the member's config (its own corpus, weights
    and generator), at SEQUENTIAL_THREADS torch threads."""
    with torch_threads(SEQUENTIAL_THREADS):
        cfg = _tiny_cfg()
        out = train_population(cfg, MEMBERS_3, device="cpu")
        assert out["f1_record"].shape == out["dcg_record"].shape == (3, cfg.epochs)
        for row, m in zip(out["per_member"], MEMBERS_3):
            assert row["member"] == dataclasses.asdict(m)
            trainer = train.Trainer(dataclasses.replace(
                cfg, seed=m.seed, lr=m.lr, weight_decay=m.weight_decay), device="cpu")
            seq = trainer.run()
            for key in ("best_f1", "best_dcg", "best5_f1", "best5_dcg"):
                assert abs(row[key] - seq[key]) <= SUMMARY_ATOL, key
            for pop_epoch, seq_epoch in zip(row["history"], trainer.history):
                np.testing.assert_allclose(pop_epoch["train_loss_steps"],
                                           seq_epoch["train_loss_steps"],
                                           rtol=STEP_LOSS_RTOL)


def test_train_population_chunked_equals_unchunked():
    """chunk_size runs the members as populations of at most that many, one
    after another: the same per-member records and best states."""
    cfg = _tiny_cfg(epochs=1)
    whole = train_population(cfg, MEMBERS_3, track_best_params=True, device="cpu")
    chunked = train_population(cfg, MEMBERS_3, track_best_params=True, chunk_size=2,
                               device="cpu")
    np.testing.assert_allclose(whole["f1_record"], chunked["f1_record"], atol=1e-6)
    np.testing.assert_allclose(whole["dcg_record"], chunked["dcg_record"], atol=1e-5)
    assert [r["member"] for r in whole["per_member"]] == [
        r["member"] for r in chunked["per_member"]]
    # K = 3 against K = 2 + 1 batches the products another way, and Adam
    # moves an element whose gradient is rounding noise by about lr either
    # way, so each leaf's update over the epoch is held in L2 to the other's
    # at chip_smoke.py's UPDATE_REL, leaving out what it leaves out: the
    # leaves whose gradient is zero by algebra and the key block of the
    # in_proj_bias
    init = build_population_model("mmoecut", seq_len=cfg.seq_len, input_size=3,
                                  dropout=cfg.dropout,
                                  seeds=[m.seed for m in MEMBERS_3]).state_dict()
    for key, value in whole["best_state"].items():
        if key in ZERO_GRAD_LEAVES["mmoecut"]:
            continue
        move, other = (_without_key_bias(key, t - init[key])
                       for t in (value, chunked["best_state"][key]))
        assert (move - other).norm() <= UPDATE_REL * move.norm(), key


def _without_key_bias(name, t):
    """t without the key block of an in_proj_bias, whose gradient is zero by
    algebra (chip_smoke.py's `without_key_bias`)."""
    if not name.endswith("self_attn.in_proj_bias"):
        return t
    d = t.shape[-1] // 3
    return torch.cat([t[..., :d], t[..., 2 * d:]], dim=-1)


def test_stack_state_dicts_keeps_each_member():
    states = [{"a": torch.full((2,), float(i)), "b": torch.tensor(float(i))}
              for i in range(3)]
    stacked = stack_state_dicts(states)
    assert stacked["a"].shape == (3, 2) and stacked["b"].tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError, match="different keys"):
        stack_state_dicts([{"a": torch.zeros(1)}, {"c": torch.zeros(1)}])


@pytest.mark.parametrize("mode", ["parameter", "regularizer", "mt"])
def test_draw_search_trials_match_jax(mode):
    """The trials of each search mode, the record path and the record line,
    character for character the JAX package's."""
    flags = dict(parameter_search=True, search_times=60, seed=5,
                 regularizer_search=mode == "regularizer", mt_search=mode == "mt")
    port_cfg, jax_cfg = TrainConfig(**flags), jax_config.TrainConfig(**flags)
    trials = train.draw_search_trials(port_cfg)
    assert trials == jax_train.draw_search_trials(jax_cfg)
    assert train._search_record_path(port_cfg) == jax_train._search_record_path(jax_cfg)
    result = {"best_f1": 0.71234567, "best_dcg": -1.25}
    for ov in trials[:3] + trials[-2:]:
        assert (train._search_record_line(dataclasses.replace(port_cfg, **ov), result)
                == jax_train._search_record_line(dataclasses.replace(jax_cfg, **ov),
                                                 result))


@pytest.mark.parametrize("what,cfg_kw,member_kw,match", [
    # members of different dropout rates train (tests/test_torch_member_dropout.py);
    # refused is a member's rate outside [0, 1)
    ("per-member dropout", {}, {"dropout": 1.0}, r"\[0, 1\)"),
    ("task weights", {}, {"rerank_weight": 0.2}, "silently ignore"),
    # every model trains as a population in float32 and bfloat16
    # (tests/test_torch_population_zoo*.py): refused are a dtype the port has
    # no kernels for and the model it has not ported
    ("float16", {"compute_dtype": "float16"}, {}, "compute_dtype"),
    ("another model", {"model_name": "probe_base"}, {}, "A4"),
])
def test_population_refuses_what_it_does_not_run(what, cfg_kw, member_kw, match):
    cfg = _tiny_cfg(**cfg_kw)
    with pytest.raises(ValueError, match=match):
        train_population(cfg, [Member(seed=0, **member_kw), Member(seed=1)], device="cpu")


def test_train_cli_population_search_writes_records(tmp_path):
    """`--parameter-search 1 --population 2 --search-times 2 --device cpu`:
    one population of the two trials, two record lines."""
    record = tmp_path / "search.log"
    train.main(["--parameter-search", "1", "--population", "2", "--search-times", "2",
                "--device", "cpu", "--retrieve-data", "mq2007",
                "--synthetic-queries", "12", "--batch-size", "4", "--epochs", "1",
                "--parameter-record", str(record)])
    lines = record.read_text().splitlines()
    assert lines[0] == "" and len(lines) == 3
    assert all(line.startswith("dropout: 0.1, L2_weight: 0.0, rerank_weight: ")
               and "best_f1: " in line for line in lines[1:])
    # a search population refused before its first trial writes no record
    # (the regularizer search's runs: tests/test_torch_member_dropout.py)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        train.main(["--parameter-search", "1", "--population", "2", "--search-times", "2",
                    "--no-preset", "--dropout", "1.0", "--device", "cpu",
                    "--parameter-record", str(tmp_path / "never.log")])
    assert not (tmp_path / "never.log").exists()
