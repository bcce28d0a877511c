"""Populations whose members differ in their dropout rate (a regularizer
search), on the CPU.

The JAX package runs the search as one vmapped program with a traced
`hp["dropout_rate"]` per member. The port keeps its attention kernels
K3'-K6' and gives them a keep threshold and a scale per row
(`ops.attention.RowDropout`; `csrc/keep_mask.cuh` has the encoding, threshold
0 keeping every weight of a row at rate 0), and every other dropout site each
member's own 16-bit threshold and 1 / keep (`models.layers.MemberRates`).
Here, where the kernels' plain versions run:

- (a) the per-row keep masks, packed and per slice, against the JAX
  package's `keep_mask` on `_group_stream`, each row at its own rate, bit
  for bit (a row at rate 0 keeps everything);
- (b) every plain version with per-row rates (forward and backward, packed
  at dh 16 and 64, per slice at dh 128, f32 and bf16) against the
  single-rate call at each member's rate, member block by member block,
  bit for bit;
- (c) `train_population` with a rate per member, one of them 0, for all
  eight models in f32 and four in bf16, each member against its own
  sequential port Trainer at its rate, within tests/test_torch_population_zoo*.py's
  bounds; and a member at rate 0 draws nothing from its generator, as its
  sequential model draws nothing;
- (d) the regularizer search as one population against the sequential
  search, as tests/test_population.py holds the JAX package's, and its CLI.

The dropout bits are torch's (ROADMAP.md C4), and the JAX population at
traced rates runs XLA's, so a population is held to the port's own
sequential Trainers, which tests/test_torch_zoo.py holds to the JAX package
at rate 0.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rlt_tpu.ops import attention as jax_attention
from rlt_tpu_torch import train
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.models import MODELS, build_population_model
from rlt_tpu_torch.ops import attention
from rlt_tpu_torch.population import Member, train_population
from test_torch_population_zoo import assert_members_match_trainers, tiny_cfg
from test_torch_population_zoo_bf16 import assert_bf16_members_match_trainers
from torch_threads import one_torch_thread  # noqa: F401  (one torch thread a test file)

RATES = (0.3, 0.0, 0.05, 0.5)  # one member each; member 1 at rate 0
ROWS = 2  # rows (or slices' batch rows) a member
LENGTH = 24
# the three members of (c): the config's rate (0.2), 0, and another
MEMBERS_3 = [Member(seed=0),
             Member(seed=1, lr=3e-4, weight_decay=0.01, dropout=0.0),
             Member(seed=2, dropout=0.35)]

_jax_keep_mask = jax.jit(jax_attention.keep_mask, static_argnums=(1, 2))


def _streams(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31, size=n).astype(np.int32))


def _jax_mask(stream: int, gi: int, shape, rate: float) -> np.ndarray:
    """The JAX kernels' mask of one tile at one rate; at rate 0 they drop
    nothing (and apply no mask)."""
    if rate == 0.0:
        return np.ones(shape, bool)
    group = jax_attention._group_stream(np.int32(stream), gi)
    return np.asarray(_jax_keep_mask(group, shape, rate))


@pytest.mark.parametrize("heads,pack", [(4, 2), (8, 8), (2, 1)],
                         ids=["dh64-pack2", "dh16-pack8", "slices"])
def test_per_row_keep_masks_match_jax(heads, pack):
    """(a) `head_keep_mask` (packed) and `slice_keep_mask` (per slice, the
    (2, 1) case: one tile a slice) with a `RowDropout` against the JAX
    package's `keep_mask` on each row's group streams at the row's rate."""
    rates = [r for r in RATES for _ in range(ROWS)]
    n = len(rates)
    streams = _streams(n, 3)
    rows = attention.row_dropout(rates)
    if pack == 1:
        got = attention.slice_keep_mask(streams, LENGTH, rows)
        want = np.stack([_jax_mask(int(s), 0, (LENGTH, LENGTH), r)
                         for s, r in zip(streams, rates)])
    else:
        got = attention.head_keep_mask(streams, heads, pack, LENGTH, rows)
        want = np.stack([np.concatenate([
            _jax_mask(int(s), gi, (LENGTH, pack * LENGTH), r)
            .reshape(LENGTH, pack, LENGTH).transpose(1, 0, 2)
            for gi in range(heads // pack)]) for s, r in zip(streams, rates)])
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(got[ROWS:2 * ROWS].all())  # the member at rate 0
    assert not bool(got[:ROWS].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["packed-dh16", "packed-dh64", "slices-dh128"])
def test_per_row_plain_versions_match_single_rate_calls(kind, dtype):
    """(b) Forward and backward with a rate per row: member m's rows (or
    slices) equal the single-rate call at member m's rate, bit for bit;
    the member at rate 0 equals the rate-0 call. Through the wrappers,
    which run the plain versions on the CPU."""
    gen = torch.Generator().manual_seed(7)
    k_members = len(RATES)
    if kind.startswith("packed"):
        heads, d = (8, 128) if kind == "packed-dh16" else (4, 256)
        pack = attention.packed_group_size(d, heads)
        shape, per_member = (k_members * ROWS, LENGTH, d), ROWS
        fwd = (attention.attention_packed_fwd_bf16 if dtype == torch.bfloat16
               else attention.attention_packed_fwd)
        bwd = (attention.attention_packed_bwd_bf16 if dtype == torch.bfloat16
               else attention.attention_packed_bwd)
        fwd_of = lambda q, k, v, rate, s: fwd(q, k, v, heads, pack, rate, s)  # noqa: E731
        bwd_of = lambda q, k, v, o, lse, do, rate, s: bwd(  # noqa: E731
            q, k, v, o, lse, do, heads, pack, rate, s)
        lse_rows = per_member
    else:
        shape, per_member = (k_members * ROWS, 2, LENGTH, 128), ROWS * 2
        fwd = attention.attention_fwd_bf16 if dtype == torch.bfloat16 else attention.attention_fwd
        bwd = attention.attention_bwd_bf16 if dtype == torch.bfloat16 else attention.attention_bwd
        fwd_of, bwd_of, lse_rows = fwd, bwd, per_member
    q, k, v, do = (torch.randn(shape, generator=gen).to(dtype) for _ in range(4))
    streams = _streams(k_members * per_member, 11)
    rows = attention.row_dropout(RATES).repeat(per_member)
    o, lse = fwd_of(q, k, v, rows, streams)
    grads = bwd_of(q, k, v, o, lse, do, rows, streams)
    assert o.dtype == dtype and all(g.dtype == dtype for g in grads)
    for m, rate in enumerate(RATES):
        b = slice(m * ROWS, (m + 1) * ROWS)
        s = slice(m * per_member, (m + 1) * per_member)
        o1, lse1 = fwd_of(q[b], k[b], v[b], rate, streams[s])
        grads1 = bwd_of(q[b], k[b], v[b], o1, lse1, do[b], rate, streams[s])
        assert torch.equal(o[b], o1) and torch.equal(lse[m * lse_rows:(m + 1) * lse_rows], lse1)
        for g, g1 in zip(grads, grads1):
            assert torch.equal(g[b], g1), (m, rate)


def test_per_row_rates_are_checked():
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        attention.row_dropout([0.2, 1.0])
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        attention.row_dropout([-0.1])
    q = torch.zeros(3, 8, 128)
    with pytest.raises(ValueError, match="per-row dropout"):
        attention.attention_packed_fwd(q, q, q, 8, 8, attention.row_dropout([0.1, 0.2]),
                                       _streams(3, 0))
    with pytest.raises(ValueError, match="streams"):
        attention.attention_packed_fwd(q, q, q, 8, 8, attention.row_dropout([0.1] * 3))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_population_of_member_rates_matches_sequential_trainers(name):
    """(c) f32: three members at rates 0.2 (the config's), 0 and 0.35 and
    distinct seeds, lr and weight decay, one epoch, each against its
    sequential Trainer at its own rate."""
    cfg = tiny_cfg(name)
    out = train_population(cfg, MEMBERS_3, device="cpu")
    assert [row["member"]["dropout"] for row in out["per_member"]] == [None, 0.0, 0.35]
    assert_members_match_trainers(cfg, MEMBERS_3, out)


@pytest.mark.parametrize("name", ["mmoecut", "mtple", "choopy", "bicut"])
def test_bf16_population_of_member_rates_matches_sequential_trainers(name):
    """(c) bf16: the same members, each against its sequential bf16
    Trainer at its own rate by the bf16 rule (d_ref its f32 Trainer)."""
    cfg = tiny_cfg(name, compute_dtype="bfloat16")
    out = train_population(cfg, MEMBERS_3, track_best_params=True, device="cpu")
    assert_bf16_members_match_trainers(cfg, MEMBERS_3, out)


@pytest.mark.parametrize("name", ["attncut", "mtple", "bicut"])
def test_member_at_rate_0_draws_nothing(name):
    """A member at rate 0 draws no seed and no mask from its generator (its
    sequential model at rate 0 draws nothing), while the member beside it
    draws; the rate-0 member's training-mode heads are its eval heads."""
    pop = build_population_model(name, seq_len=12, input_size=3, dropout=[0.3, 0.0],
                                 seeds=[4, 5]).train()
    gens = [torch.Generator().manual_seed(60), torch.Generator().manual_seed(61)]
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 12, 3))
                         .astype(np.float32))
    out = pop(x, gens)
    assert not torch.equal(gens[0].get_state(), torch.Generator().manual_seed(60).get_state())
    assert torch.equal(gens[1].get_state(), torch.Generator().manual_seed(61).get_state())
    with torch.no_grad():
        ref = pop.eval()(x)
    for got, want in zip(out if isinstance(out, list) else [out],
                         ref if isinstance(ref, list) else [ref]):
        assert torch.equal(got[1].detach(), want[1])


def _search_rows(record):
    rows = []
    for line in record.read_text().strip().splitlines():
        rows.append({k.strip(): float(v) for k, v in
                     (kv.split(":") for kv in line.split(","))})
    return rows


def test_regularizer_search_population_matches_sequential_search(tmp_path):
    """(d) `parameter_search(regularizer_search=True, population=2)` trains
    the trials the sequential search draws, each member at its trial's
    dropout rate and weight decay: the same hyper-parameters in the record
    lines, best_f1 within 1e-6 and best_dcg within 1e-5 of the sequential
    runs (tests/test_population.py's bounds for the JAX package)."""
    def run(record, population):
        cfg = dataclasses.replace(tiny_cfg("attncut"), parameter_search=True,
                                  regularizer_search=True, search_times=2, epochs=2,
                                  parameter_record=str(record))
        train.parameter_search(cfg, population=population, device="cpu")
        return _search_rows(record)

    seq = run(tmp_path / "seq.log", population=0)
    pop = run(tmp_path / "pop.log", population=2)
    assert len(seq) == len(pop) == 2 and seq[0]["dropout"] != seq[1]["dropout"]
    for s, p in zip(seq, pop):
        for key in ("dropout", "L2_weight", "rerank_weight", "class_weight"):
            assert s[key] == p[key], key
        np.testing.assert_allclose(p["best_f1"], s["best_f1"], atol=1e-6)
        np.testing.assert_allclose(p["best_dcg"], s["best_dcg"], atol=1e-5)


def test_train_cli_regularizer_search_population(tmp_path):
    """`--parameter-search 1 --regularizer-search 1 --population 2 --device
    cpu`: one population of the search's first two trials, each trial's
    dropout rate and weight decay in its record line."""
    record = tmp_path / "search.log"
    train.main(["--parameter-search", "1", "--regularizer-search", "1",
                "--population", "2", "--search-times", "2", "--device", "cpu",
                "--retrieve-data", "mq2007", "--synthetic-queries", "12",
                "--batch-size", "4", "--epochs", "1", "--parameter-record", str(record)])
    trials = train.draw_search_trials(TrainConfig(parameter_search=True,
                                                  regularizer_search=True, search_times=2))
    rows = _search_rows(record)
    assert len(rows) == 2
    for row, trial in zip(rows, trials):
        assert row["dropout"] == trial["dropout"] and row["L2_weight"] == trial["weight_decay"]
