#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rlt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `rlt_tpu_torch/csrc`, prints ptxas's
registers and spills of each (and any wgmma it serialized), holds each one
(the float32 instances and the bf16 ones of all six, K1'-K6') against its
plain PyTorch version on the card at the main paths' shapes and times both
(the bf16 attention forwards and backwards of dh = 64, 128 and 16 also at
a list of L = 2048, the backwards at dropout rates 0 and 0.1, each bound
by the largest of its bytes, its products and one exponential a score,
with the keep hash's floor beside it at rate 0.1; the bf16 LSTM kernels
with their tensor-core bound, K2''s passes timed apart by torch.profiler),
then drives thirty-three main paths at robust04 width (L = 300, seeded
random weights): serving and training in float32, and serving and training
in bf16 (`<model>-serve-bf16` and `<model>-train-bf16`:
`compute_dtype="bfloat16"`, through the bf16 kernel instances only), of
MMOECut, MOECut,
AttnCut and MtAttnCut (F = 3, 4 heads of dh = 64: the packed attention
kernels, over the stacked (3 * B) experts of MMOECut and MOECut and over
the B rows of AttnCut's and MtAttnCut's one encoder), PLECut (2 heads of
dh = 128: the per-slice attention kernels), BiCut (the LSTM kernels only),
and Choopy and MtChoopy (scores only, F = 1, served from `{"scores": ...}`
bodies; three encoder layers of 8 heads of dh = 16: the packed attention
kernels' dh = 16 instances, one launch per layer, and no LSTM kernel):

- serving: the model over HTTP through `TruncationService`, the cuts
  checked against the same model run through the plain versions on the
  card;
- training: one epoch of `Trainer` with the model's drmm_tks preset (B = 63
  lists) on the synthetic robust04 corpus, checked against the same epoch
  through the plain versions on the card (same weights, batch plans and
  dropout masks).

On the card each train step, test step and serving bucket is one CUDA
graph (`rlt_tpu_torch/utils/graphs.py`), so every main path runs graphed;
the plain references run eager (`graphs=False`: a replay inside
`plain_ops()` raises, and each path shows that it does). Each path also
holds its graphs to the eager route of the same model: every serving
bucket's forward (1 to 256) bit for bit, and three train steps of a fresh
graphed `Trainer` against three of a fresh eager one (the step results,
gradients, parameters and Adam's state, and a test batch), and times the
graphed step and buckets 64 and 256 against the eager ones with the card's
busy time (the union of its device intervals) and the host's share; a
graphed step's busy time must be measured and within 5% of the eager
step's, since the graph replays the same device work.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after, and must have launched each kernel exactly as often as its
shape says (and the other attention kernels, and the other dtype's
instances, not at all); a replay adds the launches its graph captured. A bf16 path's served distributions, and its step-1
gradients, step losses and epoch updates, are held to the same bf16 run
through the plain versions on the card, against d_ref, the distance between
that bf16 plain run and the float32 one.

Population training (`rlt_tpu_torch/population.py`) comes last: K1' and K2'
over K = 4 and 8 members' BiLSTM layers in one launch (ndir = 2K) against
their plain versions, K launches at ndir = 2 and cuDNN; the
`mmoecut-population` path, `train_population` of 4 MMOECut members of
distinct seed, lr and weight decay for one epoch (2 K1', 2 K2', 1 K5' and
1 K6' a step for the whole population), each member held to its own
sequential `Trainer` on the card; and a population of 8 members' epoch
against 8 sequential epochs.

Every time is the median of rounds taken in turns with what it is compared
with (`rlt_tpu_torch/utils/timing.py`), printed with its spread; every
train step, the bucket-64 and bucket-256 forwards and the population's
epochs also carry the card's busy time from torch.profiler and the host's
share of the window timed without the profiler (a busy time above that
window is printed as a failed row, with no share). It prints a `graphs` JSON line per model and dtype (the graphed
and eager step and buckets), a `kernels` JSON line, the card's name and
power limit, and last
`{"ok": true, "device": {...}}`. Any failed check raises, and the script
then exits with a non-zero code; without a CUDA card it exits before any
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

SEQ_LEN, FEATURES, HIDDEN, HEADS, D_MODEL, EXPERTS = 300, 3, 128, 4, 256, 3
SLICE_HEADS, SLICE_DH = 2, 128  # PLECut's experts
CHOOPY_HEADS, CHOOPY_D = 8, 128  # Choopy's and MtChoopy's encoder layers: dh = 16
BATCHES = (63, 256)
# the attention rows N of the packed kernels: the stacked experts of MMOECut
# and MOECut at B = 63 and 256, and the B = 63 rows of AttnCut's and
# MtAttnCut's unstacked encoder; at dh = 16 the B = 63 rows of Choopy's
# training batch and the 256 of its largest serving bucket
PACKED_ROWS = (EXPERTS * BATCHES[0], EXPERTS * BATCHES[1], BATCHES[0])
CHOOPY_ROWS = BATCHES
# each model's attention kernels, forward and backward (BiCut has none)
PACKED = ("attention_packed_fwd", "attention_packed_bwd")
ATTENTION_KERNELS = {"mmoecut": PACKED, "moecut": PACKED, "attncut": PACKED,
                     "mtattncut": PACKED, "mtple": ("attention_fwd", "attention_bwd"),
                     "bicut": (), "choopy": PACKED, "mtchoopy": PACKED}
# launches of the attention pair per forward (its encoder layers) and of the
# LSTM pair (BiLSTM layers), where a model has other than 1 and 2
ENCODER_LAYERS = {"choopy": 3, "mtchoopy": 3}
BILSTM_LAYERS = {"choopy": 0, "mtchoopy": 0}
MODELS = ("mmoecut", "mtple", "moecut", "attncut", "mtattncut", "bicut", "choopy",
          "mtchoopy")
PATHS = tuple(f"{m}-{p}" for m in MODELS for p in ("serve", "train"))
BF16_PATHS = tuple(f"{m}-serve-bf16" for m in MODELS)
# population training (rlt_tpu_torch/population.py): MMOECut's members as
# one model; its path runs K1'/K2' at ndir = 2K and K5'/K6' over K * E * B
# rows. The members of the checked path (distinct seed, lr and weight
# decay, one dropout rate), and the sizes the member-batched LSTM kernels
# and the population's epoch are timed at.
POPULATION_PATH = "mmoecut-population"
POPULATION_MEMBERS = ((0, 3e-5, 0.0), (1, 1e-4, 1e-3), (2, 1e-5, 5e-3), (3, 3e-4, 1e-2))
POPULATION_SIZES = (4, 8)
# the packed attention rows of the checked population path: K * E * B
POPULATION_ROWS = POPULATION_SIZES[0] * EXPERTS * BATCHES[0]
# the bf16 forwards of dh = 64 and 128 also at a list of LONG_L, whose K/V
# stream outlasts any shared-memory residency: rows of 4 heads, and rows of
# PLECut's 2 slices, each from their own generator
LONG_L = 2048
LONG_PACKED_ROWS = 8
LONG_SLICE_ROWS = 8
BF16_TRAIN_PATHS = tuple(f"{m}-train-bf16" for m in MODELS)
# each bf16 instance, by the float32 kernel whose bf16 form it is
BF16_OF = {"lstm_fwd": "lstm_fwd_bf16", "attention_fwd": "attention_fwd_bf16",
           "attention_packed_fwd": "attention_packed_fwd_bf16",
           "lstm_bwd": "lstm_bwd_bf16", "attention_bwd": "attention_bwd_bf16",
           "attention_packed_bwd": "attention_packed_bwd_bf16"}
# the bf16 attention kernels of dh = 64 and 128 have kernels of their own,
# launched through the entry points of attention_packed_fwd.cu,
# attention_fwd.cu, attention_packed_bwd.cu and attention_bwd.cu; dh = 16
# has attention_bf16_dh16.cuh's, through the packed entry points
BF16_SOURCE = {"attention_fwd": "rlt_tpu_torch/csrc/attention_bf16_wgmma.cuh",
               "attention_packed_fwd": "rlt_tpu_torch/csrc/attention_bf16_wgmma.cuh",
               "attention_bwd": "rlt_tpu_torch/csrc/attention_bf16_bwd_wgmma.cuh",
               "attention_packed_bwd": "rlt_tpu_torch/csrc/attention_bf16_bwd_wgmma.cuh"}
# the bf16 LSTM kernels (csrc/lstm_bf16_mma.cuh), launched through the entry
# points of lstm_fwd.cu and lstm_bwd.cu
BF16_LSTM_SOURCE = {"lstm_fwd": "rlt_tpu_torch/csrc/lstm_bf16_mma.cuh",
                    "lstm_bwd": "rlt_tpu_torch/csrc/lstm_bf16_mma.cuh"}
BF16_DH16_SOURCE = {"attention_packed_fwd": "rlt_tpu_torch/csrc/attention_bf16_dh16.cuh",
                    "attention_packed_bwd": "rlt_tpu_torch/csrc/attention_bf16_dh16.cuh"}
BF16_LIBRARY = {
    "lstm_fwd": "torch.nn.LSTM (cuDNN) in bf16, 1 layer 2 directions, weights "
                "flattened, input projection included",
    "attention_fwd": "torch.nn.functional.scaled_dot_product_attention, bf16",
    "attention_packed_fwd": "torch.nn.functional.scaled_dot_product_attention, bf16",
    "lstm_bwd": "backward of torch.nn.LSTM (cuDNN) in bf16, 1 layer 2 directions, "
                "weights flattened, dx and dW_ih included",
    "attention_bwd": "backward of torch.nn.functional.scaled_dot_product_attention, "
                     "bf16, dropout_p 0.1",
    "attention_packed_bwd": "backward of torch.nn.functional."
                            "scaled_dot_product_attention, bf16, dropout_p 0.1"}
# f32 tolerances on the card, kernel against plain version:
# - the LSTM carries h and c through 300 steps, each a 128-term dot product
#   summed in another order than cuBLAS sums it;
# - attention sums 300 scores of 16-, 64- or 128-term dot products, outputs O(1);
# - the served distributions are softmaxes over 300 positions mixed by
#   gates from a 76,800-term contraction of the LSTM outputs.
LSTM_ATOL = 1e-4
ATTN_ATOL = 1e-5
DIST_ATOL = 1e-5
# Backward kernels against their plain versions, relative to the gradient's
# max abs: K2' carries dh and dc through 300 steps and sums dW_hh^T over up
# to 76,500 (t, b) terms in another order; K6' and K4' sum 300 products of
# 16-, 64- or 128-term dot products in another order.
LSTM_BWD_REL = 1e-4
ATTN_BWD_REL = 1e-5
# The training step through the kernels against the plain versions on the
# card, same weights and masks: every step's loss within 1e-5 relative, each
# parameter's step-1 gradient within 1e-3 of its max abs plus 1e-7 (a
# softmax tower's bias has zero gradient by algebra; both sides give
# rounding noise there). After the epoch, each parameter's update (params
# minus init) against the plain run's, in L2 relative to the plain update's
# norm: Adam's first steps move each element by about lr * sign(g), so an
# element whose gradient is near zero on both sides can part the runs by up
# to 2 lr per step, which a max-abs comparison cannot tell from a fault; the
# norm weighs those few elements against the whole leaf. A run that does not
# update, or updates wrongly after step 1, reads about 1. Left out: the
# leaves whose gradient is zero by algebra (the models' ZERO_GRAD_LEAVES)
# and the key block of every in_proj_bias (`without_key_bias`), whose
# update is Adam-normalised rounding noise: at Choopy's lr of 1e-3 that
# noise moved the key bias by about lr a step and read 0.16 on the card.
STEP_LOSS_REL = 1e-5
STEP_GRAD_REL = 1e-3
STEP_GRAD_FLOOR = 1e-7
UPDATE_REL = 1e-2
# bf16 kernels against their plain versions (tests/test_torch_bf16.py's
# tolerances): the LSTM's cs is the float32 carry, as above (LSTM_ATOL), and
# its bf16 hs within one bf16 step of the plain hs beyond that; attention's
# lse is float32 (ATTN_ATOL) and its bf16 o within 2 bf16 steps of max|o|
# (the kernels round each weight against the running max, the plain
# versions the normalised weight: the emulation at L = 300 in
# tests/test_torch_bf16.py holds that order to the JAX kernels at this
# bound). Served bf16 distributions, kernels against plain versions, per
# request: RMS within 2 of d_ref's and max within 3 max|d_ref|, with d_ref
# the bf16 plain run against the float32 plain run. The kernels round every
# attention weight at another point than the plain versions, so the two
# bf16 runs are two independent roundings of one f32 function, each about
# d_ref from it: their RMS apart is about sqrt(2) of d_ref's (1.45 on
# MOECut's served distributions on an H100), and 2 leaves room for d_ref's
# own spread as a one-request sample (tests/test_torch_bf16.py's
# whole-model bounds hold the plain versions, which round as JAX does,
# within sqrt(2)).
O_BF16_STEPS = 2
BF16_RMS_OF_REF = 2.0
BF16_MAX_OF_REF = 3.0
# bf16 backward kernels against their plain versions (the tolerances of
# tests/test_torch_bf16_train_ops.py, where the plain versions are held to
# the JAX kernels): K2''s dxw is rounded from f32 dgates summed in another
# order, so within one bf16 step of the plain dxw beyond LSTM_BWD_REL of its
# max abs, and its f32 dW_hh^T within LSTM_BWD_REL as in f32; K4' and K6'
# round the same ds and pd as the plain versions and sum in another order:
# dq, dk and dv within 2 bf16 steps of each one's max abs.
GRAD_BF16_STEPS = 2
# The bf16 training step and epoch through the kernels against the same bf16
# run through the plain versions on the card (same weights, batch plans and
# masks), with d_ref the plain bf16 run against the plain float32 one. The
# kernels' bf16 attention forwards round each weight against the running max
# (the plain versions the normalised weight), so the two bf16 runs are two
# independent roundings of one f32 function from the first encoder on, and
# every gradient parts from the plain one by about sqrt(2) of d_ref. That
# ratio is an average: a small leaf (a scalar bias) is one sample of it, and
# its d_ref can be near 0 by chance. So, per step-1 gradient leaf:
# - its yardstick is the larger of RMS(d_ref) and rho times its own RMS, rho
#   being the median over the model's leaves of RMS(d_ref) / RMS(gradient)
#   (the model's relative bf16 noise; a leaf has at least that much);
# - the median over leaves of RMS(error) / yardstick within 2 (sqrt(2)
#   expected), and every leaf within 4 (room for a small leaf's spread); a
#   faulty kernel moves gradients by their own size, 1 / rho (16 or more)
#   of the yardstick;
# - no per-leaf max-abs bound: the max of two roundings' difference is
#   noisier still.
# The leaves zero by algebra (`ZERO_GRAD_LEAVES`, the key block of every
# in_proj_bias) are rounding noise on both sides, in bf16 up to 3.7e-2 of the
# model's largest gradient (Choopy's decision bias, 8 lists, on an H100):
# each within ZERO_GRAD_BF16_REL of it. Step losses: within
# BF16_MAX_OF_REF of |d_ref| plus one bf16 step of the loss (d_ref of one
# scalar may be near 0 by chance). After the epoch, the updates (params minus
# init) over all leaves but those above, in L2: within 2 of d_ref's (Adam
# moves each element by about lr * sign(g), and a gradient near 0 takes
# either sign in each bf16 run: independent again).
BF16_GRAD_MEDIAN_OF_REF = 2.0
BF16_GRAD_LEAF_OF_REF = 4.0
ZERO_GRAD_BF16_REL = 0.1
BF16_UPDATE_OF_REF = 2.0
RATE = 0.1  # the drmm_tks preset's dropout of the attention models but MOECut
# H100 SXM peak rates: HBM3 bandwidth, dense f32 without tensor cores, and
# f32 products on the tensor cores in the 3xTF32 split (three dense TF32
# products of 494.7 TFLOP/s per f32 product)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 494.7e12 / 3
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
# Per-score floors of the bf16 attention kernels, whose products are nearly
# free at dh = 16: one exponential a score (MUFU.EX2, 16 a clock an SM), and
# at a dropout rate above 0 the keep hash (keep_mask.cuh: ~10 integer
# operations a score, ~64 a clock an SM), both at the card's maximum SM
# clock (nvidia-smi's clocks.max.sm) on all its SMs.
EX2_PER_CLOCK_SM = 16
HASH_OPS_PER_SCORE = 10
INT_OPS_PER_CLOCK_SM = 64


# Timing (rlt_tpu_torch/utils/timing.py): every time is the median of
# REPEATS rounds taken in turns with what it is compared with in the same
# call (a kernel with its library call; a population with its sequential
# runs), printed with its least and most round; a plain version, which is
# no yardstick of speed, the median of PLAIN_REPEATS single calls.
REPEATS = 7
PLAIN_REPEATS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int = 3, repeats: int = REPEATS) -> float:
    """The median device ms of `fn` over `repeats` rounds of `iters` calls
    (`rlt_tpu_torch.utils.timing.interleaved_ms`, one candidate)."""
    from rlt_tpu_torch.utils.timing import interleaved_ms

    return interleaved_ms({"fn": fn}, iters, repeats)["fn"]["median"]


def plain_time(fn) -> float:
    """A plain version's median device ms over PLAIN_REPEATS single calls:
    it repeats the kernel's arithmetic and is no yardstick of speed, and
    some take a second a call."""
    return cuda_ms(fn, iters=1, repeats=PLAIN_REPEATS)


def timed(kernel, library=None, iters: int = 3, **others) -> dict:
    """The kernel, the library call and any `others` in turns, `REPEATS`
    rounds of `iters` calls each (`interleaved_ms`): the kernel's median as
    `ms`, the library's as `library_ms`, each other's as `<name>_ms`, each
    one's least and most round under `spread_ms`, and the kernel's median
    over the library's as `library_ratio`."""
    from rlt_tpu_torch.utils.timing import interleaved_ms

    candidates = {"kernel": kernel, **({"library": library} if library else {}), **others}
    t = interleaved_ms(candidates, iters)
    key = {"kernel": "ms", "library": "library_ms"}
    out = {key.get(n, f"{n}_ms"): r["median"] for n, r in t.items()}
    out["spread_ms"] = {key.get(n, f"{n}_ms"): [r["min"], r["max"]] for n, r in t.items()}
    if library:
        out["library_ratio"] = out["ms"] / out["library_ms"]
    return out


def bound(nbytes: float, flops: float,
          peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bounds(nbytes: float, flops: float) -> dict:
    """bound_ms and bound_by at f32 FMA rates, and bound_tc_ms: the same
    bytes and f32 operations with the products on the tensor cores in the
    3xTF32 split (the attention kernels' products are all of their flops)."""
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(bound_ms=bound_ms, bound_by=bound_by,
                bound_tc_ms=bound(nbytes, flops, PEAK_3XTF32_FLOPS)[0])


def kernel_us(fn, calls: int = 10) -> dict:
    """Device microseconds a call of each CUDA kernel that `fn` launches, by
    name (torch.profiler): a wrapper's passes apart."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            out[e.key[:80]] = us / calls
    return out


def max_errs(got, want) -> tuple[float, float]:
    """(max abs error, max abs error over the reference's max abs)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def random_streams(rng, n: int, dev) -> torch.Tensor:
    return torch.from_numpy(rng.integers(-2**31, 2**31, size=n, dtype=np.int64)
                            .astype(np.int32)).to(dev)


def packed_streams(rng, n: int, dev) -> torch.Tensor:
    """The dropout streams of n packed rows: at POPULATION_ROWS as the
    population path draws them (`expert_streams` over K * E per-(member,
    expert) seeds of B rows each), elsewhere one random stream a row."""
    if n != POPULATION_ROWS:
        return random_streams(rng, n, dev)
    from rlt_tpu_torch.ops import attention

    return attention.expert_streams(random_streams(rng, n // BATCHES[0], dev), BATCHES[0])


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


@functools.lru_cache(maxsize=None)
def sm_clocks_per_s() -> float:
    """The card's SMs times its maximum SM clock (clocks.max.sm, MHz)."""
    mhz = float(nvidia_smi("clocks.max.sm").splitlines()[0].split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def score_bound(nbytes: float, flops: float, scores: int, with_streams: bool) -> dict:
    """bound_ms of a bf16 attention kernel: the largest of its bytes at
    PEAK_BYTES_PER_S, its products at PEAK_BF16_FLOPS and one exponential a
    score; bound_by "bytes" or "operations", bound_term
    the term ("bytes", "products" or "exponentials"); at a dropout rate
    above 0 also hash_floor_ms, the keep hash's floor (HASH_OPS_PER_SCORE at
    INT_OPS_PER_CLOCK_SM), on its own; both floors at the card's maximum SM
    clock on all its SMs."""
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
             "products": flops / PEAK_BF16_FLOPS * 1e3,
             "exponentials": scores / EX2_PER_CLOCK_SM / sm_clocks_per_s() * 1e3}
    term = max(terms, key=terms.get)
    out = dict(bound_ms=terms[term], bound_by="bytes" if term == "bytes" else "operations",
               bound_term=term)
    if with_streams:
        out["hash_floor_ms"] = (scores * HASH_OPS_PER_SCORE / INT_OPS_PER_CLOCK_SM
                                / sm_clocks_per_s() * 1e3)
    return out


# ---------------------------------------------------------------------------
# Phases 2 and 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def lstm_weights(rng, ndir: int, dev) -> torch.Tensor:
    """W_hh^T of `ndir` directions, (ndir * H, 4H), U(-1, 1) / sqrt(H)."""
    return torch.from_numpy((rng.uniform(-1, 1, size=(ndir * HIDDEN, 4 * HIDDEN))
                             / np.sqrt(HIDDEN)).astype(np.float32)).to(dev)


def lstm_rows(rows: list) -> dict:
    """A LSTM check's result: every row, and as `main` the row of the main
    paths' shape (both directions of a layer in one launch, B = 63)."""
    main = next(r for r in rows if r["ndir"] == 2 and r["batch"] == BATCHES[0])
    return {"rows": rows, "main": main,
            "ndir_1": next(r for r in rows if r["ndir"] == 1 and r["batch"] == BATCHES[0]),
            "b_256": next(r for r in rows if r["ndir"] == 2 and r["batch"] == BATCHES[1]),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def check_lstm(dev, rng) -> dict:
    """K1' against `lstm_recurrence_plain` at one direction (ndir = 1) and
    both directions of a layer in one launch (ndir = 2, the main paths'
    form), B lists per direction; library_ms is cuDNN's one-layer LSTM of
    the same directions (its input projection included)."""
    from rlt_tpu_torch.ops import lstm

    rows = []
    for ndir in (1, 2):
        for batch in BATCHES:
            xw = torch.from_numpy(rng.normal(size=(SEQ_LEN, ndir * batch, 4 * HIDDEN))
                                  .astype(np.float32)).to(dev)
            w = lstm_weights(rng, ndir, dev)
            hs, cs = lstm.lstm_fwd(xw, w, ndir)
            torch.cuda.synchronize()
            want_hs, want_cs = lstm.lstm_recurrence_plain(xw, w, ndir)
            err = max((hs - want_hs).abs().max().item(),
                      (cs - want_cs).abs().max().item())
            require(bool(torch.isfinite(hs).all()), "lstm_fwd: non-finite hs")
            require(err <= LSTM_ATOL, f"lstm_fwd ndir={ndir} B={batch}: max abs err "
                    f"{err} > {LSTM_ATOL}")
            plain_ms = plain_time(lambda: lstm.lstm_recurrence_plain(xw, w, ndir))
            cudnn = torch.nn.LSTM(HIDDEN, HIDDEN, batch_first=True,
                                  bidirectional=ndir == 2).to(dev)
            x_in = torch.from_numpy(rng.normal(size=(batch, SEQ_LEN, HIDDEN))
                                    .astype(np.float32)).to(dev)
            with torch.no_grad():
                t = timed(lambda: lstm.lstm_fwd(xw, w, ndir), lambda: cudnn(x_in))
            nbytes = 4 * ndir * (SEQ_LEN * batch * 4 * HIDDEN + HIDDEN * 4 * HIDDEN
                                 + 2 * SEQ_LEN * batch * HIDDEN)
            flops = ndir * (2 * SEQ_LEN * batch * HIDDEN * 4 * HIDDEN
                            + 10 * SEQ_LEN * batch * HIDDEN)
            bound_ms, bound_by = bound(nbytes, flops)
            row = dict(ndir=ndir, batch=batch, max_abs_err=err, **t,
                       ms_per_step=t["ms"] / SEQ_LEN, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            log("lstm_fwd " + json.dumps(row))
            rows.append(row)
    return lstm_rows(rows)


def lstm_waves(ndir: int, batch: int) -> tuple[int, int, int]:
    """(R, blocks, waves) of K1' and K2''s chain at ndir directions of
    `batch` rows: R rows a block, the fewest of 1, 2 and 4 whose ndir *
    ceil(B / R) blocks fit the SMs, else 4 (csrc/lstm_fwd.cu's launcher),
    and the waves of one block per SM those blocks take."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = next((r for r in (1, 2) if ndir * -(-batch // r) <= sms), 4)
    blocks = ndir * -(-batch // rows)
    return rows, blocks, -(-blocks // sms)


def check_lstm_members(dev, rng) -> dict:
    """K1' and K2' member-batched, as the population runs them: K members'
    BiLSTM layers in one launch at ndir = 2K, direction 2m + s with its own
    W_hh^T, at B = 63 lists a member, K in POPULATION_SIZES. Each against
    its plain version (K1' within LSTM_ATOL, K2' within LSTM_BWD_REL of the
    max abs, two K2' launches bit-equal), and timed in turns against K
    launches at ndir = 2 on the members' slices (`sequential_ms`, the
    population's alternative) and against cuDNN's two-direction LSTM over
    the K * B rows with ONE set of weights (`cudnn_shared_ms`: not the same
    function, so library_ms is null)."""
    from rlt_tpu_torch.ops import lstm

    batch, out = BATCHES[0], {}
    for k in POPULATION_SIZES:
        ndir = 2 * k
        xw = torch.from_numpy(rng.normal(size=(SEQ_LEN, ndir * batch, 4 * HIDDEN))
                              .astype(np.float32)).to(dev)
        w = lstm_weights(rng, ndir, dev)
        dho = torch.from_numpy(rng.normal(size=(SEQ_LEN, ndir * batch, HIDDEN))
                               .astype(np.float32)).to(dev)
        hs, cs = lstm.lstm_fwd(xw, w, ndir)
        torch.cuda.synchronize()
        want_hs, want_cs = lstm.lstm_recurrence_plain(xw, w, ndir)
        fwd_err = max((hs - want_hs).abs().max().item(), (cs - want_cs).abs().max().item())
        require(bool(torch.isfinite(hs).all()) and fwd_err <= LSTM_ATOL,
                f"lstm_fwd K={k} (ndir {ndir}): max abs err {fwd_err} > {LSTM_ATOL}")
        dxw, dw = lstm.lstm_bwd(xw, w, want_hs, want_cs, dho, ndir)
        torch.cuda.synchronize()
        want_dxw, want_dw = lstm.lstm_bwd_plain(xw, w, want_hs, want_cs, dho, ndir)
        errs = [max_errs(dxw, want_dxw), max_errs(dw, want_dw)]
        bwd_rel = max(e[1] for e in errs)
        require(bool(torch.isfinite(dxw).all() and torch.isfinite(dw).all())
                and bwd_rel <= LSTM_BWD_REL,
                f"lstm_bwd K={k} (ndir {ndir}): max rel err {bwd_rel} > {LSTM_BWD_REL}")
        again = lstm.lstm_bwd(xw, w, want_hs, want_cs, dho, ndir)
        require(torch.equal(dxw, again[0]) and torch.equal(dw, again[1]),
                f"lstm_bwd K={k}: two launches on the same inputs differ")
        # each member's slice at ndir = 2, contiguous, as its own run holds it
        rows = 2 * batch
        slices = [(xw[:, m * rows:(m + 1) * rows].contiguous(),
                   w[m * 2 * HIDDEN:(m + 1) * 2 * HIDDEN].contiguous(),
                   want_hs[:, m * rows:(m + 1) * rows].contiguous(),
                   want_cs[:, m * rows:(m + 1) * rows].contiguous(),
                   dho[:, m * rows:(m + 1) * rows].contiguous()) for m in range(k)]
        cudnn = torch.nn.LSTM(HIDDEN, HIDDEN, batch_first=True, bidirectional=True).to(dev)
        x_in = torch.from_numpy(rng.normal(size=(k * batch, SEQ_LEN, HIDDEN))
                                .astype(np.float32)).to(dev)
        with torch.no_grad():
            fwd_t = timed(lambda: lstm.lstm_fwd(xw, w, ndir),
                          sequential=lambda: [lstm.lstm_fwd(a, b, 2)
                                              for a, b, *_ in slices],
                          cudnn_shared=lambda: cudnn(x_in))
        x_in.requires_grad_()
        y, _ = cudnn(x_in)
        g_out = torch.randn_like(y)
        wrt = [x_in, *cudnn.parameters()]
        bwd_t = timed(lambda: lstm.lstm_bwd(xw, w, want_hs, want_cs, dho, ndir),
                      sequential=lambda: [lstm.lstm_bwd(*sl, 2) for sl in slices],
                      cudnn_shared=lambda: torch.autograd.grad(y, wrt, g_out,
                                                               retain_graph=True))
        fwd_plain = plain_time(lambda: lstm.lstm_recurrence_plain(xw, w, ndir))
        bwd_plain = plain_time(lambda: lstm.lstm_bwd_plain(xw, w, want_hs, want_cs, dho,
                                                           ndir))
        state = SEQ_LEN * ndir * batch * HIDDEN
        fwd_bound = bound(4 * (4 * state + ndir * HIDDEN * 4 * HIDDEN + 2 * state),
                          2 * state * 4 * HIDDEN + 10 * state)
        bwd_bound = bound(4 * (2 * 4 * state + 2 * ndir * HIDDEN * 4 * HIDDEN + 3 * state),
                          3 * 2 * 4 * state * HIDDEN)
        r, blocks, waves = lstm_waves(ndir, batch)
        shape = dict(members=k, ndir=ndir, batch=batch, rows_per_block=r, blocks=blocks,
                     waves=waves, library_ms=None)
        out[k] = {
            "lstm_fwd": dict(shape, max_abs_err=fwd_err, **fwd_t, plain_ms=fwd_plain,
                             sequential_ratio=fwd_t["ms"] / fwd_t["sequential_ms"],
                             bound_ms=fwd_bound[0], bound_by=fwd_bound[1]),
            "lstm_bwd": dict(shape, max_abs_err=max(e[0] for e in errs),
                             max_rel_err=bwd_rel, **bwd_t, plain_ms=bwd_plain,
                             sequential_ratio=bwd_t["ms"] / bwd_t["sequential_ms"],
                             bound_ms=bwd_bound[0], bound_by=bwd_bound[1])}
        for name, row in out[k].items():
            log(f"{name} members " + json.dumps(row))
    return out


def check_attention(dev, rng, d_model: int = D_MODEL, heads: int = HEADS,
                    rows: tuple = PACKED_ROWS) -> dict:
    """K5' against its plain version at the packed rows N of the main paths
    (`PACKED_ROWS`; Choopy's `CHOOPY_ROWS` at its width); library_ms: f32
    scaled_dot_product_attention."""
    from rlt_tpu_torch.ops import attention

    pack = attention.packed_group_size(d_model, heads)
    dh = d_model // heads
    out = []
    for n in rows:
        q, k, v = (torch.from_numpy(rng.normal(size=(n, SEQ_LEN, d_model))
                                    .astype(np.float32)).to(dev) for _ in range(3))
        o, lse = attention.fused_attention_packed(q, k, v, heads=heads, pack=pack)
        torch.cuda.synchronize()
        want_o, want_lse = attention.attention_packed_plain(q, k, v, heads, pack)
        err = max((o - want_o).abs().max().item(), (lse - want_lse).abs().max().item())
        require(bool(torch.isfinite(o).all()), "attention_packed_fwd: non-finite o")
        require(err <= ATTN_ATOL,
                f"attention_packed_fwd dh={dh} N={n}: max abs err {err} > {ATTN_ATOL}")
        plain_ms = plain_time(lambda: attention.attention_packed_plain(q, k, v, heads, pack))
        by_head = [t.view(n, SEQ_LEN, heads, dh).transpose(1, 2) for t in (q, k, v)]
        t = timed(lambda: attention.fused_attention_packed(q, k, v, heads=heads, pack=pack),
                  lambda: F.scaled_dot_product_attention(*by_head))
        nbytes = 4 * (4 * n * SEQ_LEN * d_model + n * heads * SEQ_LEN)
        flops = 4 * n * heads * SEQ_LEN * SEQ_LEN * dh
        row = dict(n=n, dh=dh, max_abs_err=err, **t, plain_ms=plain_ms,
                   **bounds(nbytes, flops))
        log("attention_packed_fwd " + json.dumps(row))
        out.append(row)
    return {"rows": out, "max_abs_err": max(r["max_abs_err"] for r in out)}


def check_lstm_bwd(dev, rng) -> dict:
    """K2' against `lstm_bwd_plain` on K1''s hs and cs, at ndir 1 and 2, B
    lists per direction; at ndir = 2 a second launch must be bit-equal to
    the first. library_ms is the backward alone of cuDNN's one-layer LSTM
    of the same directions (which also computes dx and dW_ih of its input
    projection)."""
    from rlt_tpu_torch.ops import lstm

    rows = []
    for ndir in (1, 2):
        for batch in BATCHES:
            xw = torch.from_numpy(rng.normal(size=(SEQ_LEN, ndir * batch, 4 * HIDDEN))
                                  .astype(np.float32)).to(dev)
            w = lstm_weights(rng, ndir, dev)
            hs, cs = lstm.lstm_recurrence_plain(xw, w, ndir)
            dho = torch.from_numpy(rng.normal(size=(SEQ_LEN, ndir * batch, HIDDEN))
                                   .astype(np.float32)).to(dev)
            dxw, dw = lstm.lstm_bwd(xw, w, hs, cs, dho, ndir)
            torch.cuda.synchronize()
            want_dxw, want_dw = lstm.lstm_bwd_plain(xw, w, hs, cs, dho, ndir)
            require(bool(torch.isfinite(dxw).all() and torch.isfinite(dw).all()),
                    "lstm_bwd: non-finite gradient")
            errs = [max_errs(dxw, want_dxw), max_errs(dw, want_dw)]
            rel = max(e[1] for e in errs)
            require(rel <= LSTM_BWD_REL, f"lstm_bwd ndir={ndir} B={batch}: max rel err "
                    f"{rel} > {LSTM_BWD_REL}")
            if ndir == 2:
                again = lstm.lstm_bwd(xw, w, hs, cs, dho, ndir)
                require(torch.equal(dxw, again[0]) and torch.equal(dw, again[1]),
                        f"lstm_bwd ndir=2 B={batch}: two launches on the same inputs "
                        "differ")
            plain_ms = plain_time(lambda: lstm.lstm_bwd_plain(xw, w, hs, cs, dho, ndir))
            cudnn = torch.nn.LSTM(HIDDEN, HIDDEN, batch_first=True,
                                  bidirectional=ndir == 2).to(dev)
            x_in = torch.from_numpy(rng.normal(size=(batch, SEQ_LEN, HIDDEN))
                                    .astype(np.float32)).to(dev).requires_grad_()
            out, _ = cudnn(x_in)
            g_out = torch.randn_like(out)
            wrt = [x_in, *cudnn.parameters()]
            t = timed(lambda: lstm.lstm_bwd(xw, w, hs, cs, dho, ndir),
                      lambda: torch.autograd.grad(out, wrt, g_out, retain_graph=True))
            state = SEQ_LEN * ndir * batch * HIDDEN
            nbytes = 4 * (2 * 4 * state + 2 * ndir * HIDDEN * 4 * HIDDEN + 3 * state)
            flops = 3 * 2 * 4 * state * HIDDEN  # gates, carried dh, dW_hh^T
            bound_ms, bound_by = bound(nbytes, flops)
            row = dict(ndir=ndir, batch=batch, max_abs_err=max(e[0] for e in errs),
                       max_rel_err=rel, **t, ms_per_step=t["ms"] / SEQ_LEN,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            log("lstm_bwd " + json.dumps(row))
            rows.append(row)
    return lstm_rows(rows)


def check_attention_dropout(dev, rng, d_model: int = D_MODEL, heads: int = HEADS,
                            rows: tuple = PACKED_ROWS) -> dict:
    """K5' with dropout 0.1 against its plain version on the same streams
    (so the same keep mask), and at rate 0 with streams bit-equal to the
    call without. library_ms: f32 scaled_dot_product_attention with
    dropout_p 0.1 (its own mask)."""
    from rlt_tpu_torch.ops import attention

    pack = attention.packed_group_size(d_model, heads)
    dh = d_model // heads
    out = []
    for n in rows:
        q, k, v = (torch.from_numpy(rng.normal(size=(n, SEQ_LEN, d_model))
                                    .astype(np.float32)).to(dev) for _ in range(3))
        streams = packed_streams(rng, n, dev)
        o, lse = attention.fused_attention_packed(q, k, v, heads, pack, RATE, streams)
        o_rate0, _ = attention.fused_attention_packed(q, k, v, heads, pack, 0.0, streams)
        o_none, _ = attention.fused_attention_packed(q, k, v, heads, pack)
        torch.cuda.synchronize()
        require(torch.equal(o_rate0, o_none), "attention_packed_fwd: rate 0 with "
                "streams differs from the call without dropout")
        want_o, want_lse = attention.attention_packed_plain(q, k, v, heads, pack, RATE,
                                                            streams)
        err = max((o - want_o).abs().max().item(), (lse - want_lse).abs().max().item())
        require(bool(torch.isfinite(o).all()), "attention_packed_fwd: non-finite o")
        require(err <= ATTN_ATOL, f"attention_packed_fwd dropout dh={dh} N={n}: max abs "
                f"err {err} > {ATTN_ATOL}")
        dropped = (o - o_none).abs().max().item()
        require(dropped > 1e-3, "attention_packed_fwd: dropout changed nothing")
        plain_ms = plain_time(lambda: attention.attention_packed_plain(
            q, k, v, heads, pack, RATE, streams))
        by_head = [t.view(n, SEQ_LEN, heads, dh).transpose(1, 2) for t in (q, k, v)]
        t = timed(lambda: attention.fused_attention_packed(q, k, v, heads, pack, RATE,
                                                           streams),
                  lambda: F.scaled_dot_product_attention(*by_head, dropout_p=RATE))
        nbytes = 4 * (4 * n * SEQ_LEN * d_model + n * heads * SEQ_LEN + n)
        flops = 4 * n * heads * SEQ_LEN * SEQ_LEN * dh
        row = dict(n=n, dh=dh, max_abs_err=err, **t, plain_ms=plain_ms,
                   **bounds(nbytes, flops))
        log("attention_packed_fwd dropout " + json.dumps(row))
        out.append(row)
    return {"rows": out, "max_abs_err": max(r["max_abs_err"] for r in out)}


def check_attention_bwd(dev, rng, d_model: int = D_MODEL, heads: int = HEADS,
                        rows: tuple = PACKED_ROWS) -> dict:
    """K6' against its plain version at rates 0 and 0.1, on K5''s o and lse,
    and a second launch at rate 0.1 bit-equal to the first. Times are at
    rate 0.1, the training path's; library_ms is the backward alone of f32
    scaled_dot_product_attention without dropout."""
    from rlt_tpu_torch.ops import attention

    pack = attention.packed_group_size(d_model, heads)
    dh = d_model // heads
    out_rows = []
    for n in rows:
        q, k, v, do = (torch.from_numpy(rng.normal(size=(n, SEQ_LEN, d_model))
                                        .astype(np.float32)).to(dev) for _ in range(4))
        streams = packed_streams(rng, n, dev)
        errs = []
        for rate in (0.0, RATE):
            o, lse = attention.attention_packed_fwd(q, k, v, heads, pack, rate, streams)
            got = attention.attention_packed_bwd(q, k, v, o, lse, do, heads, pack, rate,
                                                 streams)
            torch.cuda.synchronize()
            want = attention.attention_packed_bwd_plain(q, k, v, o, lse, do, heads, pack,
                                                        rate, streams)
            for g, w in zip(got, want):
                require(bool(torch.isfinite(g).all()), "attention_packed_bwd: non-finite")
                errs.append(max_errs(g, w))
        rel = max(e[1] for e in errs)
        require(rel <= ATTN_BWD_REL, f"attention_packed_bwd dh={dh} N={n}: max rel err "
                f"{rel} > {ATTN_BWD_REL}")
        again = attention.attention_packed_bwd(q, k, v, o, lse, do, heads, pack, RATE,
                                               streams)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"attention_packed_bwd dh={dh} N={n}: two launches on the same inputs "
                "differ")
        plain_ms = plain_time(lambda: attention.attention_packed_bwd_plain(
            q, k, v, o, lse, do, heads, pack, RATE, streams))
        by_head = [t.view(n, SEQ_LEN, heads, dh).transpose(1, 2).detach().requires_grad_()
                   for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*by_head)
        g_out = do.view(n, SEQ_LEN, heads, dh).transpose(1, 2)
        t = timed(lambda: attention.attention_packed_bwd(q, k, v, o, lse, do, heads, pack,
                                                         RATE, streams),
                  lambda: torch.autograd.grad(out, by_head, g_out, retain_graph=True))
        nbytes = 4 * (8 * n * SEQ_LEN * d_model + n * heads * SEQ_LEN + n)
        flops = 10 * n * SEQ_LEN * d_model * SEQ_LEN
        row = dict(n=n, dh=dh, max_abs_err=max(e[0] for e in errs), max_rel_err=rel,
                   **t, plain_ms=plain_ms, **bounds(nbytes, flops))
        log("attention_packed_bwd " + json.dumps(row))
        out_rows.append(row)
    return {"rows": out_rows, "max_abs_err": max(r["max_abs_err"] for r in out_rows)}


def slice_bound(n: int, backward: bool) -> dict:
    """`bounds` of K3' (forward) or K4' (backward) on n (row, head) slices
    of PLECut's (L = 300, dh = 128) attention, with dropout streams: the
    forward reads q, k, v and writes o and lse, with four L x L x dh
    products' flops (scores and PV); the backward reads q, k, v, o, do and
    lse and writes dq, dk and dv, with five (scores, dp, dq, dk, dv)."""
    elems = n * SEQ_LEN * SLICE_DH
    if backward:
        return bounds(4 * (8 * elems + n * SEQ_LEN + n), 10 * elems * SEQ_LEN)
    return bounds(4 * (4 * elems + n * SEQ_LEN + n), 4 * elems * SEQ_LEN)


def check_slice_attention(dev, rng) -> dict:
    """K3' against `attention_plain` at PLECut's shapes, rates 0 and 0.1 on
    the same streams (so the same keep mask); at rate 0 with streams it is
    bit-equal to the call without. library_ms: f32
    scaled_dot_product_attention, with dropout_p 0.1 for the dropout row
    (its own mask)."""
    from rlt_tpu_torch.ops import attention

    rows = []
    for batch in BATCHES:
        n = EXPERTS * batch
        q, k, v = (torch.from_numpy(rng.normal(size=(n, SLICE_HEADS, SEQ_LEN, SLICE_DH))
                                    .astype(np.float32)).to(dev) for _ in range(3))
        streams = random_streams(rng, n * SLICE_HEADS, dev)
        o_none, _ = attention.attention_fwd(q, k, v)
        row = dict(n=n)
        for rate in (0.0, RATE):
            o, lse = attention.attention_fwd(q, k, v, rate, streams)
            torch.cuda.synchronize()
            want_o, want_lse = attention.attention_plain(q, k, v, rate, streams)
            err = max((o - want_o).abs().max().item(), (lse - want_lse).abs().max().item())
            require(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
                    "attention_fwd: non-finite o or lse")
            require(err <= ATTN_ATOL, f"attention_fwd N={n} rate {rate}: max abs err "
                    f"{err} > {ATTN_ATOL}")
            if rate == 0.0:
                require(torch.equal(o, o_none), "attention_fwd: rate 0 with streams "
                        "differs from the call without dropout")
            else:
                require((o - o_none).abs().max().item() > 1e-3,
                        "attention_fwd: dropout changed nothing")
            plain_ms = plain_time(lambda: attention.attention_plain(q, k, v, rate, streams))
            t = timed(lambda: attention.attention_fwd(q, k, v, rate, streams),
                      lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=rate))
            t.update(max_abs_err=err, plain_ms=plain_ms,
                     **slice_bound(n * SLICE_HEADS, backward=False))
            row.update(t if rate == 0.0 else {"dropout_0.1": t})
        row["max_abs_err"] = max(row["max_abs_err"], row["dropout_0.1"]["max_abs_err"])
        log("attention_fwd " + json.dumps(row))
        rows.append(row)
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


def check_slice_attention_bwd(dev, rng) -> dict:
    """K4' against `attention_bwd_plain` at rates 0 and 0.1, on K3''s o and
    lse, and a second launch at rate 0.1 bit-equal to the first. The main
    times are at rate 0.1, the training path's, with library_ms the backward
    alone of f32 scaled_dot_product_attention with dropout_p 0.1; `rate_0`
    holds the times without dropout."""
    from rlt_tpu_torch.ops import attention

    rows = []
    for batch in BATCHES:
        n = EXPERTS * batch
        q, k, v, do = (torch.from_numpy(rng.normal(size=(n, SLICE_HEADS, SEQ_LEN, SLICE_DH))
                                        .astype(np.float32)).to(dev) for _ in range(4))
        streams = random_streams(rng, n * SLICE_HEADS, dev)
        row = dict(n=n)
        for rate in (0.0, RATE):
            o, lse = attention.attention_fwd(q, k, v, rate, streams)
            got = attention.attention_bwd(q, k, v, o, lse, do, rate, streams)
            torch.cuda.synchronize()
            want = attention.attention_bwd_plain(q, k, v, o, lse, do, rate, streams)
            errs = []
            for g, w in zip(got, want):
                require(bool(torch.isfinite(g).all()), "attention_bwd: non-finite")
                errs.append(max_errs(g, w))
            rel = max(e[1] for e in errs)
            require(rel <= ATTN_BWD_REL, f"attention_bwd N={n} rate {rate}: max rel err "
                    f"{rel} > {ATTN_BWD_REL}")
            if rate == RATE:
                again = attention.attention_bwd(q, k, v, o, lse, do, rate, streams)
                require(all(torch.equal(a, b) for a, b in zip(got, again)),
                        f"attention_bwd N={n}: two launches on the same inputs differ")
            plain_ms = plain_time(lambda: attention.attention_bwd_plain(
                q, k, v, o, lse, do, rate, streams))
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, dropout_p=rate)
            t = timed(lambda: attention.attention_bwd(q, k, v, o, lse, do, rate, streams),
                      lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
            t.update(max_abs_err=max(e[0] for e in errs), max_rel_err=rel, plain_ms=plain_ms,
                     **slice_bound(n * SLICE_HEADS, backward=True))
            row.update(t if rate == RATE else {"rate_0": t})
        row["max_abs_err"] = max(row["max_abs_err"], row["rate_0"]["max_abs_err"])
        log("attention_bwd " + json.dumps(row))
        rows.append(row)
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


# ---------------------------------------------------------------------------
# Phase 3b: the bf16 instances against their plain versions
# ---------------------------------------------------------------------------

def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits), elementwise."""
    mag = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_o_check(name: str, o: torch.Tensor, lse: torch.Tensor, want_o: torch.Tensor,
                 want_lse: torch.Tensor) -> tuple[float, float]:
    """(o's max abs err, lse's) of a bf16 attention kernel against its plain
    version; raises past O_BF16_STEPS bf16 steps of max|o| or ATTN_ATOL."""
    require(o.dtype == torch.bfloat16 and lse.dtype == torch.float32, f"{name}: dtypes")
    require(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
            f"{name}: non-finite o or lse")
    o_err = (o.float() - want_o.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    limit = O_BF16_STEPS * bf16_step(want_o.float().abs().max()).item()
    require(o_err <= limit and lse_err <= ATTN_ATOL,
            f"{name}: o max abs err {o_err} (limit {limit}), lse {lse_err} "
            f"(limit {ATTN_ATOL})")
    return o_err, lse_err


def check_lstm_bf16(dev, rng) -> dict:
    """K1''s bf16 instance against `lstm_recurrence_plain` on the same bf16
    xw and W_hh^T at one and two directions, B lists per direction: cs (the
    float32 carry) within LSTM_ATOL, the bf16 hs within one bf16 step of
    the plain hs beyond that. library_ms is cuDNN's bf16 one-layer LSTM of
    the same directions (its input projection included)."""
    from rlt_tpu_torch.ops import lstm

    rows = []
    for ndir in (1, 2):
        for batch in BATCHES:
            xw = torch.from_numpy(rng.normal(size=(SEQ_LEN, ndir * batch, 4 * HIDDEN))
                                  .astype(np.float32)).to(dev).bfloat16()
            w = lstm_weights(rng, ndir, dev).bfloat16()
            hs, cs = lstm.lstm_fwd_bf16(xw, w, ndir)
            torch.cuda.synchronize()
            want_hs, want_cs = lstm.lstm_recurrence_plain(xw, w, ndir)
            require(hs.dtype == torch.bfloat16 and cs.dtype == torch.float32,
                    "lstm_fwd_bf16: dtypes")
            require(bool(torch.isfinite(hs).all() and torch.isfinite(cs).all()),
                    "lstm_fwd_bf16: non-finite hs or cs")
            cs_err = (cs - want_cs).abs().max().item()
            hs_diff = (hs.float() - want_hs.float()).abs()
            hs_beyond = (hs_diff - bf16_step(want_hs)).max().item()
            require(cs_err <= LSTM_ATOL and hs_beyond <= LSTM_ATOL,
                    f"lstm_fwd_bf16 ndir={ndir} B={batch}: cs max abs err {cs_err}, hs "
                    f"{hs_beyond} beyond one bf16 step (limit {LSTM_ATOL})")
            plain_ms = plain_time(lambda: lstm.lstm_recurrence_plain(xw, w, ndir))
            cudnn = torch.nn.LSTM(HIDDEN, HIDDEN, batch_first=True, bidirectional=ndir == 2,
                                  device=dev, dtype=torch.bfloat16)
            x_in = torch.from_numpy(rng.normal(size=(batch, SEQ_LEN, HIDDEN))
                                    .astype(np.float32)).to(dev).bfloat16()
            with torch.no_grad():
                # timed with its weights as built (not compacted; torch
                # warns) and compacted, the latter as library_ms
                unflattened_ms = cuda_ms(lambda: cudnn(x_in))
                cudnn.flatten_parameters()
                t = timed(lambda: lstm.lstm_fwd_bf16(xw, w, ndir), lambda: cudnn(x_in))
            state = SEQ_LEN * ndir * batch * HIDDEN
            # xw, W_hh^T and hs at 2 bytes, cs at 4; K1''s products in f32
            nbytes = 2 * (4 * state + ndir * HIDDEN * 4 * HIDDEN + state) + 4 * state
            flops = 2 * state * 4 * HIDDEN + 10 * state
            bound_ms, bound_by = bound(nbytes, flops)
            # bound_tc_ms: the same bytes against the kernel's own products,
            # h_{t-1} in three bf16 parts, at the dense bf16 rate
            bound_tc_ms = bound(nbytes, 3 * 2 * state * 4 * HIDDEN, PEAK_BF16_FLOPS)[0]
            row = dict(ndir=ndir, batch=batch, max_abs_err=max(cs_err, hs_diff.max().item()),
                       cs_err=cs_err, hs_beyond_step=hs_beyond, **t,
                       ms_per_step=t["ms"] / SEQ_LEN, plain_ms=plain_ms,
                       library_unflattened_ms=unflattened_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bound_tc_ms=bound_tc_ms)
            log("lstm_fwd_bf16 " + json.dumps(row))
            rows.append(row)
    return lstm_rows(rows)


def bf16_attention_bound(n_heads_rows: int, dh: int, with_streams: bool,
                         length: int = SEQ_LEN) -> dict:
    """bound_ms of a bf16 attention forward over n (row, head) pairs of
    width dh at L = `length` (`score_bound`): q, k, v read and o written at
    2 bytes, lse written at 4 (and the streams read), four L x L x dh
    products' flops, and one exponential a score."""
    elems = n_heads_rows * length * dh
    nbytes = 2 * 4 * elems + 4 * n_heads_rows * length + (4 * n_heads_rows if with_streams
                                                          else 0)
    return score_bound(nbytes, 4 * elems * length, n_heads_rows * length * length,
                       with_streams)


def check_attention_bf16(dev, rng, d_model: int = D_MODEL, heads: int = HEADS,
                         rows: tuple = PACKED_ROWS, long_rows: int | None = None) -> dict:
    """K5''s bf16 instance against `attention_packed_plain` on the same bf16
    q, k, v at the packed rows N of the main paths, at rate 0 and with
    dropout 0.1 on the same streams (rate 0 with streams bit-equal to the
    call without); with `long_rows`, also `long_rows` rows at L = LONG_L
    (a K/V stream longer than any shared-memory residency) as res["long"].
    library_ms: bf16 scaled_dot_product_attention."""
    from rlt_tpu_torch.ops import attention

    pack = attention.packed_group_size(d_model, heads)
    dh = d_model // heads
    out = []
    shapes = [(n, SEQ_LEN) for n in rows] + ([(long_rows, LONG_L)] if long_rows else [])
    for n, length in shapes:
        gen = rng if length == SEQ_LEN else np.random.default_rng(LONG_L)
        q, k, v = (torch.from_numpy(gen.normal(size=(n, length, d_model))
                                    .astype(np.float32)).to(dev).bfloat16()
                   for _ in range(3))
        streams = random_streams(gen, n, dev)
        o_none, _ = attention.attention_packed_fwd_bf16(q, k, v, heads, pack)
        row = dict(n=n, dh=dh, length=length)
        for rate in (0.0, RATE):
            o, lse = attention.attention_packed_fwd_bf16(q, k, v, heads, pack, rate, streams)
            torch.cuda.synchronize()
            want_o, want_lse = attention.attention_packed_plain(q, k, v, heads, pack, rate,
                                                                streams)
            o_err, lse_err = bf16_o_check(f"attention_packed_fwd_bf16 dh={dh} N={n} "
                                          f"rate {rate}", o, lse, want_o, want_lse)
            if rate == 0.0:
                require(torch.equal(o, o_none), "attention_packed_fwd_bf16: rate 0 with "
                        "streams differs from the call without dropout")
            plain_ms = plain_time(lambda: attention.attention_packed_plain(
                q, k, v, heads, pack, rate, streams))
            by_head = [t.view(n, length, heads, dh).transpose(1, 2) for t in (q, k, v)]
            t = timed(lambda: attention.attention_packed_fwd_bf16(q, k, v, heads, pack, rate,
                                                                  streams),
                      lambda: F.scaled_dot_product_attention(*by_head, dropout_p=rate))
            t.update(max_abs_err=o_err, lse_err=lse_err, plain_ms=plain_ms,
                     **bf16_attention_bound(n * heads, dh, rate > 0.0, length))
            row.update(t if rate == 0.0 else {"dropout_0.1": t})
        row["max_abs_err"] = max(row["max_abs_err"], row["dropout_0.1"]["max_abs_err"])
        log("attention_packed_fwd_bf16 " + json.dumps(row))
        out.append(row)
    res = {"rows": [r for r in out if r["length"] == SEQ_LEN],
           "max_abs_err": max(r["max_abs_err"] for r in out)}
    if long_rows:
        res["long"] = out[-1]
    return res


def check_slice_attention_bf16(dev, rng) -> dict:
    """K3''s bf16 instance against `attention_plain` on the same bf16 q, k,
    v at PLECut's shapes, rates 0 and 0.1 on the same streams (rate 0 with
    streams bit-equal to the call without), and at LONG_SLICE_ROWS rows of
    L = LONG_L as res["long"]. library_ms: bf16
    scaled_dot_product_attention."""
    from rlt_tpu_torch.ops import attention

    rows = []
    shapes = [(EXPERTS * batch, SEQ_LEN) for batch in BATCHES] + [(LONG_SLICE_ROWS, LONG_L)]
    for n, length in shapes:
        gen = rng if length == SEQ_LEN else np.random.default_rng(LONG_L)
        q, k, v = (torch.from_numpy(gen.normal(size=(n, SLICE_HEADS, length, SLICE_DH))
                                    .astype(np.float32)).to(dev).bfloat16()
                   for _ in range(3))
        streams = random_streams(gen, n * SLICE_HEADS, dev)
        o_none, _ = attention.attention_fwd_bf16(q, k, v)
        row = dict(n=n, slices=n * SLICE_HEADS, length=length)
        for rate in (0.0, RATE):
            o, lse = attention.attention_fwd_bf16(q, k, v, rate, streams)
            torch.cuda.synchronize()
            want_o, want_lse = attention.attention_plain(q, k, v, rate, streams)
            o_err, lse_err = bf16_o_check(f"attention_fwd_bf16 N={n} L={length} rate {rate}",
                                          o, lse, want_o, want_lse)
            if rate == 0.0:
                require(torch.equal(o, o_none), "attention_fwd_bf16: rate 0 with streams "
                        "differs from the call without dropout")
            plain_ms = plain_time(lambda: attention.attention_plain(q, k, v, rate, streams))
            t = timed(lambda: attention.attention_fwd_bf16(q, k, v, rate, streams),
                      lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=rate))
            t.update(max_abs_err=o_err, lse_err=lse_err, plain_ms=plain_ms,
                     **bf16_attention_bound(n * SLICE_HEADS, SLICE_DH, rate > 0.0, length))
            row.update(t if rate == 0.0 else {"dropout_0.1": t})
        row["max_abs_err"] = max(row["max_abs_err"], row["dropout_0.1"]["max_abs_err"])
        log("attention_fwd_bf16 " + json.dumps(row))
        rows.append(row)
    return {"rows": rows[:-1], "long": rows[-1],
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def check_lstm_bwd_bf16(dev, rng) -> dict:
    """K2''s bf16 instance against `lstm_bwd_plain` on the same bf16 xw,
    W_hh^T, hs and dho and f32 cs (K1''s plain bf16 outputs), at one and two
    directions, B lists per direction: dxw within one bf16 step of the plain
    dxw beyond LSTM_BWD_REL of its max abs, the f32 dW_hh^T within
    LSTM_BWD_REL of its max abs; at ndir = 2 a second launch bit-equal to the
    first. library_ms is the backward alone of cuDNN's bf16 one-layer LSTM
    of the same directions, its weights flattened (which also computes dx
    and dW_ih of its input projection)."""
    from rlt_tpu_torch.ops import lstm

    rows = []
    for ndir in (1, 2):
        for batch in BATCHES:
            xw = torch.from_numpy(rng.normal(size=(SEQ_LEN, ndir * batch, 4 * HIDDEN))
                                  .astype(np.float32)).to(dev).bfloat16()
            w = lstm_weights(rng, ndir, dev).bfloat16()
            hs, cs = lstm.lstm_recurrence_plain(xw, w, ndir)
            dho = torch.from_numpy(rng.normal(size=(SEQ_LEN, ndir * batch, HIDDEN))
                                   .astype(np.float32)).to(dev).bfloat16()
            dxw, dw = lstm.lstm_bwd_bf16(xw, w, hs, cs, dho, ndir)
            torch.cuda.synchronize()
            want_dxw, want_dw = lstm.lstm_bwd_plain(xw, w, hs, cs, dho, ndir)
            require(dxw.dtype == torch.bfloat16 and dw.dtype == torch.float32,
                    "lstm_bwd_bf16: dtypes")
            require(bool(torch.isfinite(dxw).all() and torch.isfinite(dw).all()),
                    "lstm_bwd_bf16: non-finite gradient")
            dxw_beyond = ((dxw.float() - want_dxw.float()).abs()
                          - bf16_step(want_dxw)).max().item()
            dxw_limit = LSTM_BWD_REL * want_dxw.float().abs().max().item()
            dw_err, dw_rel = max_errs(dw, want_dw)
            require(dxw_beyond <= dxw_limit and dw_rel <= LSTM_BWD_REL,
                    f"lstm_bwd_bf16 ndir={ndir} B={batch}: dxw {dxw_beyond} beyond one "
                    f"bf16 step (limit {dxw_limit}), dW_hh^T max rel err {dw_rel} "
                    f"(limit {LSTM_BWD_REL})")
            if ndir == 2:
                again = lstm.lstm_bwd_bf16(xw, w, hs, cs, dho, ndir)
                require(torch.equal(dxw, again[0]) and torch.equal(dw, again[1]),
                        f"lstm_bwd_bf16 ndir=2 B={batch}: two launches on the same "
                        "inputs differ")
            plain_ms = plain_time(lambda: lstm.lstm_bwd_plain(xw, w, hs, cs, dho, ndir))
            cudnn = torch.nn.LSTM(HIDDEN, HIDDEN, batch_first=True, bidirectional=ndir == 2,
                                  device=dev, dtype=torch.bfloat16)
            cudnn.flatten_parameters()
            x_in = torch.from_numpy(rng.normal(size=(batch, SEQ_LEN, HIDDEN))
                                    .astype(np.float32)).to(dev).bfloat16().requires_grad_()
            out, _ = cudnn(x_in)
            g_out = torch.randn_like(out)
            wrt = [x_in, *cudnn.parameters()]
            t = timed(lambda: lstm.lstm_bwd_bf16(xw, w, hs, cs, dho, ndir),
                      lambda: torch.autograd.grad(out, wrt, g_out, retain_graph=True))
            state = SEQ_LEN * ndir * batch * HIDDEN
            # xw, dxw (4H wide), W_hh^T, hs and dho at 2 bytes; cs at 4 and
            # dW_hh^T at 4; three (state x 4H) products: the chain's dgates
            # W_hh and dW_hh^T take f32 dgates (f32 rate), the gate
            # recompute bf16 hs and W_hh^T (bf16 tensor-core rate), the
            # operations' time the sum of the two
            nbytes = (2 * (2 * 4 * state + ndir * HIDDEN * 4 * HIDDEN + 2 * state)
                      + 4 * (state + ndir * HIDDEN * 4 * HIDDEN))
            product = 2 * 4 * state * HIDDEN
            bound_ms, bound_by = bound(
                nbytes, 2 * product + product * PEAK_F32_FLOPS / PEAK_BF16_FLOPS)
            # bound_tc_ms: the same bytes against the kernel's own products at
            # the dense bf16 rate: the gate recompute (one part), the chain's
            # dgates W_hh and dW_hh^T (three parts of dgates each)
            bound_tc_ms = bound(nbytes, 7 * product, PEAK_BF16_FLOPS)[0]
            row = dict(ndir=ndir, batch=batch, max_abs_err=max(
                           (dxw.float() - want_dxw.float()).abs().max().item(), dw_err),
                       dxw_beyond_step=dxw_beyond, max_rel_err=dw_rel, **t,
                       ms_per_step=t["ms"] / SEQ_LEN, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, bound_tc_ms=bound_tc_ms,
                       parts_us=kernel_us(lambda: lstm.lstm_bwd_bf16(xw, w, hs, cs, dho,
                                                                     ndir)))
            log("lstm_bwd_bf16 " + json.dumps(row))
            rows.append(row)
    return lstm_rows(rows)


def bf16_grads_check(name: str, got, want) -> float:
    """The largest of dq's, dk's and dv's max abs error against the plain
    version's; raises past GRAD_BF16_STEPS bf16 steps of each one's max abs."""
    errs = []
    for tag, g, w in zip(("dq", "dk", "dv"), got, want):
        require(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()),
                f"{name}: {tag} not finite bf16")
        err = (g.float() - w.float()).abs().max().item()
        limit = GRAD_BF16_STEPS * bf16_step(w.float().abs().max()).item()
        require(err <= limit, f"{name}: {tag} max abs err {err} > {limit}")
        errs.append(err)
    return max(errs)


def bf16_attention_bwd_bound(n_heads_rows: int, dh: int, with_streams: bool = True,
                             length: int = SEQ_LEN) -> dict:
    """bound_ms of a bf16 attention backward over n (row, head) pairs of
    width dh at L = `length` (`score_bound`): q, k, v, o and do read and dq,
    dk and dv written at 2 bytes, lse read at 4 (and the streams read), five
    L x L x dh products' flops (scores, dP, dq, dk, dv), and one exponential
    a score (p, whatever a design takes again)."""
    elems = n_heads_rows * length * dh
    nbytes = 2 * 8 * elems + 4 * n_heads_rows * length + (4 * n_heads_rows if with_streams
                                                          else 0)
    return score_bound(nbytes, 10 * elems * length, n_heads_rows * length * length,
                       with_streams)


def bf16_bwd_rates(name: str, kernel, plain, library, forward, n_heads_rows: int, dh: int,
                   length: int) -> dict:
    """A bf16 attention backward against its plain version on the plain
    forward's o and lse (`forward(rate)`), at rates 0 and 0.1 on the same
    streams: dq, dk and dv within GRAD_BF16_STEPS, rate 0 with streams
    bit-equal to the call without (`kernel(o, lse, rate, with_streams)`),
    and a second launch at rate 0.1 bit-equal to the first. Times at rate
    0.1, the training path's, with the rate-0 times under `rate_0`;
    library_ms: the backward alone of `library(rate)`'s output."""
    errs, by_rate = [], {}
    for rate in (0.0, RATE):
        o, lse = forward(rate)
        got = kernel(o, lse, rate, True)
        torch.cuda.synchronize()
        errs.append(bf16_grads_check(f"{name} rate {rate}", got, plain(o, lse, rate)))
        if rate == 0.0:
            require(all(torch.equal(a, b) for a, b in zip(got, kernel(o, lse, rate, False))),
                    f"{name}: rate 0 with streams differs from the call without dropout")
        by_rate[rate] = (o, lse)
    again = kernel(*by_rate[RATE], RATE, True)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{name}: two launches on the same inputs differ")
    row = {}
    for rate in (RATE, 0.0):
        o, lse = by_rate[rate]
        plain_ms = plain_time(lambda: plain(o, lse, rate))
        grad = library(rate)
        t = timed(lambda: kernel(o, lse, rate, True), grad)
        t.update(plain_ms=plain_ms, **bf16_attention_bwd_bound(n_heads_rows, dh, rate > 0.0,
                                                               length))
        row.update(t if rate == RATE else {"rate_0": t})
    row["max_abs_err"] = row["rate_0"]["max_abs_err"] = max(errs)
    return row


def check_attention_bwd_bf16(dev, rng, d_model: int = D_MODEL, heads: int = HEADS,
                             rows: tuple = PACKED_ROWS, long_rows: int | None = None) -> dict:
    """K6''s bf16 instance against `attention_packed_bwd_plain` on the same
    bf16 q, k, v, do and the plain version's o and lse, at the rows N of the
    main paths (`bf16_bwd_rates`); with `long_rows`, also `long_rows` rows at
    L = LONG_L as res["long"]. library_ms is the backward alone of bf16
    scaled_dot_product_attention at the same dropout rate (its own mask)."""
    from rlt_tpu_torch.ops import attention

    pack = attention.packed_group_size(d_model, heads)
    dh = d_model // heads
    out_rows = []
    shapes = [(n, SEQ_LEN) for n in rows] + ([(long_rows, LONG_L)] if long_rows else [])
    for n, length in shapes:
        gen = rng if length == SEQ_LEN else np.random.default_rng(LONG_L + 1)
        q, k, v, do = (torch.from_numpy(gen.normal(size=(n, length, d_model))
                                        .astype(np.float32)).to(dev).bfloat16()
                       for _ in range(4))
        streams = random_streams(gen, n, dev)
        by_head = [t.view(n, length, heads, dh).transpose(1, 2).detach().requires_grad_()
                   for t in (q, k, v)]
        g_out = do.view(n, length, heads, dh).transpose(1, 2)

        def library(rate):
            out = F.scaled_dot_product_attention(*by_head, dropout_p=rate)
            return lambda: torch.autograd.grad(out, by_head, g_out, retain_graph=True)

        row = dict(n=n, dh=dh, length=length, **bf16_bwd_rates(
            f"attention_packed_bwd_bf16 dh={dh} N={n} L={length}",
            lambda o, lse, rate, with_streams: attention.attention_packed_bwd_bf16(
                q, k, v, o, lse, do, heads, pack, rate, streams if with_streams else None),
            lambda o, lse, rate: attention.attention_packed_bwd_plain(
                q, k, v, o, lse, do, heads, pack, rate, streams),
            library,
            lambda rate: attention.attention_packed_plain(q, k, v, heads, pack, rate, streams),
            n * heads, dh, length))
        log("attention_packed_bwd_bf16 " + json.dumps(row))
        out_rows.append(row)
    res = {"rows": [r for r in out_rows if r["length"] == SEQ_LEN],
           "max_abs_err": max(r["max_abs_err"] for r in out_rows)}
    if long_rows:
        res["long"] = out_rows[-1]
    return res


def check_slice_attention_bwd_bf16(dev, rng) -> dict:
    """K4''s bf16 instance against `attention_bwd_plain` on the same bf16 q,
    k, v, do and the plain version's o and lse, at PLECut's 378 slices of its
    63-list batch (`bf16_bwd_rates`), and at LONG_SLICE_ROWS rows of L =
    LONG_L as res["long"]. library_ms: the backward alone of bf16
    scaled_dot_product_attention at the same dropout rate."""
    from rlt_tpu_torch.ops import attention

    rows = []
    for n, length in ((EXPERTS * BATCHES[0], SEQ_LEN), (LONG_SLICE_ROWS, LONG_L)):
        gen = rng if length == SEQ_LEN else np.random.default_rng(LONG_L + 2)
        q, k, v, do = (torch.from_numpy(gen.normal(size=(n, SLICE_HEADS, length, SLICE_DH))
                                        .astype(np.float32)).to(dev).bfloat16()
                       for _ in range(4))
        streams = random_streams(gen, n * SLICE_HEADS, dev)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def library(rate):
            out = F.scaled_dot_product_attention(*leaves, dropout_p=rate)
            return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)

        row = dict(n=n, slices=n * SLICE_HEADS, length=length, **bf16_bwd_rates(
            f"attention_bwd_bf16 N={n} L={length}",
            lambda o, lse, rate, with_streams: attention.attention_bwd_bf16(
                q, k, v, o, lse, do, rate, streams if with_streams else None),
            lambda o, lse, rate: attention.attention_bwd_plain(q, k, v, o, lse, do, rate,
                                                               streams),
            library, lambda rate: attention.attention_plain(q, k, v, rate, streams),
            n * SLICE_HEADS, SLICE_DH, length))
        log("attention_bwd_bf16 " + json.dumps(row))
        rows.append(row)
    return {"rows": rows[:-1], "long": rows[-1],
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def reset_counts() -> None:
    from rlt_tpu_torch.ops import KERNELS

    for kernel in KERNELS.values():
        kernel.launches = 0


def read_counts() -> dict:
    from rlt_tpu_torch.ops import KERNELS

    return {name: k.launches for name, k in KERNELS.items()}


def want_counts(model_name: str, forwards: int, steps: int = 0,
                bf16: bool = False) -> dict:
    """The launches of `forwards` eval forwards and `steps` train steps of
    `model_name`: per forward, one lstm_fwd per BiLSTM layer (two; both
    directions of a layer in one launch; Choopy and MtChoopy have none) and,
    but for BiCut, one launch of the model's attention forward per encoder
    layer over all its rows (experts and lists; three layers in Choopy and
    MtChoopy, one elsewhere); per step, a forward and the backward's
    lstm_bwd and attention backward, one per layer of each. `bf16`: the
    forwards and backwards launch the bf16 instances of the same kernels
    instead. Every other kernel: none."""
    from rlt_tpu_torch.ops import KERNELS

    lstm_layers = BILSTM_LAYERS.get(model_name, 2)
    kernel = BF16_OF.get if bf16 else (lambda name: name)
    want = dict.fromkeys(KERNELS, 0)
    want.update({kernel("lstm_fwd"): lstm_layers * (forwards + steps),
                 kernel("lstm_bwd"): lstm_layers * steps})
    if ATTENTION_KERNELS[model_name]:
        attn_fwd, attn_bwd = ATTENTION_KERNELS[model_name]
        layers = ENCODER_LAYERS.get(model_name, 1)
        want.update({kernel(attn_fwd): layers * (forwards + steps),
                     kernel(attn_bwd): layers * steps})
    return want


# ---------------------------------------------------------------------------
# Phase 4: serving end to end
# ---------------------------------------------------------------------------


def post(base: str, body: dict) -> dict:
    req = urllib.request.Request(f"{base}/truncate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def get(base: str, path: str) -> dict:
    with urllib.request.urlopen(f"{base}{path}", timeout=60) as r:
        return json.load(r)


def request_lists(feats: list) -> dict:
    """A /truncate body of ragged lists of (length, F) features: the
    `scores` form a scores-only client sends where F = 1."""
    if feats[0].shape[1] == 1:
        return {"scores": [f[:, 0].tolist() for f in feats]}
    return {"features": [f.tolist() for f in feats]}


def tied_lists(model_name: str, dist: np.ndarray, atol: float = DIST_ATOL) -> np.ndarray:
    """Per list, whether its cut may move with a rounding of the
    distribution: the two largest cut probabilities within `atol`, or for
    BiCut's (L, 2) decision pairs any position whose pair is within `atol`
    (its decision can flip)."""
    if model_name == "bicut":
        return np.any(np.abs(dist[..., 0] - dist[..., 1]) <= atol, axis=-1)
    top2 = np.sort(dist, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) <= atol


def serve_end_to_end(rng, model_name: str, list_counts: tuple[int, ...],
                     compute_dtype: str = "float32") -> dict:
    """`model_name` served over HTTP in `compute_dtype`, one request of each
    count of lists in `list_counts` (the one of 5 lists asks for the
    distributions); its cuts and distributions against the same model
    through the plain versions on the card (in bf16, within the bounds of
    d_ref, that plain bf16 run against the plain float32 one); then every
    bucket's graphed forward against the eager one (`graphed_forward_check`)
    and the forward timed per bucket, graphed against eager (and per stage
    for the expert models). A
    scores-only model (F = 1: Choopy, MtChoopy) is sent `{"scores": ...}`
    bodies, the others `{"features": ...}`."""
    from rlt_tpu_torch.config import TrainConfig
    from rlt_tpu_torch.infer import Predictor
    from rlt_tpu_torch.ops import plain_ops
    from rlt_tpu_torch.serve import TruncationService, bucket_size, make_server

    bf16 = compute_dtype == "bfloat16"
    label = f"{model_name}-bf16" if bf16 else model_name
    cfg = TrainConfig(model_name=model_name, retrieve_data="robust04",
                      compute_dtype=compute_dtype)
    features = cfg.input_size  # 1 (the scores alone) for Choopy and MtChoopy
    require(cfg.seq_len == SEQ_LEN, "robust04 shapes")
    service = TruncationService(cfg, max_batch=256, device="cuda")
    predictor = service.predictor
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address
    requests = []
    for n_lists in list_counts:
        want_dist = n_lists == 5
        lengths = rng.integers(1, SEQ_LEN + 1, size=n_lists)
        lengths[0] = SEQ_LEN
        feats = [rng.normal(size=(int(n), features)).astype(np.float32) for n in lengths]
        requests.append((lengths, feats, want_dist))
    try:
        health = get(base, "/healthz")
        require(health["ok"] and health["seq_len"] == SEQ_LEN, f"healthz: {health}")
        reset_counts()  # the serving path's counts start here
        t0 = time.perf_counter()
        outs = [post(base, {**request_lists(feats), "return_distribution": want_dist})
                for _, feats, want_dist in requests]
        serve_s = time.perf_counter() - t0
        launches = read_counts()
        stats = get(base, "/stats")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    require(not thread.is_alive(), "server thread did not stop")
    log(f"{label}: served {len(outs)} requests in {serve_s:.3f} s (first dispatches "
        f"included); stats {json.dumps(stats)}")
    n_req = len(list_counts)
    require(stats["requests"] == n_req and stats["dispatches"] == n_req, f"stats: {stats}")
    require([o["bucket"] for o in outs] == [bucket_size(n, 256) for n in list_counts],
            "buckets")
    want = want_counts(model_name, forwards=n_req, bf16=bf16)
    require(launches == want, f"kernel launches on the {label} serving path: "
            f"{launches}, want {want}")

    # the same model through the plain versions on the card, eager (a graph
    # replays its kernels); in bf16 also the float32 model (the master
    # weights) through them, for d_ref
    require(predictor.graphs, f"{label}: the service's predictor is graphed")
    eager = Predictor(cfg, state_dict=predictor.model.state_dict(), device="cuda",
                      graphs=False)
    ref32 = (Predictor(dataclasses.replace(cfg, compute_dtype="float32"),
                       state_dict=predictor.model.state_dict(), device="cuda",
                       graphs=False)
             if bf16 else None)
    worst_dist, worst_rms, near_ties, moved = 0.0, 0.0, 0, 0
    for (lengths, feats, want_dist), out in zip(requests, outs):
        bucket = out["bucket"]
        x = np.zeros((bucket, SEQ_LEN, features), np.float32)
        for i, f in enumerate(feats):
            x[i, :len(f)] = f
        n = len(lengths)
        with plain_ops():
            ks_ref, dist_ref = eager.predict_with_distribution(x)
            dist32 = ref32.predict_with_distribution(x)[1] if bf16 else None
        limit = DIST_ATOL
        if bf16:
            d_ref = dist_ref[:n] - dist32[:n]
            limit = BF16_MAX_OF_REF * float(np.abs(d_ref).max())
        ks = np.asarray(out["k"])
        require(len(ks) == len(lengths) and np.all(ks >= 1) and np.all(ks <= lengths),
                f"k outside [1, length]: {ks.tolist()}")
        if want_dist:
            diffs, refs = [], []
            for i, d in enumerate(out["distribution"]):
                d = np.asarray(d)
                ref = dist_ref[i, :lengths[i]]  # (length,), BiCut's (length, 2)
                require(d.shape == ref.shape and np.all(np.isfinite(d)), "dist shape")
                diffs.append((d - ref).ravel())
                if bf16:
                    refs.append(d_ref[i, :lengths[i]].ravel())
            diffs = np.concatenate(diffs)
            err = float(np.abs(diffs).max())
            require(err <= limit, f"{label}: distribution err {err} > {limit}")
            worst_dist = max(worst_dist, err / limit)
            if bf16:
                rms = np.sqrt(np.mean(diffs.astype(np.float64) ** 2))
                rms_ref = np.sqrt(np.mean(np.concatenate(refs).astype(np.float64) ** 2))
                require(rms <= BF16_RMS_OF_REF * rms_ref,
                        f"{label}: distribution rms err {rms} > {BF16_RMS_OF_REF} x "
                        f"d_ref's {rms_ref}")
                worst_rms = max(worst_rms, rms / rms_ref)
        # a cut may differ only where the reference's distribution is tied
        tied = tied_lists(model_name, dist_ref[:n], limit)
        want_ks = np.minimum(ks_ref[:n], lengths)
        require(np.all((ks == want_ks) | tied),
                f"cuts differ from the plain run: {ks.tolist()} vs {want_ks.tolist()}")
        near_ties += int(np.sum(tied))
        moved += int(np.sum(ks != want_ks))
    log(f"{label}: served cuts equal the plain run but at near-ties; distributions max "
        f"abs err at {worst_dist:.3e} of its limit" + (
            f", rms at {worst_rms:.3f} of d_ref's" if bf16 else "") +
        f"; near-ties {near_ties}, cuts that moved at one {moved}")

    graphed_forward_check(label, model_name, predictor, eager, bf16)
    timing, rows = {}, {}
    for b in (1, 8, 64, 256):
        x = torch.zeros(b, predictor.cfg.seq_len, predictor.cfg.input_size, device="cuda")
        t = graphed_against_eager(lambda: predictor._forward(x), lambda: eager._forward(x),
                                  3, with_busy=b in (64, 256))
        timing[b] = t["graphed"]["window_ms"]
        if b in (64, 256):
            rows[f"bucket_{b}"] = t
        stages = (f"; stages {json.dumps(stage_ms(predictor.net, b))}"
                  if hasattr(predictor.net, "experts") else "")
        log(f"{label} forward bucket {b} (graphed against eager): {json.dumps(t)}" + stages)
    log(json.dumps({f"{label} lists_per_s": {
        "63 lists (bucket 64)": 63 / timing[64] * 1e3,
        "256 lists (bucket 256)": 256 / timing[256] * 1e3}}))
    return {"launches": launches, "graphs": rows}


def graphed_forward_check(label: str, model_name: str, predictor, eager, bf16: bool) -> None:
    """Every serving bucket's graphed forward (captured on first use) against
    the eager forward of the same model, on features from their own
    generator: the cuts and distributions bit for bit, each replay's
    launches those of one forward; then a replay inside plain_ops() must
    raise."""
    from rlt_tpu_torch.ops import plain_ops
    from rlt_tpu_torch.serve import bucket_sizes

    rng = np.random.default_rng(200)
    want = want_counts(model_name, forwards=1, bf16=bf16)
    shape = (predictor.cfg.seq_len, predictor.cfg.input_size)
    for b in bucket_sizes(256):
        x = torch.from_numpy(rng.normal(size=(b,) + shape).astype(np.float32)).cuda()
        predictor.prepare(b)  # the capture, whose warm-up launches do not count
        before = read_counts()
        ks, dist = (t.clone() for t in predictor._forward(x))
        launches = {k: n - before[k] for k, n in read_counts().items()}
        require(launches == want, f"{label} bucket {b}: a replay launched {launches}, "
                f"one forward launches {want}")
        want_ks, want_dist = eager._forward(x)
        err = (dist - want_dist).abs().max().item()
        require(torch.equal(ks, want_ks) and torch.equal(dist, want_dist),
                f"{label} bucket {b}: the graphed forward differs from the eager one "
                f"(distribution max abs err {err}, cuts equal {torch.equal(ks, want_ks)})")
    require(refuses_in_plain_ops(lambda: predictor._forward(x)),
            f"{label}: a graph replay inside plain_ops() did not raise")
    log(f"{label}: every bucket's graphed forward {bucket_sizes(256)} equals the eager "
        f"one bit for bit, one forward's launches a replay; a replay inside plain_ops() "
        f"raises")


def refuses_in_plain_ops(replay) -> bool:
    """Whether `replay`, a graph replay, raises inside plain_ops(), as it must:
    the graph would run the kernels it captured, not the plain versions."""
    from rlt_tpu_torch.ops import plain_ops

    with plain_ops():
        try:
            replay()
        except RuntimeError as e:
            return "plain_ops" in str(e)
    return False


def graphed_against_eager(graphed, eager, iters: int, with_busy: bool = True,
                          busy_calls: int = 3) -> dict:
    """The window of `graphed` (a graph replay) and of `eager` (the same work
    issued op by op) in turns (`interleaved_ms`, the order reversed in odd
    rounds), each with its spread and, with `with_busy`, the card's busy ms
    over `busy_calls` profiled calls (`device_busy`) and the host share of
    the window (`busy_row`: a busy time above its window is a failed row)."""
    from rlt_tpu_torch.utils.timing import busy_row, device_busy, interleaved_ms

    t = interleaved_ms({"graphed": graphed, "eager": eager}, iters, alternate=True)
    out = {}
    for name, fn in (("graphed", graphed), ("eager", eager)):
        out[name] = {"window_ms": t[name]["median"], "spread_ms": [t[name]["min"],
                                                                   t[name]["max"]]}
        if with_busy:
            out[name].update(busy_row(device_busy(fn, busy_calls), t[name]["median"]))
    return out


# ---------------------------------------------------------------------------
# Phase 5: training end to end
# ---------------------------------------------------------------------------

def train_end_to_end(model_name: str) -> dict:
    """One epoch of `Trainer.run` for `model_name` (its drmm_tks preset, B =
    63; 200 train and 50 test lists of the synthetic robust04 corpus)
    through the kernels, then the same epoch
    through the plain versions on the card from the same weights and
    generator seed: the same batch plans and dropout masks. Before it, one
    train step of each compares step 1's loss and gradients; after it, the
    eager step is timed in its parts and the graphs are held to the eager
    route (`graphed_train_check`). The epoch runs graphed, the plain one
    eager."""
    from rlt_tpu_torch.config import PRESETS, TrainConfig, apply_preset
    from rlt_tpu_torch.models import ZERO_GRAD_LEAVES
    from rlt_tpu_torch.ops import plain_ops
    from rlt_tpu_torch.train import Trainer, train_step

    cfg = apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04"))
    preset = PRESETS["drmm_tks"][model_name]
    require((cfg.batch_size, cfg.lr, cfg.weight_decay, cfg.dropout, cfg.seq_len)
            == (63, preset["lr"], preset["weight_decay"], preset["dropout"], SEQ_LEN),
            f"drmm_tks preset: {cfg}")
    cfg = dataclasses.replace(cfg, epochs=1)

    # step 1 of the epoch's plan, through the kernels and through the plain
    # versions, from fresh trainers (same weights, same generator seed)
    def first_step(route_plain: bool):
        trainer = Trainer(cfg, device="cuda")
        idx, valid = trainer.data.plan(trainer.generator, "train")
        x, y, v = trainer.data.x_train[idx[0]], trainer.data.y_train[idx[0]], valid[0]
        with plain_ops() if route_plain else contextlib.nullcontext():
            loss, _, _ = train_step(trainer.model, trainer.optimizer, trainer.criterion,
                                    cfg.model_name, x, y, v, trainer.generator)
        grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
        return trainer, (x, y, v), float(loss), grads

    before = read_counts()
    timed, batch, loss_k, grads_k = first_step(False)
    torch.cuda.synchronize()
    step_launches = {k: read_counts()[k] - before[k] for k in before}
    require(step_launches == want_counts(model_name, forwards=0, steps=1),
            f"kernel launches of one {model_name} train step: {step_launches}")
    _, _, loss_p, grads_p = first_step(True)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    require(np.isfinite(loss_k) and loss_err <= STEP_LOSS_REL,
            f"step-1 loss {loss_k} vs plain {loss_p}: rel err {loss_err}")
    grad_used = {}  # each gradient's max abs error over its limit
    for name, g in grads_k.items():
        require(bool(torch.isfinite(g).all()), f"non-finite gradient of {name}")
        w = grads_p[name]
        err = (g - w).abs().max().item()
        grad_used[name] = err / (STEP_GRAD_REL * w.abs().max().item() + STEP_GRAD_FLOOR)
    worst = max(grad_used, key=grad_used.get)
    require(grad_used[worst] <= 1.0, f"step-1 gradients over their max abs tolerance "
            f"(share used): {worst_of(grad_used)}")
    log(f"{model_name} train step 1: loss {loss_k} (plain {loss_p}, rel err {loss_err:.3e}); "
        f"the worst gradient, {worst}, used {grad_used[worst]:.3e} of its tolerance")

    # the training path: one epoch through the entry point a user calls
    trainer = Trainer(cfg, device="cuda")
    init = {n: t.clone() for n, t in trainer.model.state_dict().items()}
    torch.cuda.synchronize()
    reset_counts()  # the training path's counts start here
    t0 = time.perf_counter()
    summary = trainer.run()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = read_counts()
    steps, tests = trainer.data.train_batches, trainer.data.test_batches
    want = want_counts(model_name, forwards=tests, steps=steps)
    require(launches == want, f"kernel launches on the {model_name} training path: "
            f"{launches}, want {want} ({steps} train steps, {tests} test batches)")
    metrics = trainer.history[0]
    require(all(np.isfinite(v) for k, v in metrics.items() if k != "train_loss_steps")
            and all(np.isfinite(metrics["train_loss_steps"])), f"metrics {metrics}")

    plain = Trainer(cfg, device="cuda", graphs=False)  # plain versions run eager
    with plain_ops():
        plain.run()
    plain_metrics = plain.history[0]
    k_steps = np.asarray(metrics["train_loss_steps"])
    p_steps = np.asarray(plain_metrics["train_loss_steps"])
    step_rel = np.abs(k_steps - p_steps) / np.abs(p_steps)
    require(len(k_steps) == steps and np.all(step_rel <= STEP_LOSS_REL),
            f"epoch step losses {k_steps.tolist()} vs plain {p_steps.tolist()}: "
            f"rel err {step_rel.tolist()} > {STEP_LOSS_REL}")
    kstate, pstate = trainer.model.state_dict(), plain.model.state_dict()
    update_rel = {}  # each leaf's update error, L2 over the plain update's L2
    for name in kstate:
        require(bool(torch.isfinite(kstate[name]).all()), f"non-finite {name}")
        if name in ZERO_GRAD_LEAVES[model_name]:
            continue
        k_move, p_move = (without_key_bias(name, t[name] - init[name])
                          for t in (kstate, pstate))
        # a leaf the plain run left where it was must stay there too
        update_rel[name] = ((k_move - p_move).norm()
                            / p_move.norm().clamp(min=1e-30)).item()
    worst_update = max(update_rel, key=update_rel.get)
    require(update_rel[worst_update] <= UPDATE_REL, f"updates after the epoch over "
            f"{UPDATE_REL} (L2 rel err): {worst_of(update_rel)}")
    param_err = max((kstate[n] - pstate[n]).abs().max().item() for n in kstate)
    moved = max((kstate[n] - init[n]).abs().max().item() for n in kstate)
    log(f"{model_name} train epoch: {json.dumps(metrics)}; plain {json.dumps(plain_metrics)}; "
        f"step losses max rel err {step_rel.max():.3e}; worst update, {worst_update}, "
        f"L2 rel err {update_rel[worst_update]:.3e} (limit {UPDATE_REL:.0e}); parameters "
        f"max abs diff {param_err:.3e} (largest move from init {moved:.3e}); "
        f"summary {json.dumps(summary)}")

    # one step in its parts, on the batch of the step-1 comparison
    part_ms = train_step_parts(timed, *batch)
    epoch = epoch_timing(trainer)
    graphed = graphed_train_check(cfg, model_name)
    timing = dict(first_epoch_s=epoch_s, epoch_ms=epoch["median"],
                  epoch_spread=[epoch["min"], epoch["max"]], step_ms=part_ms,
                  graphed_step=graphed, train_steps=steps, test_batches=tests)
    log(f"{model_name} train timing " + json.dumps(timing))
    return {"launches": launches, "timing": timing}


def train_end_to_end_bf16(model_name: str) -> dict:
    """One epoch of `Trainer.run` for `model_name` in bf16
    (`compute_dtype="bfloat16"`, its drmm_tks preset, B = 63) through the
    bf16 kernels, against the same bf16 epoch through the plain versions on
    the card and, for d_ref, the float32 epoch through them, all from the
    same weights and generator seed (the same batch plans and dropout
    masks); before it, step 1 the same three ways. The bounds and their
    reasons are at BF16_GRAD_MEDIAN_OF_REF. After it, the bf16 eager step
    timed in its parts, and the graphs held to the eager route."""
    from rlt_tpu_torch.config import TrainConfig, apply_preset
    from rlt_tpu_torch.models import ZERO_GRAD_LEAVES
    from rlt_tpu_torch.ops import plain_ops
    from rlt_tpu_torch.train import Trainer, train_step

    label = f"{model_name}-train-bf16"
    cfg = dataclasses.replace(
        apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04",
                                 compute_dtype="bfloat16")), epochs=1)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    require((cfg.batch_size, cfg.seq_len) == (63, SEQ_LEN), f"drmm_tks preset: {cfg}")

    def first_step(c, route_plain: bool):
        trainer = Trainer(c, device="cuda")
        idx, valid = trainer.data.plan(trainer.generator, "train")
        x, y, v = trainer.data.x_train[idx[0]], trainer.data.y_train[idx[0]], valid[0]
        with plain_ops() if route_plain else contextlib.nullcontext():
            loss, _, _ = train_step(trainer.model, trainer.optimizer, trainer.criterion,
                                    c.model_name, x, y, v, trainer.generator,
                                    trainer.dtype)
        grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
        return trainer, (x, y, v), float(loss), grads

    before = read_counts()
    timed, batch, loss_k, grads_k = first_step(cfg, False)
    torch.cuda.synchronize()
    step_launches = {k: read_counts()[k] - before[k] for k in before}
    require(step_launches == want_counts(model_name, forwards=0, steps=1, bf16=True),
            f"kernel launches of one {label} step: {step_launches}")
    _, _, loss_p, grads_p = first_step(cfg, True)
    _, _, loss_32, grads_32 = first_step(cfg32, True)
    require(all(p.dtype == torch.float32 for p in timed.model.parameters())
            and all(g.dtype == torch.float32 for g in grads_k.values()),
            f"{label}: the master parameters and their gradients are float32")
    loss_limit = (BF16_MAX_OF_REF * abs(loss_p - loss_32)
                  + bf16_step(torch.tensor(loss_p)).item())
    require(np.isfinite(loss_k) and abs(loss_k - loss_p) <= loss_limit,
            f"{label} step-1 loss {loss_k} vs plain {loss_p} (f32 {loss_32}): limit "
            f"{loss_limit}")
    rms = lambda t: t.double().pow(2).mean().sqrt().item()  # noqa: E731
    zero = set(ZERO_GRAD_LEAVES[model_name])
    largest = max(g.abs().max().item() for g in grads_p.values())
    leaves = {}
    for name, g in grads_k.items():
        require(bool(torch.isfinite(g).all()), f"{label}: non-finite gradient of {name}")
        if name in zero:
            noise = g.abs().max().item()
            require(noise <= ZERO_GRAD_BF16_REL * largest, f"{label}: {name}, zero by "
                    f"algebra, reads {noise} > {ZERO_GRAD_BF16_REL} x {largest}")
            continue
        k, p, p32 = (without_key_bias(name, t[name]) for t in (grads_k, grads_p, grads_32))
        leaves[name] = (rms(k - p), rms(p - p32), rms(p))
    rho = float(np.median([d / max(r, 1e-30) for _, d, r in leaves.values()]))
    ratio = {name: err / max(d, rho * r, 1e-30) for name, (err, d, r) in leaves.items()}
    median = float(np.median(list(ratio.values())))
    worst = max(ratio, key=ratio.get)
    require(median <= BF16_GRAD_MEDIAN_OF_REF and ratio[worst] <= BF16_GRAD_LEAF_OF_REF,
            f"{label} step-1 gradients against d_ref: median {median} (limit "
            f"{BF16_GRAD_MEDIAN_OF_REF}), worst {worst_of(ratio)} (limit "
            f"{BF16_GRAD_LEAF_OF_REF})")
    log(f"{label} step 1: loss {loss_k} (plain bf16 {loss_p}, f32 {loss_32}); gradients "
        f"rms err over the yardstick: median {median:.3f}, worst {worst_of(ratio)}; "
        f"rho {rho:.3e}")

    # the training path: one epoch through the entry point a user calls
    trainer = Trainer(cfg, device="cuda")
    init = {n: t.clone() for n, t in trainer.model.state_dict().items()}
    torch.cuda.synchronize()
    reset_counts()  # the training path's counts start here
    t0 = time.perf_counter()
    summary = trainer.run()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = read_counts()
    steps, tests = trainer.data.train_batches, trainer.data.test_batches
    want = want_counts(model_name, forwards=tests, steps=steps, bf16=True)
    require(launches == want, f"kernel launches on the {label} path: {launches}, want "
            f"{want} ({steps} train steps, {tests} test batches)")
    require(summary["compute_dtype"] == "bfloat16" and all(
        t.dtype == torch.float32 for t in trainer.model.state_dict().values()),
        f"{label}: summary {summary} and a float32 state_dict")
    metrics = trainer.history[0]
    require(all(np.isfinite(v) for k, v in metrics.items() if k != "train_loss_steps")
            and all(np.isfinite(metrics["train_loss_steps"])), f"metrics {metrics}")
    runs = {}
    for key, c in (("plain", cfg), ("plain32", cfg32)):
        ref = Trainer(c, device="cuda", graphs=False)  # plain versions run eager
        with plain_ops():
            ref.run()
        runs[key] = ref
    k_steps, p_steps, p32_steps = (np.asarray(t.history[0]["train_loss_steps"]) for t in (
        trainer, runs["plain"], runs["plain32"]))
    limit = (BF16_MAX_OF_REF * np.abs(p_steps - p32_steps)
             + bf16_step(torch.from_numpy(p_steps)).numpy())
    require(len(k_steps) == steps and np.all(np.abs(k_steps - p_steps) <= limit),
            f"{label} epoch step losses {k_steps.tolist()} vs plain {p_steps.tolist()} "
            f"(f32 {p32_steps.tolist()}): limits {limit.tolist()}")
    kstate, pstate, p32state = (t.model.state_dict() for t in (
        trainer, runs["plain"], runs["plain32"]))
    err2 = ref2 = 0.0
    for name in kstate:
        require(bool(torch.isfinite(kstate[name]).all()), f"non-finite {name}")
        if name in zero:
            continue
        k_move, p_move, p32_move = (without_key_bias(name, t[name] - init[name])
                                    for t in (kstate, pstate, p32state))
        err2 += (k_move - p_move).double().pow(2).sum().item()
        ref2 += (p_move - p32_move).double().pow(2).sum().item()
    update_ratio = (err2 / max(ref2, 1e-300)) ** 0.5
    require(update_ratio <= BF16_UPDATE_OF_REF, f"{label}: updates after the epoch part "
            f"from the plain bf16 run's by {update_ratio} of d_ref's (L2, limit "
            f"{BF16_UPDATE_OF_REF})")
    log(f"{label} epoch: {json.dumps(metrics)}; plain bf16 "
        f"{json.dumps(runs['plain'].history[0])}; step losses {k_steps.tolist()} vs plain "
        f"{p_steps.tolist()} (f32 {p32_steps.tolist()}); updates L2 err at "
        f"{update_ratio:.3f} of d_ref's; summary {json.dumps(summary)}")

    part_ms = train_step_parts(timed, *batch)
    epoch = epoch_timing(trainer)
    graphed = graphed_train_check(cfg, label)
    timing = dict(first_epoch_s=epoch_s, epoch_ms=epoch["median"],
                  epoch_spread=[epoch["min"], epoch["max"]], step_ms=part_ms,
                  graphed_step=graphed, train_steps=steps, test_batches=tests)
    log(f"{label} timing " + json.dumps(timing))
    return {"launches": launches, "timing": timing}


GRAPH_CHECK_STEPS = 3
BUSY_REL = 0.05  # a graph replays the eager step's device work: its busy ms within 5%


def graphed_train_check(cfg, label: str) -> dict:
    """Graphed against eager training: a fresh graphed `Trainer` (the
    default on the card) and a fresh eager one (`graphs=False`) from the
    same seed, dropout on (the preset's rate, or RATE where the preset has
    none), each takes GRAPH_CHECK_STEPS steps of the same plan: every step's
    (loss, f1, dcg), then the gradients, parameters and Adam's state, and a
    test batch, bit for bit; each replay launches what one eager step does.
    A replay inside plain_ops() must raise. Then the train step of each, in
    turns, with its busy ms and host share."""
    from rlt_tpu_torch.train import Trainer

    cfg = dataclasses.replace(cfg, dropout=cfg.dropout or RATE)
    graphed, eager = Trainer(cfg, device="cuda"), Trainer(cfg, device="cuda", graphs=False)
    require(graphed.graphs and not eager.graphs
            and graphed.optimizer.defaults["capturable"]
            and eager.optimizer.defaults["capturable"],
            f"{label}: graphed and eager trainers, both with capturable Adam")
    plans = [t.data.plan(t.generator, "train") for t in (graphed, eager)]
    idx, valid = plans[0]
    require(all(torch.equal(a, b) for a, b in zip(*plans)), f"{label}: plans differ")
    for s in range(GRAPH_CHECK_STEPS):
        counts = []
        for t in (graphed, eager):
            before = read_counts()
            out = t.train_batch(idx[s], valid[s])
            torch.cuda.synchronize()
            counts.append(({k: n - before[k] for k, n in read_counts().items()}, out))
        (launches, got), (eager_launches, want) = counts
        require(launches == eager_launches, f"{label} step {s + 1}: a replay launched "
                f"{launches}, the eager step {eager_launches}")
        require(torch.equal(got, want), f"{label} step {s + 1}: graphed (loss, f1, dcg) "
                f"{got.tolist()} against eager {want.tolist()}")
    differ = []
    for (name, p), q in zip(graphed.model.named_parameters(), eager.model.parameters()):
        pairs = [("param", p, q), ("grad", p.grad, q.grad)] + [
            (f"adam {k}", v, eager.optimizer.state[q][k])
            for k, v in graphed.optimizer.state[p].items()]
        differ += [f"{name} {what}: max abs {(a.float() - b.float()).abs().max().item()}"
                   for what, a, b in pairs if not torch.equal(a, b)]
    require(not differ, f"{label}: after {GRAPH_CHECK_STEPS} steps the graphed trainer "
            f"differs from the eager one: {differ[:8]}")
    te = [t.data.plan(t.generator, "test") for t in (graphed, eager)]
    require(torch.equal(graphed.test_batch(te[0][0][0], te[0][1][0]),
                        eager.test_batch(te[1][0][0], te[1][1][0])),
            f"{label}: a graphed test batch differs from the eager one")
    require(refuses_in_plain_ops(lambda: graphed.train_batch(idx[0], valid[0])),
            f"{label}: a train-step replay inside plain_ops() did not raise")
    out = graphed_against_eager(lambda: graphed.train_batch(idx[0], valid[0]),
                                lambda: eager.train_batch(idx[0], valid[0]), 2,
                                busy_calls=5)
    busy = [out[name]["busy_ms"] for name in ("graphed", "eager")]
    require(None not in busy, f"{label}: the profiler recorded no device work of a step: "
            f"busy ms graphed {busy[0]}, eager {busy[1]}")
    require(abs(busy[0] - busy[1]) <= BUSY_REL * busy[1],
            f"{label}: the graphed step's busy {busy[0]} ms is not within "
            f"{BUSY_REL:.0%} of the eager step's {busy[1]} ms")
    log(f"{label}: {GRAPH_CHECK_STEPS} graphed steps equal the eager ones bit for bit "
        f"(results, gradients, parameters, Adam's state; dropout {cfg.dropout}), and a "
        f"test batch; one eager step's launches a replay; a replay inside plain_ops() "
        f"raises; step {json.dumps(out)}")
    return out


def epoch_timing(trainer) -> dict:
    """Device ms of one more epoch of `trainer` (its train steps and test
    batches): the median, least and most of REPEATS epochs."""
    from rlt_tpu_torch.utils.timing import interleaved_ms

    return interleaved_ms({"epoch": trainer.run_epoch}, 1)["epoch"]


def population_config():
    from rlt_tpu_torch.config import TrainConfig, apply_preset

    cfg = dataclasses.replace(apply_preset(TrainConfig(model_name="mmoecut",
                                                       retrieve_data="robust04")), epochs=1)
    require((cfg.batch_size, cfg.seq_len) == (63, SEQ_LEN) and cfg.dropout > 0.0,
            f"drmm_tks preset with dropout on: {cfg}")
    return cfg


def population_end_to_end() -> dict:
    """Population training's main path: `train_population` of MMOECut at
    robust04 width (its drmm_tks preset, B = 63, the preset's dropout 0.1
    shared) with the POPULATION_MEMBERS (distinct seed, lr and weight
    decay), one epoch through the kernels. Before it, one population step
    must launch 2 K1' (ndir = 2K), 2 K2', 1 K5' and 1 K6' (K * E * B rows)
    for the whole population. After it, each member against a sequential
    `Trainer` at its own config on the card, also through the kernels (the
    same weights, corpus, plans and dropout bits, products batched another
    way): every step loss within STEP_LOSS_REL, the epoch's updates within
    UPDATE_REL in L2, leaving out what train_end_to_end leaves out."""
    from rlt_tpu_torch.models import ZERO_GRAD_LEAVES
    from rlt_tpu_torch.population import Member, Population, train_population
    from rlt_tpu_torch.train import Trainer

    cfg = population_config()
    members = [Member(seed=s, lr=lr, weight_decay=wd) for s, lr, wd in POPULATION_MEMBERS]
    pop = Population(cfg, members, device="cuda")
    idx, valid = pop.plans("train")
    before = read_counts()
    pop.train_step(*pop.batch("train", idx[:, 0]), valid[:, 0])
    torch.cuda.synchronize()
    step_launches = {k: read_counts()[k] - before[k] for k in before}
    require(step_launches == want_counts("mmoecut", forwards=0, steps=1),
            f"kernel launches of one population step of {len(members)} members: "
            f"{step_launches}")
    del pop

    reset_counts()  # the population path's counts start here
    t0 = time.perf_counter()
    out = train_population(cfg, members, track_best_params=True, device="cuda")
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = read_counts()
    worst_step, worst_update = 0.0, {}
    for m, (member, row) in enumerate(zip(members, out["per_member"])):
        trainer = Trainer(dataclasses.replace(cfg, seed=member.seed, lr=member.lr,
                                              weight_decay=member.weight_decay),
                          device="cuda")
        if m == 0:
            steps, tests = trainer.data.train_batches, trainer.data.test_batches
            want = want_counts("mmoecut", forwards=tests, steps=steps)
            require(launches == want, f"kernel launches on the {POPULATION_PATH} path: "
                    f"{launches}, want {want} ({steps} steps, {tests} test batches)")
        init = {n: t.clone() for n, t in trainer.model.state_dict().items()}
        trainer.run()
        seq = np.asarray(trainer.history[0]["train_loss_steps"])
        got = np.asarray(row["history"][0]["train_loss_steps"])
        step_rel = np.abs(got - seq) / np.abs(seq)
        require(len(got) == len(seq) == steps and np.all(step_rel <= STEP_LOSS_REL)
                and np.all(np.isfinite(got)),
                f"population member {m}: step losses {got.tolist()} vs its Trainer's "
                f"{seq.tolist()}: rel err {step_rel.tolist()} > {STEP_LOSS_REL}")
        worst_step = max(worst_step, float(step_rel.max()))
        update_rel = {}
        for name, final in trainer.model.state_dict().items():
            if name in ZERO_GRAD_LEAVES["mmoecut"]:
                continue
            pop_move, seq_move = (without_key_bias(name, t - init[name]) for t in (
                out["best_state"][name][m], final))
            require(bool(torch.isfinite(pop_move).all()), f"member {m}: non-finite {name}")
            update_rel[name] = ((pop_move - seq_move).norm()
                                / seq_move.norm().clamp(min=1e-30)).item()
        name = max(update_rel, key=update_rel.get)
        require(update_rel[name] <= UPDATE_REL, f"population member {m}: updates over "
                f"{UPDATE_REL} (L2 rel err) against its Trainer: {worst_of(update_rel)}")
        worst_update[f"member_{m}"] = [name, update_rel[name]]
    log(f"{POPULATION_PATH}: {len(members)} members {json.dumps(POPULATION_MEMBERS)}, "
        f"first epoch {epoch_s:.3f} s; against each member's Trainer: step losses max "
        f"rel err {worst_step:.3e}, worst update (L2 rel err) {json.dumps(worst_update)}; "
        f"summaries {json.dumps([{k: r[k] for k in ('best_f1', 'best_dcg')} for r in out['per_member']])}")
    return launches


def population_timing() -> dict:
    """A population of K = POPULATION_SIZES[-1] members (seeds 0..K-1, the
    POPULATION_MEMBERS' lr and weight decay in turn) against the same K
    members as sequential `Trainer`s, one epoch each a round, in turns
    (`interleaved_ms`): epoch ms as medians with their spread, lists/s
    (every member's train and test lists over the epoch's time), and each
    one's busy ms and host share from torch.profiler."""
    from rlt_tpu_torch.population import Member, Population
    from rlt_tpu_torch.train import Trainer
    from rlt_tpu_torch.utils.timing import busy_row, device_busy, interleaved_ms

    cfg, k = population_config(), POPULATION_SIZES[-1]
    members = [Member(seed=i, lr=POPULATION_MEMBERS[i % len(POPULATION_MEMBERS)][1],
                      weight_decay=POPULATION_MEMBERS[i % len(POPULATION_MEMBERS)][2])
               for i in range(k)]
    pop = Population(cfg, members, device="cuda")
    trainers = [Trainer(dataclasses.replace(cfg, seed=m.seed, lr=m.lr,
                                            weight_decay=m.weight_decay), device="cuda")
                for m in members]

    def sequential():
        for trainer in trainers:
            trainer.run_epoch()

    t = interleaved_ms({"population": pop.run_epoch, "sequential": sequential}, 1)
    lists = k * (trainers[0].data.n_train + trainers[0].data.n_test)
    out = {"members": k, "lists_per_epoch": lists}
    for name, fn in (("population", pop.run_epoch), ("sequential", sequential)):
        out[name] = dict(epoch_ms=t[name]["median"],
                         epoch_spread=[t[name]["min"], t[name]["max"]],
                         lists_per_s=lists / t[name]["median"] * 1e3,
                         **busy_row(device_busy(fn, calls=1), t[name]["median"]))
    out["speedup"] = t["sequential"]["median"] / t["population"]["median"]
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("population timing " + json.dumps(out))
    return out


def without_key_bias(name: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf without its elements whose gradient is zero by algebra in
    every attention model: the key block of an in_proj_bias ([q; k; v] on the
    last axis). Adding b to every key adds q_i . b to all of query i's
    scores, which the softmax over keys cancels."""
    if not name.endswith("self_attn.in_proj_bias"):
        return t
    d = t.shape[-1] // 3
    return torch.cat([t[..., :d], t[..., 2 * d:]], dim=-1)


def worst_of(errs: dict, k: int = 5) -> str:
    return json.dumps(dict(sorted(errs.items(), key=lambda kv: -kv[1])[:k]))


def train_step_parts(trainer, x, y, valid, iters: int = 2) -> dict:
    """Device ms of one train step, and of its forward (with the loss and
    the dropout masks; in bf16 the parameter casts), backward and optimizer
    update: the step's median over REPEATS rounds of `iters` steps between
    CUDA events (`interleaved_ms`) with its least and most round, each
    part's median over those steps from events inside them; and the card's
    busy ms per step from torch.profiler, with the host's share of the
    step's window."""
    from rlt_tpu_torch.train import forward
    from rlt_tpu_torch.utils.timing import busy_row, device_busy, interleaved_ms

    model, opt = trainer.model, trainer.optimizer
    model.train()
    marks = []

    def step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad()
        ev[0].record()
        loss = trainer.criterion(forward(model, x, trainer.generator, trainer.dtype), y,
                                 valid=valid)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        marks.append(ev)

    t = interleaved_ms({"step": step}, iters)["step"]
    torch.cuda.synchronize()
    steps = marks[1:]  # the first warms up
    parts = {name: float(np.median([ev[i].elapsed_time(ev[i + 1]) for ev in steps]))
             for i, name in enumerate(("forward", "backward", "optimizer"))}
    return dict(parts, step=t["median"], step_spread=[t["min"], t["max"]],
                **busy_row(device_busy(step), t["median"]))


@torch.inference_mode()
def stage_ms(model, batch: int, iters: int = 3) -> dict:
    """Device ms of each stage of one MMOECut or PLECut forward at `batch`,
    in the model's dtype, the three in turns (`interleaved_ms`, medians):
    the BiLSTM (2 lstm_fwd launches and the input projections), the expert
    stack (one attention forward launch and the projections and FFN), and
    the gates with the towers."""
    from rlt_tpu_torch.utils.timing import interleaved_ms

    dtype = next(model.parameters()).dtype
    x = torch.zeros(batch, SEQ_LEN, FEATURES, device="cuda", dtype=dtype)
    experts_in = model.pre_encoding(x)
    experts_o = model.experts(experts_in)
    t = interleaved_ms({"bilstm": lambda: model.pre_encoding(x),
                        "experts": lambda: model.experts(experts_in),
                        "gates_towers": lambda: model.heads(experts_in, experts_o)}, iters)
    return {name: r["median"] for name, r in t.items()}


def kernel_name(line: str) -> str:
    """A kernel's name in a line of ptxas, with its template arguments:
    `attn_packed_fwd_kernel<16, 4>` for the mangled
    `..._kernelILi16ELi4EEEv...`, `lstm_fwd_kernel<bf16, 1>` for
    `..._kernelI13__nv_bfloat16Li1EEEv...`, a bool argument as 0 or 1
    (`Lb0E`). A mangled name is its length, then its characters."""
    i = 0
    while i < len(line):
        m = re.match(r"\d+", line[i:])
        if not m:
            i += 1
            continue
        start = i + m.end()
        name = line[start:start + int(m.group())]
        i = start + len(name)
        if not name.endswith("_kernel"):
            continue
        tail = re.match(r"I((?:Li\d+E|Lb[01]E|13__nv_bfloat16|f)+)E", line[i:])
        args = [a.group(1) or a.group(2) or ("bf16" if a.group(3) else "float") for a in
                re.finditer(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)|f",
                            tail.group(1) if tail else "")]
        return name + (f"<{', '.join(args)}>" if args else "")
    return line.split()[-1][:120]


def dh16_entry(name: str, res: dict, drop: dict | None, launches: dict) -> dict:
    """The kernels line's `dh_16` sub-entry of a packed kernel: its times at
    Choopy's N = B = 63 rows, at N = 256 (`n_256`), with dropout 0.1 for the
    forward (`dropout_0.1`, its times at rate 0.1 being the backward's own),
    and its launches on the Choopy and MtChoopy paths."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms", "bound_by",
            "max_abs_err")
    rows = {r["n"]: r for r in res["rows"]}
    entry = {k: rows[CHOOPY_ROWS[0]][k] for k in keys}
    entry[f"n_{CHOOPY_ROWS[1]}"] = {k: rows[CHOOPY_ROWS[1]][k] for k in keys}
    entry["max_abs_err"] = res["max_abs_err"]
    if drop is not None:
        drops = {r["n"]: r for r in drop["rows"]}
        entry["dropout_0.1"] = {k: drops[CHOOPY_ROWS[0]][k] for k in keys}
        entry["dropout_0.1"][f"n_{CHOOPY_ROWS[1]}"] = {
            k: drops[CHOOPY_ROWS[1]][k] for k in keys}
        entry["max_abs_err"] = max(entry["max_abs_err"], drop["max_abs_err"])
    entry["launches_by_path"] = {path: launches[path][name] for path in PATHS
                                 if path.split("-")[0] in ("choopy", "mtchoopy")}
    return entry


def rows_entry(res: dict, drop: dict | None) -> dict:
    """The kernels line's `n_<POPULATION_ROWS>` sub-entry of a packed f32
    kernel: its times and errors at the population path's K * E * B rows,
    with dropout 0.1 for the forward (the backward is timed at rate 0.1)."""
    keys = ("ms", "plain_ms", "library_ms", "library_ratio", "spread_ms", "bound_ms",
            "bound_tc_ms", "bound_by", "max_abs_err", "max_rel_err")
    entry = {k: res["rows"][0][k] for k in keys if k in res["rows"][0]}
    entry["n"] = POPULATION_ROWS
    if drop is not None:
        entry["dropout_0.1"] = {k: drop["rows"][0][k] for k in keys if k in drop["rows"][0]}
        entry["max_abs_err"] = max(entry["max_abs_err"], drop["max_abs_err"])
    return entry


def bf16_entry(name: str, res: dict, source: str, replaces: str, library: str,
               launches: dict, dh16: dict) -> dict:
    """The kernels line's `bf16` sub-entry of a kernel: its bf16 instance's
    keys, at the flagship batch of 63 lists (the LSTM at ndir = 2 with its
    ndir = 1 times, the packed attention at N = 189 with its N = 63 times
    and its dh = 16 instance at N = 63 and 256), with dropout 0.1 for the
    attention forwards (the backwards are timed at rate 0.1), and its
    launches on every path."""
    keys = ("ms", "plain_ms", "library_ms", "library_ratio", "spread_ms", "bound_ms",
            "bound_by", "max_abs_err")

    def pick(r: dict, more: tuple = ()) -> dict:
        # the attention rows' bound term and, at rate 0.1, their hash floor
        return {k: r[k] for k in keys + more + ("bound_term", "hash_floor_ms") if k in r}

    bf16_name = BF16_OF[name]
    row = res.get("main", res["rows"][0])
    by_path = {path: launches[path][bf16_name]
               for path in PATHS + BF16_PATHS + BF16_TRAIN_PATHS}
    entry = {"name": bf16_name, "route": "cuda",
             "source": BF16_SOURCE.get(name) or BF16_LSTM_SOURCE.get(name, source),
             "replaces": replaces,
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             **pick(row), "max_abs_err": res["max_abs_err"],
             "library_call": library, "batch": BATCHES[0]}
    if "ndir_1" in res:  # the LSTM kernels: their tensor-core bound, K2''s passes
        lstm_keys = ("ms_per_step", "bound_tc_ms") + (("parts_us",) if "parts_us" in row
                                                      else ())
        entry["ndir"] = 2
        entry.update({k: row[k] for k in lstm_keys})
        entry["ndir_1"] = {k: res["ndir_1"][k] for k in keys + lstm_keys}
        entry["b_256"] = {k: res["b_256"][k] for k in keys + lstm_keys}
    # the bf16 attention kernels' other rate: dropout 0.1 for the forwards,
    # rate 0 for the backwards (timed at 0.1, the training path's)
    variants = [v for v in ("dropout_0.1", "rate_0") if v in row]
    for variant in variants:
        entry[variant] = pick(row[variant])
    for other in (res["rows"][1:] + [res["long"]] if name in BF16_SOURCE else []):
        # the bf16 attention kernels' other rows: N = 768 and 63, 1536
        # slices, L = LONG_L
        if other["length"] != SEQ_LEN:
            label = f"l_{other['length']}"
        elif name.startswith("attention_packed"):
            label = f"n_{other['n']}"
        else:
            label = f"slices_{other['slices']}"
        entry[label] = pick(other)
        for variant in variants:
            entry[label][variant] = pick(other[variant])
    if name.startswith("attention_packed"):
        # dh = 16 at Choopy's N = 63 rows, its bucket's 256 and L = LONG_L,
        # each at both rates
        rows16 = {r["n"]: r for r in dh16["rows"]}
        entry["dh_16"] = {"source": BF16_DH16_SOURCE[name]}
        for label, r in ((None, rows16[CHOOPY_ROWS[0]]),
                         (f"n_{CHOOPY_ROWS[1]}", rows16[CHOOPY_ROWS[1]]),
                         (f"l_{LONG_L}", dh16["long"])):
            sub = entry["dh_16"] if label is None else entry["dh_16"].setdefault(label, {})
            sub.update(pick(r))
            for variant in variants:
                sub[variant] = pick(r[variant])
        entry["max_abs_err"] = max(res["max_abs_err"], dh16["max_abs_err"])
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available; nothing was run",
              file=sys.stderr)
        return 1
    from rlt_tpu_torch.ops import build
    from rlt_tpu_torch.utils.platform import resolve_device

    dev = resolve_device("cuda")
    card = nvidia_smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.LIBRARY.get()
    built = build.LIBRARY.build_seconds
    log(f"kernels ready in {time.perf_counter() - t0:.2f} s "
        f"({'loaded from an earlier build' if built is None else f'nvcc build {built:.2f} s'})"
        f" at {build.LIBRARY.path}")
    for line in build.LIBRARY.ptxas_log().splitlines():
        if "Function properties for" in line:  # heads each kernel's figures
            log("ptxas kernel " + kernel_name(line))
        elif ("registers" in line or "spill" in line or "Performance" in line
              or "warning" in line or line.startswith("==")):
            log("ptxas " + line.strip())

    marks = [("kernel checks", time.perf_counter())]  # each phase's start
    rng = np.random.default_rng(0)
    lstm_res = check_lstm(dev, rng)
    attn_res = check_attention(dev, rng)
    lstm_bwd_res = check_lstm_bwd(dev, rng)
    attn_drop_res = check_attention_dropout(dev, rng)
    attn_bwd_res = check_attention_bwd(dev, rng)
    slice_res = check_slice_attention(dev, rng)
    slice_bwd_res = check_slice_attention_bwd(dev, rng)
    # the packed kernels' dh = 16 instances at Choopy's width, on their own
    # generator so that the paths below draw what they drew before
    rng16 = np.random.default_rng(16)
    choopy = dict(d_model=CHOOPY_D, heads=CHOOPY_HEADS, rows=CHOOPY_ROWS)
    dh16 = {"attention_packed_fwd": (check_attention(dev, rng16, **choopy),
                                     check_attention_dropout(dev, rng16, **choopy)),
            "attention_packed_bwd": (check_attention_bwd(dev, rng16, **choopy), None)}
    # the bf16 instances, on their own generator so that the paths below
    # draw what they drew before
    rngb = np.random.default_rng(160)
    lstm_bf16_res = check_lstm_bf16(dev, rngb)
    attn_bf16_res = check_attention_bf16(dev, rngb, long_rows=LONG_PACKED_ROWS)
    attn_bf16_dh16_res = check_attention_bf16(dev, rngb, long_rows=LONG_PACKED_ROWS, **choopy)
    slice_bf16_res = check_slice_attention_bf16(dev, rngb)
    # the bf16 backward instances, on their own generator: K6' at the expert
    # models' N = 189 rows and the unstacked encoders' 63, and at Choopy's
    # width at N = 63 and 256
    rngt = np.random.default_rng(170)
    lstm_bwd_bf16_res = check_lstm_bwd_bf16(dev, rngt)
    attn_bwd_bf16_res = check_attention_bwd_bf16(dev, rngt, long_rows=LONG_PACKED_ROWS)
    attn_bwd_bf16_dh16_res = check_attention_bwd_bf16(dev, rngt, long_rows=LONG_PACKED_ROWS,
                                                      **choopy)
    slice_bwd_bf16_res = check_slice_attention_bwd_bf16(dev, rngt)
    launches, train_res, train_bf16_res, serve_res, serve_bf16_res = {}, {}, {}, {}, {}
    marks.append(("f32 paths", time.perf_counter()))
    for model_name in MODELS:
        serve_res[model_name] = serve_end_to_end(
            rng, model_name, (1, 5, 63, 200) if model_name == "mtple" else (1, 5, 63))
        launches[f"{model_name}-serve"] = serve_res[model_name]["launches"]
        train_res[model_name] = train_end_to_end(model_name)
        launches[f"{model_name}-train"] = train_res[model_name]["launches"]
    marks.append(("bf16 serving", time.perf_counter()))
    for model_name in MODELS:  # the bf16 serving lane
        serve_bf16_res[model_name] = serve_end_to_end(
            rngb, model_name, (1, 5, 63), compute_dtype="bfloat16")
        launches[f"{model_name}-serve-bf16"] = serve_bf16_res[model_name]["launches"]
    marks.append(("bf16 training", time.perf_counter()))
    for model_name in MODELS:  # the bf16 training lane
        train_bf16_res[model_name] = train_end_to_end_bf16(model_name)
        launches[f"{model_name}-train-bf16"] = train_bf16_res[model_name]["launches"]
    # population training: the member-batched LSTM kernels on their own
    # generator, then the population's path and its timing
    marks.append(("population", time.perf_counter()))
    members_res = check_lstm_members(dev, np.random.default_rng(180))
    # K5' and K6' at the population path's K * E * B rows, with its streams
    rngp, pop_rows = np.random.default_rng(190), dict(rows=(POPULATION_ROWS,))
    population_attn = {
        "attention_packed_fwd": (check_attention(dev, rngp, **pop_rows),
                                 check_attention_dropout(dev, rngp, **pop_rows)),
        "attention_packed_bwd": (check_attention_bwd(dev, rngp, **pop_rows), None)}
    launches[POPULATION_PATH] = population_end_to_end()
    population_res = population_timing()
    marks.append(("end", time.perf_counter()))
    log(json.dumps({"phase_seconds": {name: marks[i + 1][1] - t for i, (name, t) in
                                      enumerate(marks[:-1])}}))
    bf16_res = {"lstm_fwd": lstm_bf16_res, "attention_fwd": slice_bf16_res,
                "attention_packed_fwd": attn_bf16_res, "lstm_bwd": lstm_bwd_bf16_res,
                "attention_bwd": slice_bwd_bf16_res,
                "attention_packed_bwd": attn_bwd_bf16_res}
    bf16_dh16 = {"attention_packed_fwd": attn_bf16_dh16_res,
                 "attention_packed_bwd": attn_bwd_bf16_dh16_res}
    all_paths = PATHS + BF16_PATHS + BF16_TRAIN_PATHS + (POPULATION_PATH,)

    kernels = []
    for name, res, source, replaces, library in (
            ("lstm_fwd", lstm_res, "rlt_tpu_torch/csrc/lstm_fwd.cu",
             "rlt_tpu/ops/lstm.py:82",
             "torch.nn.LSTM (cuDNN), 1 layer 2 directions, input projection included"),
            ("lstm_bwd", lstm_bwd_res, "rlt_tpu_torch/csrc/lstm_bwd.cu",
             "rlt_tpu/ops/lstm.py:101",
             "backward of torch.nn.LSTM (cuDNN), 1 layer 2 directions, dx and dW_ih "
             "included"),
            ("attention_fwd", slice_res, "rlt_tpu_torch/csrc/attention_fwd.cu",
             "rlt_tpu/ops/attention.py:89",
             "torch.nn.functional.scaled_dot_product_attention, f32"),
            ("attention_bwd", slice_bwd_res, "rlt_tpu_torch/csrc/attention_bwd.cu",
             "rlt_tpu/ops/attention.py:117",
             "backward of torch.nn.functional.scaled_dot_product_attention, f32, "
             "dropout_p 0.1"),
            ("attention_packed_fwd", attn_res,
             "rlt_tpu_torch/csrc/attention_packed_fwd.cu",
             "rlt_tpu/ops/attention.py:369",
             "torch.nn.functional.scaled_dot_product_attention"),
            ("attention_packed_bwd", attn_bwd_res,
             "rlt_tpu_torch/csrc/attention_packed_bwd.cu",
             "rlt_tpu/ops/attention.py:412",
             "backward of torch.nn.functional.scaled_dot_product_attention, f32, "
             "no dropout")):
        # the flagship batch of 63 lists; the LSTM kernels at ndir = 2
        row = res.get("main", res["rows"][0])
        by_path = {path: launches[path][name] for path in all_paths}
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": res["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_ratio": row["library_ratio"], "spread_ms": row["spread_ms"],
            "library_call": library, "batch": BATCHES[0]}
        if "ndir_1" in res:  # the LSTM kernels: one direction, cuDNN's one direction
            entry["ndir"] = 2
            entry["ms_per_step"] = row["ms_per_step"]
            entry["ndir_1"] = {k: res["ndir_1"][k] for k in (
                "ms", "ms_per_step", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        if "bound_tc_ms" in row:  # the attention kernels, whose products are all their flops
            entry["bound_tc_ms"] = row["bound_tc_ms"]
        for variant in ("dropout_0.1", "rate_0"):  # the per-slice kernels' other rate
            if variant in row:
                entry[variant] = {k: row[variant][k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms",
                    "max_abs_err")}
        if name == "attention_packed_fwd":
            drop = attn_drop_res["rows"][0]
            entry["dropout_0.1"] = {k: drop[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms", "max_abs_err")}
            entry["max_abs_err"] = max(res["max_abs_err"], attn_drop_res["max_abs_err"])
        if name.startswith("attention_packed"):  # the unstacked encoders' N = B rows
            row_b = next(r for r in res["rows"] if r["n"] == BATCHES[0])
            entry[f"n_{BATCHES[0]}"] = {k: row_b[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms", "max_abs_err")}
            entry["dh_16"] = dh16_entry(name, *dh16[name], launches)
            entry["max_abs_err"] = max(entry["max_abs_err"], entry["dh_16"]["max_abs_err"])
            entry[f"n_{POPULATION_ROWS}"] = rows_entry(*population_attn[name])
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       entry[f"n_{POPULATION_ROWS}"]["max_abs_err"])
        if name in BF16_OF:
            entry["bf16"] = bf16_entry(name, bf16_res[name], source, replaces,
                                       BF16_LIBRARY[name], launches,
                                       bf16_dh16.get(name))
        kernels.append(entry)
    for name, source, replaces in (
            ("lstm_fwd", "rlt_tpu_torch/csrc/lstm_fwd.cu", "rlt_tpu/ops/lstm.py:82"),
            ("lstm_bwd", "rlt_tpu_torch/csrc/lstm_bwd.cu", "rlt_tpu/ops/lstm.py:101")):
        # the member-batched form (jax.vmap over population members), at
        # K = POPULATION_SIZES[0] with the larger K beside it; its launches
        # are the population path's
        rows = {k: members_res[k][name] for k in POPULATION_SIZES}
        main_row = rows[POPULATION_SIZES[0]]
        entry = {"name": f"{name}_members", "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[POPULATION_PATH][name],
                 "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                 **{key: main_row[key] for key in (
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "members",
                     "ndir", "batch", "rows_per_block", "blocks", "waves",
                     "sequential_ms", "sequential_ratio", "cudnn_shared_ms",
                     "spread_ms")},
                 "library_call": None,
                 "cudnn_shared_call": "torch.nn.LSTM (cuDNN), 1 layer 2 directions, over "
                                      "the K * B rows with one set of weights"}
        for k, row in rows.items():
            if k != POPULATION_SIZES[0]:
                entry[f"members_{k}"] = {key: row[key] for key in (
                    "ms", "plain_ms", "bound_ms", "ndir", "blocks", "waves",
                    "sequential_ms", "sequential_ratio", "cudnn_shared_ms", "spread_ms",
                    "max_abs_err")}
        kernels.append(entry)
    for model_name, res in train_res.items():
        log(json.dumps({"model": model_name, "train_step_ms": res["timing"]["step_ms"],
                        "epoch_ms": res["timing"]["epoch_ms"]}))
    for model_name, res in train_bf16_res.items():
        log(json.dumps({"model": model_name, "compute_dtype": "bfloat16",
                        "train_step_ms": res["timing"]["step_ms"],
                        "epoch_ms": res["timing"]["epoch_ms"]}))
    log(json.dumps({"population": population_res}))
    busy_rows = []
    for dtype, trains, serves in (("float32", train_res, serve_res),
                                  ("bfloat16", train_bf16_res, serve_bf16_res)):
        for model_name in MODELS:  # graphed against eager: windows, busy, host shares
            rows = {"train_step": trains[model_name]["timing"]["graphed_step"],
                    **serves[model_name]["graphs"]}
            busy_rows += [r for row in rows.values() for r in row.values()]
            log(json.dumps({"graphs": {"model": model_name, "compute_dtype": dtype, **rows}}))
    log(json.dumps({"busy_rows": {
        "rows": len(busy_rows), "measured": sum(r["busy_ms"] is not None for r in busy_rows),
        "failed": sum("failed" in r for r in busy_rows)}}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
