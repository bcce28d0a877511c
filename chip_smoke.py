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
then drives forty-eight main paths at robust04 width (L = 300, seeded
random weights): serving and training in float32, serving and training
in bf16 (`<model>-serve-bf16` and `<model>-train-bf16`:
`compute_dtype="bfloat16"`, through the bf16 kernel instances only), and
population training in both (`<model>-population[-bf16]`), of
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
over K = 4 and 8 members' BiLSTM layers in one launch (ndir = 2K), f32 and
bf16, against their plain versions, K launches at ndir = 2 and cuDNN; K3'-K6'
in f32 and bf16 at the population paths' member-batched rows for K = 4
and 8 (K * E * B and K * B packed rows at dh = 64 and 16, PLECut's K * E *
B * 2 slices), and the same twelve shapes again with a dropout rate per
member (a keep threshold and a scale per row: each member at its own rate
in [0.05, 0.5], one at 0), each against its plain version, each member's
rows bit for bit against a single-rate launch at the member's rate, two
launches bit for bit, and timed against the shared-rate launch;
the `<model>-population` and `<model>-population-bf16` paths of all eight
models, `train_population` of 4 members of distinct seed, lr, weight
decay and dropout rate (the config's, 0 and two others) for one epoch,
each population step one CUDA graph (one sequential step's launches a
step for the whole population), each member held to its own graphed
sequential `Trainer` at its rate on the card, and three graphed population
steps bit for bit against three eager ones; per model and dtype, a
population of 8 members' epoch against 8 graphed sequential epochs; and
MMOECut's population of 8 at a rate per member against the same
population at one shared rate, epoch against epoch.

Every time is the median of rounds taken in turns with what it is compared
with (`rlt_tpu_torch/utils/timing.py`), printed with its spread; every
train step, the bucket-64 and bucket-256 forwards and the population's
epochs also carry the card's busy time from torch.profiler (the calls'
device records between two mark kernels, as a share of the marks' span
times the CUDA-event window, from the session of the median busy), the
host's share of the CUDA-event window of the same profiled calls, and the
profiler's stretch (that window over the window timed without it); a
session that kept fewer device records than its calls make, or than 0.9
of the fullest session of its row, is not taken,
and a row with no complete session, or busy above its profiled window,
fails the script, as does a graphed step or bucket whose busy is not
within 5% of its eager twin's. It prints a `graphs` JSON line per model and dtype (the graphed
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
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
# rows. The members of the checked path (distinct seed, lr, weight decay
# and dropout rate: None is the config's, and MOECut's preset rate is 0, so
# every path mixes 0 with rates above 0; the member of the largest lr takes
# the largest rate), and the sizes the member-batched LSTM kernels and the
# population's epoch are timed at.
POPULATION_PATHS = tuple(f"{m}-population{d}" for m in MODELS for d in ("", "-bf16"))
POPULATION_MEMBERS = ((0, 3e-5, 0.0), (1, 1e-4, 1e-3), (2, 1e-5, 5e-3), (3, 3e-4, 1e-2))
POPULATION_RATES = (None, 0.0, 0.25, 0.45)
POPULATION_SIZES = (4, 8)
# the dropout rates of K members at the member-batched kernel checks and the
# per-member timing (a regularizer search draws U(0.05, 0.5)): member m's
# rows at its own rate, one member at 0
MEMBER_RATES = {4: (0.25, 0.0, 0.05, 0.5), 8: (0.25, 0.0, 0.05, 0.1, 0.2, 0.35, 0.45, 0.5)}
# rounds of the K = 8 population epoch against the sequential epochs
# (`interleaved_ms`), fewer than REPEATS: 16 cells of epochs up to a second
POPULATION_REPEATS = 3
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
# A population member's f32 step losses against its own Trainer's, where one
# reads past STEP_LOSS_REL: the two take their products batched another way,
# and Adam turns a gradient's rounding into a step of about lr. The witness
# is the Trainer's own sensitivity to rounding: the same Trainer run again
# from its init with every weight moved one ulp up or down (`nudged`); the
# member's step losses must lie within STEP_NOISE_OF_REF of that run's
# distance from the Trainer, in L2 over the epoch's steps.
STEP_NOISE_OF_REF = 4.0
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
# rounds taken in turns with what it is compared with in the same call (a
# kernel with its library call, REPEATS; a graph with its eager twin,
# PATH_REPEATS; a population with its sequential runs, POPULATION_REPEATS),
# printed with its least and most round; a plain version, which is no
# yardstick of speed, the median of PLAIN_REPEATS single calls.
REPEATS = 7
PLAIN_REPEATS = 3
# rounds of the main paths' timings (graphed against eager, an epoch, a
# step in its parts, a forward's stages), fewer than the kernels' REPEATS
# so that the smoke keeps its time with the sixteen population paths
PATH_REPEATS = 5


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


PLAIN_TIMED = [True]  # `plain_time`'s switch (`untimed_plain`)


def plain_time(fn) -> float | None:
    """A plain version's median device ms over PLAIN_REPEATS single calls:
    it repeats the kernel's arithmetic and is no yardstick of speed, and
    some take a second a call. None inside `untimed_plain()`."""
    if not PLAIN_TIMED[0]:
        return None
    return cuda_ms(fn, iters=1, repeats=PLAIN_REPEATS)


@contextlib.contextmanager
def untimed_plain():
    """Checks against the plain versions without timing them: the
    member-batched rows, whose plain versions' times say nothing the main
    rows' do not and take the most of the smoke's seconds there."""
    PLAIN_TIMED[0] = False
    try:
        yield
    finally:
        PLAIN_TIMED[0] = True


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


class CardDraws:
    """A stand-in for the checks' numpy generator whose normal() draws on
    the card from a seeded torch generator and hands back a host array: the
    member-batched checks' inputs reach 116 M values a tensor, which numpy
    draws in seconds. Every other draw is numpy's, on a generator of the
    same seed."""

    def __init__(self, seed: int, dev):
        self.dev = dev
        self.card = torch.Generator(device=dev).manual_seed(seed)
        self.host = np.random.default_rng(seed)

    def normal(self, size) -> np.ndarray:
        return torch.randn(size, generator=self.card, device=self.dev).cpu().numpy()

    def __getattr__(self, name: str):
        return getattr(self.host, name)


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


def check_lstm_members(dev, rng, bf16: bool = False) -> dict:
    """K1' and K2' member-batched, as the population runs them: K members'
    BiLSTM layers in one launch at ndir = 2K, direction 2m + s with its own
    W_hh^T, at B = 63 lists a member, K in POPULATION_SIZES; with `bf16`
    their bf16 instances on bf16 xw, W_hh^T and dho. Each against its plain
    version (K1' within LSTM_ATOL, K2' within LSTM_BWD_REL of the max abs;
    in bf16 cs and dW_hh^T so, hs and dxw within one bf16 step beyond
    that), two launches of each bit-equal, and timed in turns against K
    launches at ndir = 2 on the members' slices (`sequential_ms`, the
    population's alternative) and against cuDNN's two-direction LSTM over
    the K * B rows with ONE set of weights (`cudnn_shared_ms`: not the same
    function, so library_ms is null)."""
    from rlt_tpu_torch.ops import lstm

    dtype = torch.bfloat16 if bf16 else torch.float32
    fwd, bwd = (lstm.lstm_fwd_bf16, lstm.lstm_bwd_bf16) if bf16 else (lstm.lstm_fwd,
                                                                     lstm.lstm_bwd)
    tag = "_bf16" if bf16 else ""
    batch, out = BATCHES[0], {}
    for k in POPULATION_SIZES:
        ndir = 2 * k
        xw = torch.from_numpy(rng.normal(size=(SEQ_LEN, ndir * batch, 4 * HIDDEN))
                              .astype(np.float32)).to(dev, dtype)
        w = lstm_weights(rng, ndir, dev).to(dtype)
        dho = torch.from_numpy(rng.normal(size=(SEQ_LEN, ndir * batch, HIDDEN))
                               .astype(np.float32)).to(dev, dtype)
        hs, cs = fwd(xw, w, ndir)
        torch.cuda.synchronize()
        want_hs, want_cs = lstm.lstm_recurrence_plain(xw, w, ndir)
        hs_diff = (hs.float() - want_hs.float()).abs()
        fwd_err = max(hs_diff.max().item(), (cs - want_cs).abs().max().item())
        fwd_beyond = max((hs_diff - bf16_step(want_hs)).max().item() if bf16 else fwd_err,
                         (cs - want_cs).abs().max().item())
        require(bool(torch.isfinite(hs).all()) and fwd_beyond <= LSTM_ATOL,
                f"lstm_fwd{tag} K={k} (ndir {ndir}): max abs err {fwd_err} ({fwd_beyond} "
                f"beyond the bf16 step) > {LSTM_ATOL}")
        require(all(torch.equal(a, b) for a, b in zip((hs, cs), fwd(xw, w, ndir))),
                f"lstm_fwd{tag} K={k}: two launches on the same inputs differ")
        dxw, dw = bwd(xw, w, want_hs, want_cs, dho, ndir)
        torch.cuda.synchronize()
        want_dxw, want_dw = lstm.lstm_bwd_plain(xw, w, want_hs, want_cs, dho, ndir)
        errs = [max_errs(dxw.float(), want_dxw.float()), max_errs(dw, want_dw)]
        bwd_rel = max(e[1] for e in errs)
        if bf16:  # dxw within one bf16 step beyond LSTM_BWD_REL of its max abs
            beyond = ((dxw.float() - want_dxw.float()).abs()
                      - bf16_step(want_dxw)).max().item()
            bwd_rel = max(beyond / want_dxw.float().abs().max().item(), errs[1][1])
        require(bool(torch.isfinite(dxw).all() and torch.isfinite(dw).all())
                and bwd_rel <= LSTM_BWD_REL,
                f"lstm_bwd{tag} K={k} (ndir {ndir}): max rel err {bwd_rel} > {LSTM_BWD_REL}")
        again = bwd(xw, w, want_hs, want_cs, dho, ndir)
        require(torch.equal(dxw, again[0]) and torch.equal(dw, again[1]),
                f"lstm_bwd{tag} K={k}: two launches on the same inputs differ")
        # each member's slice at ndir = 2, contiguous, as its own run holds it
        rows = 2 * batch
        slices = [(xw[:, m * rows:(m + 1) * rows].contiguous(),
                   w[m * 2 * HIDDEN:(m + 1) * 2 * HIDDEN].contiguous(),
                   want_hs[:, m * rows:(m + 1) * rows].contiguous(),
                   want_cs[:, m * rows:(m + 1) * rows].contiguous(),
                   dho[:, m * rows:(m + 1) * rows].contiguous()) for m in range(k)]
        cudnn = torch.nn.LSTM(HIDDEN, HIDDEN, batch_first=True, bidirectional=True,
                              device=dev, dtype=dtype)
        cudnn.flatten_parameters()
        x_in = torch.from_numpy(rng.normal(size=(k * batch, SEQ_LEN, HIDDEN))
                                .astype(np.float32)).to(dev, dtype)
        with torch.no_grad():
            fwd_t = timed(lambda: fwd(xw, w, ndir),
                          sequential=lambda: [fwd(a, b, 2) for a, b, *_ in slices],
                          cudnn_shared=lambda: cudnn(x_in))
        x_in.requires_grad_()
        y, _ = cudnn(x_in)
        g_out = torch.randn_like(y)
        wrt = [x_in, *cudnn.parameters()]
        bwd_t = timed(lambda: bwd(xw, w, want_hs, want_cs, dho, ndir),
                      sequential=lambda: [bwd(*sl, 2) for sl in slices],
                      cudnn_shared=lambda: torch.autograd.grad(y, wrt, g_out,
                                                               retain_graph=True))
        fwd_plain = plain_time(lambda: lstm.lstm_recurrence_plain(xw, w, ndir))
        bwd_plain = plain_time(lambda: lstm.lstm_bwd_plain(xw, w, want_hs, want_cs, dho,
                                                           ndir))
        state = SEQ_LEN * ndir * batch * HIDDEN
        weights = ndir * HIDDEN * 4 * HIDDEN
        tc = {}
        if bf16:  # check_lstm_bf16's and check_lstm_bwd_bf16's bytes and products
            fwd_bytes = 2 * (4 * state + weights + state) + 4 * state
            fwd_bound = bound(fwd_bytes, 2 * state * 4 * HIDDEN + 10 * state)
            product = 2 * 4 * state * HIDDEN
            bwd_bytes = 2 * (2 * 4 * state + weights + 2 * state) + 4 * (state + weights)
            bwd_bound = bound(bwd_bytes,
                              2 * product + product * PEAK_F32_FLOPS / PEAK_BF16_FLOPS)
            # and their bound_tc_ms: the kernels' own products (three-part
            # h_{t-1}; the recompute and two three-part dgates products) at
            # the dense bf16 rate
            tc = {"lstm_fwd": dict(bound_tc_ms=bound(fwd_bytes, 3 * product,
                                                     PEAK_BF16_FLOPS)[0]),
                  "lstm_bwd": dict(bound_tc_ms=bound(bwd_bytes, 7 * product,
                                                     PEAK_BF16_FLOPS)[0])}
        else:
            fwd_bound = bound(4 * (4 * state + weights + 2 * state),
                              2 * state * 4 * HIDDEN + 10 * state)
            bwd_bound = bound(4 * (2 * 4 * state + 2 * weights + 3 * state),
                              3 * 2 * 4 * state * HIDDEN)
        r, blocks, waves = lstm_waves(ndir, batch)
        shape = dict(members=k, ndir=ndir, batch=batch, rows_per_block=r, blocks=blocks,
                     waves=waves, library_ms=None)
        out[k] = {
            "lstm_fwd": dict(shape, max_abs_err=fwd_err, **fwd_t, plain_ms=fwd_plain,
                             sequential_ratio=fwd_t["ms"] / fwd_t["sequential_ms"],
                             bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                             **tc.get("lstm_fwd", {})),
            "lstm_bwd": dict(shape, max_abs_err=max(e[0] for e in errs),
                             max_rel_err=bwd_rel, **bwd_t, plain_ms=bwd_plain,
                             sequential_ratio=bwd_t["ms"] / bwd_t["sequential_ms"],
                             bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                             **tc.get("lstm_bwd", {}))}
        for name, row in out[k].items():
            log(f"{name}{tag} members " + json.dumps(row))
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
        require(all(torch.equal(a, b) for a, b in zip(
            (o, lse), attention.fused_attention_packed(q, k, v, heads=heads, pack=pack))),
                f"attention_packed_fwd dh={dh} N={n}: two launches on the same inputs differ")
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


SLICE_ROWS = tuple(EXPERTS * batch for batch in BATCHES)  # PLECut's E * B rows


def check_slice_attention(dev, rng, rows: tuple = SLICE_ROWS) -> dict:
    """K3' against `attention_plain` at PLECut's shapes (n rows of 2 slices),
    rates 0 and 0.1 on the same streams (so the same keep mask), a second
    launch at rate 0.1 bit-equal to the first; at rate 0 with streams it is
    bit-equal to the call without. library_ms: f32
    scaled_dot_product_attention, with dropout_p 0.1 for the dropout row
    (its own mask)."""
    from rlt_tpu_torch.ops import attention

    n_rows, rows = rows, []
    for n in n_rows:
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
                require(all(torch.equal(a, b) for a, b in zip(
                    (o, lse), attention.attention_fwd(q, k, v, rate, streams))),
                        f"attention_fwd N={n}: two launches on the same inputs differ")
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


def check_slice_attention_bwd(dev, rng, rows: tuple = SLICE_ROWS) -> dict:
    """K4' against `attention_bwd_plain` at rates 0 and 0.1, on K3''s o and
    lse, and a second launch at rate 0.1 bit-equal to the first. The main
    times are at rate 0.1, the training path's, with library_ms the backward
    alone of f32 scaled_dot_product_attention with dropout_p 0.1; `rate_0`
    holds the times without dropout."""
    from rlt_tpu_torch.ops import attention

    n_rows, rows = rows, []
    for n in n_rows:
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
            else:
                require(all(torch.equal(a, b) for a, b in zip((o, lse), (
                    attention.attention_packed_fwd_bf16(q, k, v, heads, pack, rate,
                                                        streams)))),
                        f"attention_packed_fwd_bf16 dh={dh} N={n}: two launches on the "
                        "same inputs differ")
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


def check_slice_attention_bf16(dev, rng, rows: tuple | None = None) -> dict:
    """K3''s bf16 instance against `attention_plain` on the same bf16 q, k,
    v at PLECut's shapes, rates 0 and 0.1 on the same streams (rate 0 with
    streams bit-equal to the call without, a second launch at rate 0.1
    bit-equal to the first), and at LONG_SLICE_ROWS rows of L = LONG_L as
    res["long"]; with `rows`, at those n rows of 2 slices only.
    library_ms: bf16 scaled_dot_product_attention."""
    from rlt_tpu_torch.ops import attention

    shapes = ([(n, SEQ_LEN) for n in SLICE_ROWS] + [(LONG_SLICE_ROWS, LONG_L)]
              if rows is None else [(n, SEQ_LEN) for n in rows])
    rows = []
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
            else:
                require(all(torch.equal(a, b) for a, b in zip(
                    (o, lse), attention.attention_fwd_bf16(q, k, v, rate, streams))),
                        f"attention_fwd_bf16 N={n}: two launches on the same inputs differ")
            plain_ms = plain_time(lambda: attention.attention_plain(q, k, v, rate, streams))
            t = timed(lambda: attention.attention_fwd_bf16(q, k, v, rate, streams),
                      lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=rate))
            t.update(max_abs_err=o_err, lse_err=lse_err, plain_ms=plain_ms,
                     **bf16_attention_bound(n * SLICE_HEADS, SLICE_DH, rate > 0.0, length))
            row.update(t if rate == 0.0 else {"dropout_0.1": t})
        row["max_abs_err"] = max(row["max_abs_err"], row["dropout_0.1"]["max_abs_err"])
        log("attention_fwd_bf16 " + json.dumps(row))
        rows.append(row)
    res = {"rows": [r for r in rows if r["length"] == SEQ_LEN],
           "max_abs_err": max(r["max_abs_err"] for r in rows)}
    if rows[-1]["length"] != SEQ_LEN:
        res["long"] = rows[-1]
    return res


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


def check_slice_attention_bwd_bf16(dev, rng, rows: tuple | None = None) -> dict:
    """K4''s bf16 instance against `attention_bwd_plain` on the same bf16 q,
    k, v, do and the plain version's o and lse, at PLECut's 378 slices of its
    63-list batch (`bf16_bwd_rates`), and at LONG_SLICE_ROWS rows of L =
    LONG_L as res["long"]; with `rows`, at those n rows of 2 slices only.
    library_ms: the backward alone of bf16 scaled_dot_product_attention at
    the same dropout rate."""
    from rlt_tpu_torch.ops import attention

    shapes = (((EXPERTS * BATCHES[0], SEQ_LEN), (LONG_SLICE_ROWS, LONG_L)) if rows is None
              else [(n, SEQ_LEN) for n in rows])
    rows = []
    for n, length in shapes:
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
    res = {"rows": [r for r in rows if r["length"] == SEQ_LEN],
           "max_abs_err": max(r["max_abs_err"] for r in rows)}
    if rows[-1]["length"] != SEQ_LEN:
        res["long"] = rows[-1]
    return res


# the member-batched attention shapes of the population paths at K = 4 and
# of the K = 8 timing: K * E * B packed rows (MMOECut, MOECut) and K * B
# (AttnCut, MtAttnCut at dh = 64; Choopy, MtChoopy at dh = 16), and PLECut's
# K * E * B rows of 2 slices
MEMBER_ROWS = {k: {"experts": k * EXPERTS * BATCHES[0], "lists": k * BATCHES[0]}
               for k in POPULATION_SIZES}


def check_member_attention(dev) -> dict:
    """K3'-K6', f32 and bf16, against their plain versions at the member-
    batched shapes the population paths run (`MEMBER_ROWS`), each with its
    times, two launches bit-equal: {dtype: {kernel: {"dh_64" or "dh_16":
    (result, dropout result), or a per-slice result}}}. Both dtypes at K = 4
    (the checked paths) and K = 8 (the timed epochs): K * E * B and K * B
    rows at dh 64, K * B rows at dh 16, PLECut's K * E * B * 2 slices."""
    rng = CardDraws(190, dev)
    choopy = dict(d_model=CHOOPY_D, heads=CHOOPY_HEADS)
    rows64 = tuple(MEMBER_ROWS[k][s] for k in POPULATION_SIZES for s in ("experts", "lists"))
    rows16 = tuple(MEMBER_ROWS[k]["lists"] for k in POPULATION_SIZES)
    slices = tuple(MEMBER_ROWS[k]["experts"] for k in POPULATION_SIZES)
    f32 = {"attention_packed_fwd": {
               "dh_64": (check_attention(dev, rng, rows=rows64),
                         check_attention_dropout(dev, rng, rows=rows64)),
               "dh_16": (check_attention(dev, rng, rows=rows16, **choopy),
                         check_attention_dropout(dev, rng, rows=rows16, **choopy))},
           "attention_packed_bwd": {
               "dh_64": (check_attention_bwd(dev, rng, rows=rows64), None),
               "dh_16": (check_attention_bwd(dev, rng, rows=rows16, **choopy), None)},
           "attention_fwd": check_slice_attention(dev, rng, rows=slices),
           "attention_bwd": check_slice_attention_bwd(dev, rng, rows=slices)}
    bf16 = {"attention_packed_fwd": {
                "dh_64": (check_attention_bf16(dev, rng, rows=rows64), None),
                "dh_16": (check_attention_bf16(dev, rng, rows=rows16, **choopy), None)},
            "attention_packed_bwd": {
                "dh_64": (check_attention_bwd_bf16(dev, rng, rows=rows64), None),
                "dh_16": (check_attention_bwd_bf16(dev, rng, rows=rows16, **choopy), None)},
            "attention_fwd": check_slice_attention_bf16(dev, rng, rows=slices),
            "attention_bwd": check_slice_attention_bwd_bf16(dev, rng, rows=slices)}
    return {"float32": f32, "bfloat16": bf16}


MEMBER_KEYS = ("ms", "plain_ms", "library_ms", "library_ratio", "spread_ms", "bound_ms",
               "bound_tc_ms", "bound_by", "bound_term", "hash_floor_ms", "max_abs_err",
               "max_rel_err")


def member_max_err(res: dict) -> float:
    if "rows" in res:
        return res["max_abs_err"]
    return max(r["max_abs_err"] for main, drop in res.values()
               for r in (main, drop) if r is not None)


def member_entry(res: dict, keys: tuple) -> dict:
    """The kernels line's `members` sub-entry of an attention kernel: its
    rows at the member-batched shapes (`check_member_attention`), `n_<N>`
    for the packed kernels by head width, `slices_<S>` for the per-slice
    ones, each with its other rate."""
    def pick(r):
        out = {k: r[k] for k in keys if k in r}
        for variant in ("dropout_0.1", "rate_0"):
            if variant in r:
                out[variant] = {k: r[variant][k] for k in keys if k in r[variant]}
        return out

    if "rows" in res:  # per-slice
        return {f"slices_{r['n'] * SLICE_HEADS}": pick(r) for r in res["rows"]}
    entry = {}
    for width, (main, drop) in res.items():
        entry[width] = {f"n_{r['n']}": pick(r) for r in main["rows"]}
        for r in (drop or {}).get("rows", ()):
            entry[width][f"n_{r['n']}"]["dropout_0.1"] = pick(r)
    return entry


def member_rate_case(dev, gen, dtype, kind: str, dh: int, k: int, n: int) -> dict:
    """One instance of K3'-K6' at a dropout rate per member (`MEMBER_RATES`,
    a `RowDropout` over each member's n / k rows, or PLECut's 2 n / k slices):
    the forward and the backward against their plain versions on the same
    per-row rates and streams (f32 to ATTN_ATOL and ATTN_BWD_REL, bf16 by
    `bf16_o_check` and `bf16_grads_check`), member m's rows bit for bit
    against a launch over its rows alone at its own rate (the member at 0
    against the rate-0 launch), two launches bit for bit, and both timed
    against the shared-rate launch at RATE (`shared_ms`)."""
    from rlt_tpu_torch.ops import attention as A

    bf16 = dtype == torch.bfloat16
    suffix = "_bf16" if bf16 else ""
    if kind == "packed":
        heads, d = (HEADS, D_MODEL) if dh == 64 else (CHOOPY_HEADS, CHOOPY_D)
        pack = A.packed_group_size(d, heads)
        shape, n_streams, pairs = (n, SEQ_LEN, d), n, n * heads
        fwd_k, bwd_k = (getattr(A, f"attention_packed_{p}{suffix}") for p in ("fwd", "bwd"))

        def fwd(q, k_, v, rate, s):
            return fwd_k(q, k_, v, heads, pack, rate, s)

        def bwd(q, k_, v, o, lse, do, rate, s):
            return bwd_k(q, k_, v, o, lse, do, heads, pack, rate, s)

        def plain(q, k_, v, do, o, lse, rate, s):
            return (A.attention_packed_plain(q, k_, v, heads, pack, rate, s),
                    A.attention_packed_bwd_plain(q, k_, v, o, lse, do, heads, pack, rate, s))
    else:
        shape, n_streams, pairs = (n, SLICE_HEADS, SEQ_LEN, SLICE_DH), n * SLICE_HEADS, \
            n * SLICE_HEADS
        fwd, bwd = getattr(A, f"attention_fwd{suffix}"), getattr(A, f"attention_bwd{suffix}")

        def plain(q, k_, v, do, o, lse, rate, s):
            return (A.attention_plain(q, k_, v, rate, s),
                    A.attention_bwd_plain(q, k_, v, o, lse, do, rate, s))
    name = f"{'attention_packed' if kind == 'packed' else 'attention'}{suffix} dh={dh} " \
        f"N={n} K={k} member rates"
    q, k_, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4))
    streams = torch.randint(-2**31, 2**31 - 1, (n_streams,), generator=gen, device=dev,
                            dtype=torch.int64).to(torch.int32)
    rates = MEMBER_RATES[k]
    rows = A.row_dropout(rates, dev).repeat(n_streams // k)
    o, lse = fwd(q, k_, v, rows, streams)
    grads = bwd(q, k_, v, o, lse, do, rows, streams)
    torch.cuda.synchronize()
    again = (*fwd(q, k_, v, rows, streams), *bwd(q, k_, v, o, lse, do, rows, streams))
    require(all(torch.equal(a, b) for a, b in zip((o, lse, *grads), again)),
            f"{name}: two launches on the same inputs differ")
    del again
    per, per_s = n // k, n_streams // k
    for m, rate in enumerate(rates):
        b, s = slice(m * per, (m + 1) * per), slice(m * per_s, (m + 1) * per_s)
        lse_m = lse[b] if kind == "packed" else lse[s]
        got = fwd(q[b], k_[b], v[b], rate, streams[s])
        got += bwd(q[b], k_[b], v[b], o[b], lse_m, do[b], rate, streams[s])
        require(all(torch.equal(a, w) for a, w in zip(got, (o[b], lse_m, *(g[b] for g in grads)))),
                f"{name}: member {m}'s rows differ from a launch at its rate {rate} alone")
    (want_o, want_lse), want_g = plain(q, k_, v, do, o, lse, rows, streams)
    if bf16:
        o_err, lse_err = bf16_o_check(name, o, lse, want_o, want_lse)
        g_err = bf16_grads_check(name, grads, want_g)
        row = dict(max_abs_err=max(o_err, g_err), lse_err=lse_err)
    else:
        require(all(bool(torch.isfinite(t).all()) for t in (o, lse, *grads)),
                f"{name}: non-finite")
        o_err = max((o - want_o).abs().max().item(), (lse - want_lse).abs().max().item())
        g_errs = [max_errs(g, w) for g, w in zip(grads, want_g)]
        g_rel = max(e[1] for e in g_errs)
        require(o_err <= ATTN_ATOL, f"{name}: o/lse max abs err {o_err} > {ATTN_ATOL}")
        require(g_rel <= ATTN_BWD_REL, f"{name}: grads max rel err {g_rel} > {ATTN_BWD_REL}")
        row = dict(max_abs_err=max(o_err, max(e[0] for e in g_errs)), max_rel_err=g_rel)
    del want_o, want_lse, want_g
    elem = 2 if bf16 else 4
    elems = pairs * SEQ_LEN * dh
    # streams, thresholds and scales: 12 bytes a row (or slice)
    f_bytes = elem * 4 * elems + 4 * pairs * SEQ_LEN + 12 * n_streams
    b_bytes = elem * 8 * elems + 4 * pairs * SEQ_LEN + 12 * n_streams
    bound = ((lambda nbytes, flops: score_bound(nbytes, flops, pairs * SEQ_LEN * SEQ_LEN,
                                                True)) if bf16 else bounds)
    tf = timed(lambda: fwd(q, k_, v, rows, streams),
               shared=lambda: fwd(q, k_, v, RATE, streams))
    tb = timed(lambda: bwd(q, k_, v, o, lse, do, rows, streams),
               shared=lambda: bwd(q, k_, v, o, lse, do, RATE, streams))
    row.update(n=n, k=k, dh=dh, rates=list(rates), bit_equal_members=True,
               fwd=dict(tf, per_row_over_shared=tf["ms"] / tf["shared_ms"],
                        **bound(f_bytes, 4 * elems * SEQ_LEN)),
               bwd=dict(tb, per_row_over_shared=tb["ms"] / tb["shared_ms"],
                        **bound(b_bytes, 10 * elems * SEQ_LEN)))
    log("member rates " + json.dumps({"kernel": name, **row}))
    return row


def check_member_rates(dev) -> dict:
    """K3'-K6' with a dropout rate per member at the member-batched shapes
    of `check_member_attention`, every instance (`member_rate_case`): f32
    and bf16 at dh 64 (K * E * B and K * B rows), dh 16 (K * B rows) and
    PLECut's dh 128 (K * E * B * 2 slices), K = 4 and 8: {dtype: {kernel
    pair: [rows]}}."""
    gen = torch.Generator(device=dev).manual_seed(200)
    out = {}
    for dtype, tag in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        out[tag] = {"attention_packed": [], "attention": []}
        for k in POPULATION_SIZES:
            cases = ([("packed", 64, MEMBER_ROWS[k][s]) for s in ("experts", "lists")]
                     + [("packed", 16, MEMBER_ROWS[k]["lists"]),
                        ("slices", SLICE_DH, MEMBER_ROWS[k]["experts"])])
            for kind, dh, n in cases:
                key = "attention_packed" if kind == "packed" else "attention"
                out[tag][key].append(member_rate_case(dev, gen, dtype, kind, dh, k, n))
                free_card()
    return out


def member_rate_entry(rows: list, direction: str) -> dict:
    """The kernels line's `member_rates` sub-entry of one kernel: its
    per-row-rate rows by head width, rows and K (`check_member_rates`)."""
    keys = ("ms", "shared_ms", "per_row_over_shared", "spread_ms", "bound_ms", "bound_by",
            "bound_tc_ms", "bound_term", "hash_floor_ms")
    return {f"dh_{r['dh']}_n_{r['n']}_k_{r['k']}": dict(
        {key: r[direction][key] for key in keys if key in r[direction]},
        max_abs_err=r["max_abs_err"], rates=r["rates"],
        bit_equal_members=r["bit_equal_members"]) for r in rows}


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
        t = graphed_against_eager(f"{label} bucket {b}", lambda: predictor._forward(x),
                                  lambda: eager._forward(x), 3, with_busy=b in (64, 256))
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


GRAPH_CHECK_STEPS = 3
BUSY_REL = 0.05  # a graph replays the eager step's device work: its busy ms within 5%
# A graph replays at least the device work of its eager twin: a graphed
# session holding fewer than this share of the eager session's device
# records a call lost some (`device_busy`'s short sessions).
RECORDS_OF_EAGER = 0.9


def graphed_against_eager(label: str, graphed, eager, iters: int, with_busy: bool = True,
                          busy_calls: int = 3) -> dict:
    """The window of `graphed` (a graph replay) and of `eager` (the same work
    issued op by op) in turns (`interleaved_ms`, the order reversed in odd
    rounds), each with its spread and, with `with_busy`, the card's busy ms
    over `busy_calls` profiled calls (`device_busy`), the host share of the
    profiled window of the same session and the profiler's stretch
    (`busy_row`). A graphed session must keep RECORDS_OF_EAGER of the eager
    session's device records a call; a row whose sessions were all short,
    or whose busy reads above its profiled window, fails; and the graphed
    busy must lie within BUSY_REL of the eager busy, since the graph
    replays the same device work."""
    from rlt_tpu_torch.utils.timing import busy_row, device_busy, interleaved_ms

    t = interleaved_ms({"graphed": graphed, "eager": eager}, iters, PATH_REPEATS,
                       alternate=True)
    out = {name: {"window_ms": t[name]["median"],
                  "spread_ms": [t[name]["min"], t[name]["max"]]}
           for name in ("graphed", "eager")}
    if not with_busy:
        return out
    eager_busy = device_busy(eager, busy_calls)
    records = eager_busy["records"]
    graphed_busy = device_busy(graphed, busy_calls, min_records=(
        None if records is None else RECORDS_OF_EAGER * records))
    for name, busy in (("graphed", graphed_busy), ("eager", eager_busy)):
        out[name].update(busy_row(busy, t[name]["median"]))
        require("failed" not in out[name], f"{label} {name}: busy row failed: "
                f"{json.dumps(out[name])}")
    busy = [out[name]["busy_ms"] for name in ("graphed", "eager")]
    require(abs(busy[0] - busy[1]) <= BUSY_REL * busy[1],
            f"{label}: the graphed busy {busy[0]} ms is not within {BUSY_REL:.0%} of the "
            f"eager busy {busy[1]} ms")
    out["busy_ratio"] = busy[0] / busy[1]
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
    out = graphed_against_eager(f"{label} train step",
                                lambda: graphed.train_batch(idx[0], valid[0]),
                                lambda: eager.train_batch(idx[0], valid[0]), 2,
                                busy_calls=5)
    log(f"{label}: {GRAPH_CHECK_STEPS} graphed steps equal the eager ones bit for bit "
        f"(results, gradients, parameters, Adam's state; dropout {cfg.dropout}), and a "
        f"test batch; one eager step's launches a replay; a replay inside plain_ops() "
        f"raises; step {json.dumps(out)}")
    return out


def epoch_timing(trainer) -> dict:
    """Device ms of one more epoch of `trainer` (its train steps and test
    batches): the median, least and most of PATH_REPEATS epochs."""
    from rlt_tpu_torch.utils.timing import interleaved_ms

    return interleaved_ms({"epoch": trainer.run_epoch}, 1, PATH_REPEATS)["epoch"]


def free_card() -> None:
    """Give the card back what the last path's trainers, populations and
    graph pools held."""
    gc.collect()
    torch.cuda.empty_cache()


def population_config(model_name: str, compute_dtype: str = "float32"):
    """A population's config: `model_name`'s drmm_tks preset (B = 63) at
    robust04 width, one epoch, in `compute_dtype`, dropout on (the preset's
    rate, or RATE where the preset has none: MOECut's)."""
    from rlt_tpu_torch.config import TrainConfig, apply_preset

    cfg = apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04",
                                   compute_dtype=compute_dtype))
    cfg = dataclasses.replace(cfg, epochs=1, dropout=cfg.dropout or RATE)
    require((cfg.batch_size, cfg.seq_len) == (63, SEQ_LEN) and cfg.dropout > 0.0,
            f"drmm_tks preset with dropout on: {cfg}")
    return cfg


def population_members(k: int, rates=None):
    """k members of seeds 0..k-1 with POPULATION_MEMBERS' lr and weight decay
    in turn (the first four are POPULATION_MEMBERS), at the config's dropout
    rate or, with `rates`, member i at rates[i] (None: the config's)."""
    from rlt_tpu_torch.population import Member

    return [Member(seed=i, lr=POPULATION_MEMBERS[i % len(POPULATION_MEMBERS)][1],
                   weight_decay=POPULATION_MEMBERS[i % len(POPULATION_MEMBERS)][2],
                   dropout=None if rates is None else rates[i])
            for i in range(k)]


def population_step_check(cfg, members, label: str, bf16: bool) -> None:
    """A fresh graphed population (the default on the card) against a fresh
    eager one (`graphs=False`) of the same members, dropout on:
    GRAPH_CHECK_STEPS steps of the same plans, every step's (K, 3) results,
    then the gradients, parameters, MemberAdam's moments and step count and
    a test batch bit for bit; each step, graphed and eager, launches what
    one sequential step launches, whatever K is; a replay inside
    plain_ops() raises."""
    from rlt_tpu_torch.population import Population

    graphed, eager = (Population(cfg, members, device="cuda", graphs=g) for g in (True, False))
    require(graphed.graphs and not eager.graphs, f"{label}: graphed and eager populations")
    plans = [p.plans("train") for p in (graphed, eager)]
    require(all(torch.equal(a, b) for a, b in zip(*plans)), f"{label}: plans differ")
    idx, valid = plans[0]
    want = want_counts(cfg.model_name, forwards=0, steps=1, bf16=bf16)
    for s in range(GRAPH_CHECK_STEPS):
        results = []
        for p in (graphed, eager):
            before = read_counts()
            out = p.train_batch(idx[:, s], valid[:, s])
            torch.cuda.synchronize()
            launches = {k: n - before[k] for k, n in read_counts().items()}
            route = "graphed" if p.graphs else "eager"
            require(launches == want, f"{label} step {s + 1} ({route}, {len(members)} "
                    f"members): launched {launches}, one sequential step launches {want}")
            results.append(out)
        require(torch.equal(*results), f"{label} step {s + 1}: graphed (loss, f1, dcg) "
                f"{results[0].tolist()} against eager {results[1].tolist()}")
    differ = []
    for (name, p), q in zip(graphed.model.named_parameters(), eager.model.parameters()):
        pairs = [("param", p, q), ("grad", p.grad, q.grad)] + [
            (f"adam {k}", v, eager.optimizer.state[q][k])
            for k, v in graphed.optimizer.state[p].items()]
        differ += [f"{name} {what}: max abs {(a.float() - b.float()).abs().max().item()}"
                   for what, a, b in pairs if not torch.equal(a, b)]
    require(not differ, f"{label}: after {GRAPH_CHECK_STEPS} steps the graphed population "
            f"differs from the eager one: {differ[:8]}")
    te = [p.plans("test") for p in (graphed, eager)]
    require(torch.equal(graphed.test_batch(te[0][0][:, 0], te[0][1][:, 0]),
                        eager.test_batch(te[1][0][:, 0], te[1][1][:, 0])),
            f"{label}: a graphed test batch differs from the eager one")
    require(refuses_in_plain_ops(lambda: graphed.train_batch(idx[:, 0], valid[:, 0])),
            f"{label}: a population replay inside plain_ops() did not raise")


def nudged(state: dict, seed: int) -> dict:
    """`state` with every floating-point element moved one ulp up or down
    (a seeded coin each)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in state.items():
        if t.is_floating_point():
            up = torch.rand(t.shape, generator=g) < 0.5
            t = torch.nextafter(t, torch.where(up, math.inf, -math.inf).to(t.dtype))
        out[name] = t
    return out


def nudged_run(cfg, init: dict, seed: int) -> np.ndarray:
    """The step losses of one graphed epoch of a `Trainer` of `cfg` from
    `init` nudged one ulp (`nudged`): its generator, plans and dropout bits
    are the unnudged Trainer's."""
    from rlt_tpu_torch.train import Trainer

    trainer = Trainer(cfg, device="cuda", state_dict=nudged(init, seed))
    trainer.run()
    return np.asarray(trainer.history[0]["train_loss_steps"])


def population_end_to_end(model_name: str, compute_dtype: str, f32_runs: dict) -> dict:
    """Population training's main path for `model_name` in `compute_dtype`:
    `train_population` of the POPULATION_MEMBERS (distinct seed, lr, weight
    decay and dropout rate, POPULATION_RATES: each attention row at its
    member's rate) at robust04 width, one epoch, each population step one
    CUDA graph. It must launch each kernel as often as one sequential epoch
    does, whatever K is (2 K1' at ndir = 2K, 2 K2' and the attention pair
    once per encoder layer over every member's rows a step). Then each
    member against its own graphed sequential `Trainer` at its rate (the
    same weights, corpus, plans and dropout bits, products batched another
    way): in float32 every step loss within STEP_LOSS_REL (or, past it,
    the step losses within STEP_NOISE_OF_REF of the Trainer's own distance
    from its nudged init, `nudged_run`) and the epoch's updates within
    UPDATE_REL in L2, leaving out what
    train_end_to_end leaves out and the rows of ZERO_GRAD_ROWS; in bf16 by
    the bf16 training lane's rule (`train_end_to_end_bf16`) against d_ref,
    the member's sequential float32 run (`f32_runs`, filled by the float32
    path) against its bf16 one: the updates over all leaves within
    BF16_UPDATE_OF_REF of d_ref's in L2, and the step losses within
    BF16_MAX_OF_REF of d_ref's plus one bf16 step of each loss, in L2 over
    the epoch's steps (one step's d_ref may be near 0 by chance). Last,
    the graphed population step against the eager one
    (`population_step_check`)."""
    from rlt_tpu_torch.models import ZERO_GRAD_LEAVES, build_model
    from rlt_tpu_torch.population import member_config, train_population
    from rlt_tpu_torch.train import Trainer

    bf16 = compute_dtype == "bfloat16"
    label = f"{model_name}-population" + ("-bf16" if bf16 else "")
    cfg = population_config(model_name, compute_dtype)
    members = population_members(POPULATION_SIZES[0], POPULATION_RATES)
    rates = [member_config(cfg, m).dropout for m in members]
    require(len(set(rates)) == len(rates) and 0.0 in rates and cfg.dropout in rates,
            f"{label}: member rates {rates}")
    torch.cuda.synchronize()
    reset_counts()  # the population path's counts start here
    t0 = time.perf_counter()
    out = train_population(cfg, members, track_best_params=True, device="cuda")
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = read_counts()
    zero = set(ZERO_GRAD_LEAVES[model_name])
    worst, worst_update, witness = 0.0, {}, {}
    l2 = np.linalg.norm
    for m, (member, row) in enumerate(zip(members, out["per_member"])):
        trainer = Trainer(member_config(cfg, member), device="cuda")
        if m == 0:
            steps, tests = trainer.data.train_batches, trainer.data.test_batches
            want = want_counts(model_name, forwards=tests, steps=steps, bf16=bf16)
            require(launches == want, f"kernel launches on the {label} path: {launches}, "
                    f"want {want} ({steps} steps, {tests} test batches)")
            require(row["compute_dtype"] == compute_dtype, f"{label}: summary {row}")
        trainer.run()
        seq = np.asarray(trainer.history[0]["train_loss_steps"])
        got = np.asarray(row["history"][0]["train_loss_steps"])
        require(len(got) == len(seq) == steps and np.all(np.isfinite(got)),
                f"{label} member {m}: step losses {got.tolist()}")
        init = build_model(model_name, seq_len=cfg.seq_len, input_size=cfg.input_size,
                           dropout=cfg.dropout, num_tasks=cfg.num_tasks,
                           seed=member.seed).state_dict()
        final = {k: v.detach() for k, v in trainer.model.state_dict().items()}
        moves = {}
        for name, value in final.items():
            require(bool(torch.isfinite(out["best_state"][name][m]).all()),
                    f"{label} member {m}: non-finite {name}")
            if name not in zero:
                moves[name] = [without_zero_rows(model_name, name, t.cpu() - init[name])
                               for t in (out["best_state"][name][m], value)]
        if not bf16:
            f32_runs[(model_name, m)] = (seq, {n: mv[1] for n, mv in moves.items()})
            step_rel = np.abs(got - seq) / np.abs(seq)
            if not np.all(step_rel <= STEP_LOSS_REL):
                noise = nudged_run(member_config(cfg, member), init, member.seed)
                gap, limit = l2(got - seq), STEP_NOISE_OF_REF * l2(noise - seq)
                witness[f"member_{m}"] = {"rel": step_rel.tolist(), "l2": gap,
                                          "nudged_l2": limit / STEP_NOISE_OF_REF}
                require(gap <= limit, f"{label} member {m}: step losses {got.tolist()} vs "
                        f"its Trainer's {seq.tolist()}: rel err {step_rel.tolist()} > "
                        f"{STEP_LOSS_REL}, and L2 {gap} > {STEP_NOISE_OF_REF} x the Trainer "
                        f"from its nudged init ({noise.tolist()}: {limit / STEP_NOISE_OF_REF})")
            update_rel = {n: ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                          for n, (a, b) in moves.items()}
            name = max(update_rel, key=update_rel.get)
            require(update_rel[name] <= UPDATE_REL, f"{label} member {m}: updates over "
                    f"{UPDATE_REL} (L2 rel err) against its Trainer: {worst_of(update_rel)}")
            worst = max(worst, float(step_rel.max()))
            worst_update[f"member_{m}"] = [name, update_rel[name]]
            continue
        seq32, moves32 = f32_runs[(model_name, m)]
        step_limit = (BF16_MAX_OF_REF * l2(seq - seq32)
                      + l2(bf16_step(torch.from_numpy(seq)).numpy()))
        require(l2(got - seq) <= step_limit, f"{label} member {m}: step losses "
                f"{got.tolist()} vs its bf16 Trainer's {seq.tolist()} (f32 {seq32.tolist()}):"
                f" L2 {l2(got - seq)} > {step_limit}")
        err2 = sum((a - b).double().pow(2).sum().item() for a, b in moves.values())
        ref2 = sum((b - moves32[n]).double().pow(2).sum().item() for n, (_, b) in moves.items())
        ratio = (err2 / max(ref2, 1e-300)) ** 0.5
        require(ratio <= BF16_UPDATE_OF_REF, f"{label} member {m}: updates part from its "
                f"bf16 Trainer's by {ratio} of d_ref's (L2, limit {BF16_UPDATE_OF_REF})")
        worst = max(worst, l2(got - seq) / step_limit)
        worst_update[f"member_{m}"] = ratio
    population_step_check(cfg, members, label, bf16)
    log(f"{label}: {len(members)} members {json.dumps(POPULATION_MEMBERS)} at dropout "
        f"rates {json.dumps(rates)}, first epoch "
        f"{epoch_s:.3f} s (captures included); against each member's graphed Trainer: "
        + (f"step losses max rel err {worst:.3e}, worst update (L2 rel err) "
           if not bf16 else f"step losses L2 at {worst:.3f} of their limit, updates (L2 "
           "over d_ref's) ") + f"{json.dumps(worst_update)}; "
        + (f"past {STEP_LOSS_REL} and held to the nudged Trainer: {json.dumps(witness)}; "
           if witness else "") + f"{GRAPH_CHECK_STEPS} graphed "
        f"population steps equal the eager ones bit for bit, one sequential step's "
        f"launches each; summaries "
        f"{json.dumps([{k: r[k] for k in ('best_f1', 'best_dcg')} for r in out['per_member']])}")
    return launches


def population_timing(model_name: str, compute_dtype: str) -> dict:
    """A population of K = POPULATION_SIZES[-1] members (`population_members`)
    of `model_name` in `compute_dtype` against the same K members as graphed
    sequential `Trainer`s, one epoch each a round, in turns
    (`interleaved_ms`): epoch ms as medians with their spread, lists/s
    (every member's train and test lists over the epoch's time), and each
    one's busy ms and host share (`device_busy`, one profiled epoch a
    session). MMOECut in float32 runs K real Trainers; every other model
    and dtype one Trainer (the first member's) whose epoch is timed and
    counted K times (`sequential_from_one`): the members differ only in
    seed, lr and weight decay, which move no kernel's work."""
    from rlt_tpu_torch.population import Population, member_config
    from rlt_tpu_torch.train import Trainer
    from rlt_tpu_torch.utils.timing import busy_row, device_busy, interleaved_ms

    cfg, k = population_config(model_name, compute_dtype), POPULATION_SIZES[-1]
    members = population_members(k)
    pop = Population(cfg, members, device="cuda")
    every = model_name == "mmoecut" and compute_dtype == "float32"
    trainers = [Trainer(member_config(cfg, m), device="cuda")
                for m in (members if every else members[:1])]
    times = 1 if every else k

    def sequential():
        for trainer in trainers:
            trainer.run_epoch()

    t = interleaved_ms({"population": pop.run_epoch, "sequential": sequential}, 1,
                       repeats=POPULATION_REPEATS)
    lists = k * (trainers[0].data.n_train + trainers[0].data.n_test)
    out = {"model": model_name, "compute_dtype": compute_dtype, "members": k,
           "lists_per_epoch": lists, "sequential_from_one": not every}
    for name, fn in (("population", pop.run_epoch), ("sequential", sequential)):
        n = times if name == "sequential" else 1
        row = busy_row(device_busy(fn, calls=1, warmup=0), t[name]["median"])
        for key in ("busy_ms", "profiled_ms"):
            if row[key] is not None:
                row[key] *= n
        out[name] = dict(epoch_ms=t[name]["median"] * n,
                         epoch_spread=[t[name]["min"] * n, t[name]["max"] * n],
                         lists_per_s=lists / (t[name]["median"] * n) * 1e3, **row)
    out["speedup"] = out["sequential"]["epoch_ms"] / out["population"]["epoch_ms"]
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("population timing " + json.dumps(out))
    return out


def member_rate_timing(compute_dtype: str) -> dict:
    """MMOECut's population of K = POPULATION_SIZES[-1] members at a dropout
    rate per member (MEMBER_RATES: K3'-K6''s per-row form, and each other
    dropout site's per-member scale) against the same members at the
    config's one rate, one epoch each a round, in turns (`interleaved_ms`),
    each with its busy ms and host share."""
    from rlt_tpu_torch.population import Population
    from rlt_tpu_torch.utils.timing import busy_row, device_busy, interleaved_ms

    cfg, k = population_config("mmoecut", compute_dtype), POPULATION_SIZES[-1]
    pops = {"per_member": Population(cfg, population_members(k, MEMBER_RATES[k]),
                                     device="cuda"),
            "shared": Population(cfg, population_members(k), device="cuda")}
    t = interleaved_ms({name: p.run_epoch for name, p in pops.items()}, 1,
                       repeats=POPULATION_REPEATS)
    out = {"model": "mmoecut", "compute_dtype": compute_dtype, "members": k,
           "rates": list(MEMBER_RATES[k]), "shared_rate": cfg.dropout}
    for name, p in pops.items():
        out[name] = dict(epoch_ms=t[name]["median"],
                         epoch_spread=[t[name]["min"], t[name]["max"]],
                         **busy_row(device_busy(p.run_epoch, calls=1, warmup=0),
                                    t[name]["median"]))
    out["per_member_over_shared"] = out["per_member"]["epoch_ms"] / out["shared"]["epoch_ms"]
    log("member rate timing " + json.dumps(out))
    return out


# Rows of a leaf whose gradient is zero by algebra, beside ZERO_GRAD_LEAVES's
# whole leaves: PLECut's expert 2 feeds only the rerank and cut towers, both
# softmaxes over positions, which cancel the shift its last LayerNorm's bias
# adds to every position (experts 0 and 1 also feed the class tower's
# sigmoid). Adam moves that rounding noise by about lr either way.
ZERO_GRAD_ROWS = {"mtple": {"experts.attention_layer.layers_0.norm2.bias": 2}}


def without_zero_rows(model_name: str, name: str, t: torch.Tensor) -> torch.Tensor:
    """A member's (E, ...) leaf without its elements whose gradient is zero by
    algebra: the key block of an in_proj_bias (`without_key_bias`) and the
    expert rows of ZERO_GRAD_ROWS."""
    t = without_key_bias(name, t)
    row = ZERO_GRAD_ROWS.get(model_name, {}).get(name)
    return t if row is None else torch.cat([t[:row], t[row + 1:]])


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
    update: the step's median over PATH_REPEATS rounds of `iters` steps
    between CUDA events (`interleaved_ms`) with its least and most round, each
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

    t = interleaved_ms({"step": step}, iters, PATH_REPEATS)["step"]
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
                        "gates_towers": lambda: model.heads(experts_in, experts_o)},
                       iters, PATH_REPEATS)
    return {name: r["median"] for name, r in t.items()}


# ---------------------------------------------------------------------------
# Phase 9: the harness paths (verify_probe, verify_bmt, --resume)
# ---------------------------------------------------------------------------

# ProbeBase's packed attention rows: its two experts stacked over the B = 63
# lists of the probe_base preset
PROBE_ROWS = 2 * BATCHES[0]
HARNESS_PATHS = ("probe_base-verify", "attncut-verify_bmt", "choopy-verify_bmt",
                 "mmoecut-resume", "mmoecut-resume-bf16")
ALL_PATHS = PATHS + BF16_PATHS + BF16_TRAIN_PATHS + POPULATION_PATHS + HARNESS_PATHS
# the epochs of each phase on the probe path, and of the resume path's two
# runs against one uninterrupted run
PROBE_EPOCHS = 2
RESUME_EPOCHS = (3, 2)
# verify_bmt's CLI defaults (rlt_tpu/verify_bmt.py:156-168), and its epochs here
BMT_BATCH, BMT_LR, BMT_WEIGHT_DECAY, BMT_EPOCHS = 20, 3e-5, 0.0015, 2
PNG = b"\x89PNG\r\n\x1a\n"


def kernel_counts(bf16: bool = False, **launches) -> dict:
    """Every kernel's count 0 but `launches` (f32 names; with `bf16`, of
    their bf16 instances)."""
    from rlt_tpu_torch.ops import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    want.update({BF16_OF[k] if bf16 else k: n for k, n in launches.items()})
    return want


def step_launches(fn) -> tuple:
    """fn()'s result, synchronised, and the launches it made."""
    before = read_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in read_counts().items()}


def same_training_state(label: str, pairs) -> None:
    """Each (module, optimizer) pair of two runs: parameters and the
    optimizer's state bit for bit."""
    differ = []
    for (m1, o1), (m2, o2) in pairs:
        for (name, p), q in zip(m1.named_parameters(), m2.parameters()):
            # .get: the optimizers' state is a defaultdict, which a lookup
            # of a parameter that has taken no step would fill
            tensors = [("param", p, q)] + [(f"adam {k}", v, o2.state.get(q, {}).get(k))
                                           for k, v in o1.state.get(p, {}).items()]
            differ += [f"{name} {what}: " + ("missing" if b is None else
                                            f"max abs {(a.float() - b.float()).abs().max()}")
                       for what, a, b in tensors if b is None or not torch.equal(a, b)]
            if len(o1.state.get(p, {})) != len(o2.state.get(q, {})):
                differ.append(f"{name}: optimizer state keys differ")
    require(not differ, f"{label}: {differ[:8]}")


def probe_config(save_path: str):
    from rlt_tpu_torch.config import TrainConfig, apply_preset

    cfg = apply_preset(TrainConfig(model_name="probe_base", retrieve_data="robust04"))
    require((cfg.batch_size, cfg.seq_len, cfg.input_size, cfg.dropout) == (63, SEQ_LEN, 3, 0.1),
            f"probe_base preset at robust04 width: {cfg}")
    return dataclasses.replace(cfg, save_path=save_path)


def probe_end_to_end(workdir: str) -> dict:
    """`probe_base-verify`: verify_probe's ProbeTrainer at the probe_base
    preset (B = 63, L = 300, F = 3, BiLSTM H = 128, 2 experts of d_model
    256 with 4 heads of dh 64, FFN 2048, dropout 0.1), PROBE_EPOCHS epochs
    of each phase, every step one graph, through K1'/K2' (ndir 2) and
    K5'/K6' over N = PROBE_ROWS rows. Before it, a graphed ProbeTrainer
    against an eager one from the same seed: three base steps (dropout on)
    and three probe steps bit for bit, the base's test batch too, each
    replay launching what an eager step does, and the steps timed graphed
    against eager with their busy ms and host share. After it, phase 1
    again through the plain versions on the card (the same weights, plans
    and masks): every step loss within STEP_LOSS_REL. The probes' AUCs lie
    in [0, 1] and their rerank DCGs within +-sum 1/log2(i+2)."""
    from rlt_tpu_torch.ops import plain_ops
    from rlt_tpu_torch.verify_probe import ProbeTrainer

    cfg = probe_config(workdir)
    graphed, eager = (ProbeTrainer(cfg, device="cuda", graphs=g) for g in (True, False))
    idx, valid = graphed.data.plan(graphed.generator, "train")
    eager.data.plan(eager.generator, "train")
    steps = {}
    for what, call in (("base", lambda t, s: t.base_batch("train", idx[s], valid[s])),
                       ("probe", lambda t, s: t.probe_batch(idx[s], valid[s]))):
        for s in range(GRAPH_CHECK_STEPS):
            (got, n_got), (want, n_want) = (step_launches(lambda t=t: call(t, s))
                                            for t in (graphed, eager))
            require(n_got == n_want, f"probe_base {what} step {s + 1}: a replay launched "
                    f"{n_got}, the eager step {n_want}")
            require(torch.equal(got, want), f"probe_base {what} step {s + 1}: graphed "
                    f"{got.tolist()} against eager {want.tolist()}")
            steps[what] = n_got
        same_training_state(f"probe_base after {GRAPH_CHECK_STEPS} {what} steps", [
            ((graphed.base, graphed.base_optimizer), (eager.base, eager.base_optimizer)),
            ((graphed.probe, graphed.probe_optimizer), (eager.probe, eager.probe_optimizer))])
    te_idx, te_valid = graphed.data.plan(graphed.generator, "test")
    eager.data.plan(eager.generator, "test")
    require(torch.equal(graphed.base_batch("test", te_idx[0], te_valid[0]),
                        eager.base_batch("test", te_idx[0], te_valid[0])),
            "probe_base: a graphed test batch differs from the eager one")
    require(steps["base"] == kernel_counts(lstm_fwd=2, lstm_bwd=2, attention_packed_fwd=1,
                                           attention_packed_bwd=1)
            and steps["probe"] == kernel_counts(lstm_fwd=2, attention_packed_fwd=1),
            f"probe_base launches a step: {steps}")
    require(refuses_in_plain_ops(lambda: graphed.probe_batch(idx[0], valid[0])),
            "probe_base: a probe-step replay inside plain_ops() did not raise")
    timing = {
        "base_step": graphed_against_eager(
            "probe_base base step", lambda: graphed.base_batch("train", idx[0], valid[0]),
            lambda: eager.base_batch("train", idx[0], valid[0]), 2, busy_calls=5),
        "probe_step": graphed_against_eager(
            "probe_base probe step", lambda: graphed.probe_batch(idx[0], valid[0]),
            lambda: eager.probe_batch(idx[0], valid[0]), 2, busy_calls=5)}
    del graphed, eager
    free_card()

    # the path: both phases through the entry point a user calls
    trainer = ProbeTrainer(cfg, epochs_base=PROBE_EPOCHS, epochs_probe=PROBE_EPOCHS,
                           device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    curves = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    n_steps, n_tests = trainer.data.train_batches, trainer.data.test_batches
    want = kernel_counts(
        lstm_fwd=2 * PROBE_EPOCHS * (2 * n_steps + n_tests),
        lstm_bwd=2 * PROBE_EPOCHS * n_steps,
        attention_packed_fwd=PROBE_EPOCHS * (2 * n_steps + n_tests),
        attention_packed_bwd=PROBE_EPOCHS * n_steps)
    require(launches == want, f"kernel launches on the probe_base-verify path: {launches}, "
            f"want {want}")
    per_step = np.concatenate(curves)
    dcg_bound = float((1.0 / np.log2(np.arange(SEQ_LEN) + 2.0)).sum())
    require(per_step.shape == (PROBE_EPOCHS * n_steps, 6) and np.isfinite(per_step).all()
            and ((per_step[:, 0::2] >= 0) & (per_step[:, 0::2] <= 1)).all()
            and (np.abs(per_step[:, 1::2]) <= dcg_bound).all(),
            f"probe metrics {per_step.tolist()}")
    require(len(trainer.f1_record) == PROBE_EPOCHS and np.isfinite(trainer.f1_record).all()
            and os.path.isfile(trainer.base_path), f"probe_base records "
            f"{trainer.f1_record}, best weights at {trainer.base_path}")

    plain = ProbeTrainer(cfg, device="cuda", graphs=False)  # plain versions run eager
    with plain_ops():
        plain_runs = [plain.base_epoch() for _ in range(PROBE_EPOCHS)]
    k_steps = np.concatenate([m["train_loss_steps"] for m in trainer.history])
    p_steps = np.concatenate([m["train_loss_steps"] for m in plain_runs])
    step_rel = np.abs(k_steps - p_steps) / np.abs(p_steps)
    require(np.all(step_rel <= STEP_LOSS_REL), f"probe_base phase-1 step losses "
            f"{k_steps.tolist()} vs plain {p_steps.tolist()}: rel err {step_rel.tolist()}")
    out = {"timing": dict(timing, run_s=run_s, train_steps=n_steps, test_batches=n_tests),
           "launches": launches}
    log(f"probe_base-verify: {GRAPH_CHECK_STEPS} graphed base and probe steps equal the "
        f"eager ones bit for bit; phase 1 {json.dumps(trainer.history)}; step losses max "
        f"rel err against the plain versions {step_rel.max():.3e}; probes (last step) "
        f"{per_step[-1].tolist()}; timing {json.dumps(out['timing'])}")
    return out


def bmt_end_to_end(model_name: str, workdir: str) -> dict:
    """`<model>-verify_bmt` for AttnCut and Choopy at their zoo widths: a
    graphed Trainer of the model's drmm_tks preset trains one epoch and
    writes its best weights (`--model-persist`), then verify_bmt's heads
    train BMT_EPOCHS epochs at its CLI defaults (B = 20) on that frozen
    trunk (`--ft 1`) and on the raw features (`--ft 0`), each for the
    classification and the rerank task, every step one graph; the frozen
    trunk runs K1' (AttnCut's BiLSTM) and K5' (dh 64 at N = 20, or Choopy's
    three layers at dh 16) in each train and test step. Before the path, a
    graphed and an eager BMTVerifier from the same seed, `--ft 1` and `--ft
    0`: an epoch's metrics, the head and Adam's state bit for bit."""
    from rlt_tpu_torch.config import TrainConfig, apply_preset
    from rlt_tpu_torch.train import Trainer
    from rlt_tpu_torch.verify_bmt import BMTVerifier

    trunk_cfg = dataclasses.replace(
        apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04")),
        epochs=1, model_persist=True, save_path=workdir)
    trunk = Trainer(trunk_cfg, device="cuda")
    trunk.run()
    require(os.path.isfile(trunk.best_path), f"{model_name}: no weights at {trunk.best_path}")
    cfg = TrainConfig(model_name=model_name, retrieve_data="robust04", batch_size=BMT_BATCH,
                      epochs=BMT_EPOCHS, lr=BMT_LR, weight_decay=BMT_WEIGHT_DECAY,
                      model_path=trunk.best_path)
    del trunk
    for ft in (True, False):
        graphed, eager = (BMTVerifier(cfg, "c", ft, device="cuda", graphs=g)
                          for g in (True, False))
        got, want = graphed.run_epoch(), eager.run_epoch()
        require(got == want, f"{model_name} verify_bmt ft={ft}: graphed epoch {got} "
                f"against eager {want}")
        same_training_state(f"{model_name} verify_bmt ft={ft}",
                            [((graphed.head, graphed.optimizer), (eager.head, eager.optimizer))])
    free_card()

    torch.cuda.synchronize()
    reset_counts()
    records, n_calls = {}, 0
    for ft in (True, False):
        for verify_type in ("c", "r"):
            verifier = BMTVerifier(cfg, verify_type, ft, device="cuda")
            records[f"ft{int(ft)}_{verify_type}"] = verifier.run()
            n_calls += ft * BMT_EPOCHS * (verifier.data.train_batches
                                          + verifier.data.test_batches)
    torch.cuda.synchronize()
    launches = read_counts()
    trunk_launches = ({"lstm_fwd": 2, "attention_packed_fwd": 1} if model_name == "attncut"
                      else {"attention_packed_fwd": 3})
    want = kernel_counts(**{k: n * n_calls for k, n in trunk_launches.items()})
    require(launches == want, f"kernel launches on the {model_name}-verify_bmt path: "
            f"{launches}, want {want}")
    for key, record in records.items():
        require(len(record) == BMT_EPOCHS and np.isfinite(record).all()
                and (key.endswith("_r") or all(0.0 <= m <= 1.0 for m in record)),
                f"{model_name} verify_bmt {key}: record {record}")
    log(f"{model_name}-verify_bmt: graphed epochs equal the eager ones bit for bit "
        f"(--ft 1 and 0); records {json.dumps(records)}")
    return {"launches": launches, "records": records}


def resume_end_to_end(compute_dtype: str, workdir: str) -> dict:
    """`mmoecut-resume[-bf16]`: MMOECut at its drmm_tks preset (B = 63,
    robust04 width) in `compute_dtype`, graphed, RESUME_EPOCHS[0] epochs with
    `--model-persist`, `--log-dir` and `--draw`, then RESUME_EPOCHS[1] more
    from that state in two Trainers, against one Trainer of all the epochs:
    one restored after its graphs were captured (an epoch first moves the
    parameters, Adam's state and the generator they read), one restored
    before its first capture with the log and figures on, as `--resume`
    does. Each one's resumed epochs' step losses and metrics, its
    parameters, Adam's state and the generator's state equal the
    uninterrupted run's bit for bit. The log holds a row per epoch and per
    step and a summary a run; the figures of the even epochs are PNGs. The
    path's launches are the three runs' steps and test batches and the
    figures' forwards. Then the resumed trainer's epoch, with its busy ms
    and host share, and its one restore's seconds."""
    from rlt_tpu_torch.config import TrainConfig, apply_preset
    from rlt_tpu_torch.train import Trainer
    from rlt_tpu_torch.utils.timing import busy_row, device_busy, interleaved_ms

    total = sum(RESUME_EPOCHS)
    bf16 = compute_dtype == "bfloat16"
    label = f"mmoecut-resume{'-bf16' if bf16 else ''}"
    cfg = dataclasses.replace(
        apply_preset(TrainConfig(model_name="mmoecut", retrieve_data="robust04",
                                 compute_dtype=compute_dtype)), epochs=total)
    whole = Trainer(cfg, device="cuda")
    whole.run()
    split = dataclasses.replace(cfg, model_persist=True, save_path=workdir, draw=True,
                                log_dir=os.path.join(workdir, "runs"))
    figs = os.path.join(workdir, "figs")
    os.makedirs(workdir, exist_ok=True)
    restored = {}

    def timed(restore):
        def run():
            t0 = time.perf_counter()
            restored["start"] = restore()
            torch.cuda.synchronize()
            restored["s"] = time.perf_counter() - t0
            return restored["start"]
        return run

    torch.cuda.synchronize()
    reset_counts()
    with contextlib.chdir(workdir):  # the figures go to ./figs
        first = Trainer(dataclasses.replace(split, epochs=RESUME_EPOCHS[0]), device="cuda")
        first.run()
        rewound = Trainer(dataclasses.replace(split, model_persist=False, draw=False,
                                              log_dir=None), device="cuda")
        rewound.run_epoch()  # captures both graphs and moves what they read
        rewound_summary = rewound.run(resume=True)
        resumed = Trainer(split, device="cuda")
        resumed.restore = timed(resumed.restore)  # the one restore of run(resume=True)
        summary = resumed.run(resume=True)
    torch.cuda.synchronize()
    launches = read_counts()
    require(restored["start"] == RESUME_EPOCHS[0],
            f"{label}: resumed at epoch {restored['start']}")
    for name, trainer, got in (("restored after capture", rewound, rewound_summary),
                               ("restored before capture", resumed, summary)):
        require(len(trainer.history) == RESUME_EPOCHS[1],
                f"{label} {name}: ran {len(trainer.history)} epochs")
        for e, metrics in enumerate(trainer.history):
            want = whole.history[RESUME_EPOCHS[0] + e]
            require(metrics == want, f"{label} {name} epoch {RESUME_EPOCHS[0] + e}: "
                    f"{metrics} against the uninterrupted run's {want}")
        same_training_state(f"{label} {name} against the uninterrupted run",
                            [((trainer.model, trainer.optimizer),
                              (whole.model, whole.optimizer))])
        require(torch.equal(trainer.generator.get_state(), whole.generator.get_state())
                and trainer.f1_record == whole.f1_record and got == whole.summary(),
                f"{label} {name}: generator, records or summary {got} differ from the "
                f"uninterrupted run's {whole.summary()}")
    steps, tests = whole.data.train_batches, whole.data.test_batches
    drawn = [e for e in range(total) if e % 2 == 0]
    epochs = total + 1 + RESUME_EPOCHS[1]  # first and resumed, and the rewound trainer's
    forwards = tests * epochs + len(drawn) * -(-whole.data.n_test // cfg.batch_size)
    want = want_counts("mmoecut", forwards=forwards, steps=steps * epochs, bf16=bf16)
    require(launches == want, f"kernel launches on the {label} path: {launches}, want {want}")
    with open(os.path.join(workdir, "runs", "mmoecut", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    require(sum("epoch" in r for r in rows) == total and sum("step" in r for r in rows)
            == total * steps and sum("summary" in r for r in rows) == 2,
            f"{label}: the log's rows {rows}")
    names = sorted(os.listdir(figs))
    for name in names:
        with open(os.path.join(figs, name), "rb") as f:
            require(f.read(8) == PNG, f"{label}: {name} is no PNG")
    require(names == sorted(f"mmoecut_js_ar_{e}.png" for e in drawn),
            f"{label}: figures {names}")
    t = interleaved_ms({"epoch": resumed.run_epoch}, 1, PATH_REPEATS)["epoch"]
    row = busy_row(device_busy(resumed.run_epoch, calls=1, warmup=0), t["median"])
    require("failed" not in row, f"{label} epoch: busy row failed: {json.dumps(row)}")
    epoch = dict(epoch_ms=t["median"], epoch_spread=[t["min"], t["max"]], **row)
    log(f"{label}: {RESUME_EPOCHS[0]} epochs and {RESUME_EPOCHS[1]} resumed equal "
        f"{total} uninterrupted ones bit for bit (step losses, metrics, parameters, Adam's "
        f"state, generator), restored after the graphs' capture and before it; restore "
        f"{restored['s']:.3f} s; log rows {len(rows)}, figures {names}; resumed epoch "
        f"{json.dumps(epoch)}")
    return {"launches": launches, "epoch": epoch, "restore_s": restored["s"]}


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


def probe_rows_entry(name: str, res: tuple, launches: dict, bf16: bool = False) -> dict:
    """The kernels line's `n_126` sub-entry of a packed kernel (or, with
    `bf16`, of its bf16 instance): its times at ProbeBase's N = PROBE_ROWS
    rows at dh 64, with dropout 0.1 for the forward (the backward is timed
    at 0.1), and its launches on probe_base-verify, the path that runs it
    at those rows (in float32 only)."""
    keys = ("ms", "plain_ms", "library_ms", "library_ratio", "spread_ms", "bound_ms",
            "bound_tc_ms", "bound_by", "bound_term", "hash_floor_ms", "max_abs_err")
    pick = lambda r: {k: r[k] for k in keys if k in r}  # noqa: E731
    if bf16:
        row = res[2]["rows"][0]
        entry = pick(row)
        for variant in ("dropout_0.1", "rate_0"):
            if variant in row:
                entry[variant] = pick(row[variant])
        entry["max_abs_err"] = res[2]["max_abs_err"]
    else:
        entry = pick(res[0]["rows"][0])
        if res[1] is not None:
            entry["dropout_0.1"] = pick(res[1]["rows"][0])
            entry["max_abs_err"] = max(res[0]["max_abs_err"], res[1]["max_abs_err"])
    entry["launches_by_path"] = {"probe_base-verify": launches["probe_base-verify"][name]}
    return entry


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
    by_path = {path: launches[path][bf16_name] for path in ALL_PATHS}
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
    # the SM clock and temperature as the run starts and ends: a card that
    # runs slower reads its busy rows closer to their bounds
    log(f"clocks: {nvidia_smi('clocks.sm,clocks.max.sm,temperature.gpu,power.draw')}")
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
    # population training: the member-batched kernels on their own
    # generators, then every model's population path in both dtypes (float32
    # first: its sequential runs are the bf16 path's d_ref), then the timing
    marks.append(("population kernels", time.perf_counter()))
    members_res = {"float32": check_lstm_members(dev, CardDraws(180, dev))}
    with untimed_plain():
        members_res["bfloat16"] = check_lstm_members(dev, CardDraws(181, dev), bf16=True)
        member_attn = check_member_attention(dev)
    marks.append(("member rate kernels", time.perf_counter()))
    member_rates = check_member_rates(dev)
    marks.append(("population paths", time.perf_counter()))
    f32_runs = {}
    for model_name in MODELS:
        for dtype, suffix in (("float32", ""), ("bfloat16", "-bf16")):
            launches[f"{model_name}-population{suffix}"] = population_end_to_end(
                model_name, dtype, f32_runs)
            free_card()
    del f32_runs
    marks.append(("population timing", time.perf_counter()))
    population_res = []
    for model_name in MODELS:
        for dtype in ("float32", "bfloat16"):
            torch.cuda.reset_peak_memory_stats()
            population_res.append(population_timing(model_name, dtype))
            free_card()
    rate_timing = []
    for dtype in ("float32", "bfloat16"):
        rate_timing.append(member_rate_timing(dtype))
        free_card()
    # the harness paths: K5'/K6' at ProbeBase's rows on their own generator,
    # then verify_probe, verify_bmt and --resume, their files in a scratch
    # directory of their own
    marks.append(("harness paths", time.perf_counter()))
    rngh = np.random.default_rng(190)
    probe_rows = (PROBE_ROWS,)
    probe_attn = {
        "attention_packed_fwd": (check_attention(dev, rngh, rows=probe_rows),
                                 check_attention_dropout(dev, rngh, rows=probe_rows),
                                 check_attention_bf16(dev, rngh, rows=probe_rows)),
        "attention_packed_bwd": (check_attention_bwd(dev, rngh, rows=probe_rows), None,
                                 check_attention_bwd_bf16(dev, rngh, rows=probe_rows))}
    harness = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        harness["probe_base-verify"] = probe_end_to_end(os.path.join(workdir, "probe"))
        free_card()
        for model_name in ("attncut", "choopy"):
            harness[f"{model_name}-verify_bmt"] = bmt_end_to_end(
                model_name, os.path.join(workdir, model_name))
            free_card()
        for dtype, suffix in (("float32", ""), ("bfloat16", "-bf16")):
            harness[f"mmoecut-resume{suffix}"] = resume_end_to_end(
                dtype, os.path.join(workdir, f"resume{suffix}"))
            free_card()
    launches.update({path: res["launches"] for path, res in harness.items()})
    marks.append(("end", time.perf_counter()))
    log(json.dumps({"phase_seconds": {name: marks[i + 1][1] - t for i, (name, t) in
                                      enumerate(marks[:-1])}}))
    bf16_res = {"lstm_fwd": lstm_bf16_res, "attention_fwd": slice_bf16_res,
                "attention_packed_fwd": attn_bf16_res, "lstm_bwd": lstm_bwd_bf16_res,
                "attention_bwd": slice_bwd_bf16_res,
                "attention_packed_bwd": attn_bwd_bf16_res}
    bf16_dh16 = {"attention_packed_fwd": attn_bf16_dh16_res,
                 "attention_packed_bwd": attn_bwd_bf16_dh16_res}
    all_paths = ALL_PATHS

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
            # ProbeBase's N = 2B rows, on the probe_base-verify path
            entry[f"n_{PROBE_ROWS}"] = probe_rows_entry(name, probe_attn[name], launches)
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       entry[f"n_{PROBE_ROWS}"]["max_abs_err"])
            entry["dh_16"] = dh16_entry(name, *dh16[name], launches)
            entry["max_abs_err"] = max(entry["max_abs_err"], entry["dh_16"]["max_abs_err"])
        if name.startswith("attention"):  # the population paths' member-batched shapes
            entry["members"] = member_entry(member_attn["float32"][name], MEMBER_KEYS)
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       member_max_err(member_attn["float32"][name]))
            pair, direction = name.rsplit("_", 1)
            entry["member_rates"] = member_rate_entry(member_rates["float32"][pair],
                                                      direction)
        if name in BF16_OF:
            entry["bf16"] = bf16_entry(name, bf16_res[name], source, replaces,
                                       BF16_LIBRARY[name], launches,
                                       bf16_dh16.get(name))
            if name.startswith("attention_packed"):  # ProbeBase's rows in bf16
                entry["bf16"][f"n_{PROBE_ROWS}"] = probe_rows_entry(
                    BF16_OF[name], probe_attn[name], launches, bf16=True)
                entry["bf16"]["max_abs_err"] = max(
                    entry["bf16"]["max_abs_err"],
                    entry["bf16"][f"n_{PROBE_ROWS}"]["max_abs_err"])
            if name.startswith("attention"):
                entry["bf16"]["members"] = member_entry(member_attn["bfloat16"][name],
                                                        MEMBER_KEYS)
                entry["bf16"]["max_abs_err"] = max(
                    entry["bf16"]["max_abs_err"],
                    member_max_err(member_attn["bfloat16"][name]))
                entry["bf16"]["member_rates"] = member_rate_entry(
                    member_rates["bfloat16"][pair], direction)
        kernels.append(entry)
    for name, source, replaces in (
            ("lstm_fwd", "rlt_tpu_torch/csrc/lstm_fwd.cu", "rlt_tpu/ops/lstm.py:82"),
            ("lstm_bwd", "rlt_tpu_torch/csrc/lstm_bwd.cu", "rlt_tpu/ops/lstm.py:101")):
        # the member-batched form (jax.vmap over population members), at
        # K = POPULATION_SIZES[0] with the larger K beside it; its launches
        # are the population path's
        rows = {k: members_res["float32"][k][name] for k in POPULATION_SIZES}
        main_row = rows[POPULATION_SIZES[0]]
        entry = {"name": f"{name}_members", "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(launches[p][name] for p in POPULATION_PATHS),
                 "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                 **{key: main_row[key] for key in (
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "members",
                     "ndir", "batch", "rows_per_block", "blocks", "waves",
                     "sequential_ms", "sequential_ratio", "cudnn_shared_ms",
                     "spread_ms")},
                 "library_call": None,
                 "cudnn_shared_call": "torch.nn.LSTM (cuDNN), 1 layer 2 directions, over "
                                      "the K * B rows with one set of weights"}
        row_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "ndir", "blocks", "waves",
                    "sequential_ms", "sequential_ratio", "cudnn_shared_ms", "spread_ms",
                    "max_abs_err")
        for k, row in rows.items():
            if k != POPULATION_SIZES[0]:
                entry[f"members_{k}"] = {key: row[key] for key in row_keys}
        # the bf16 instance (csrc/lstm_bf16_mma.cuh) at K = 4 and 8, its
        # launches the bf16 population paths'
        entry["bf16"] = {
            "name": f"{BF16_OF[name]}_members", "source": BF16_LSTM_SOURCE[name],
            "launches": sum(launches[p][BF16_OF[name]] for p in POPULATION_PATHS),
            "library_ms": None,
            **{f"members_{k}": {key: members_res["bfloat16"][k][name][key]
                                for key in row_keys + ("bound_tc_ms",)}
               for k in POPULATION_SIZES}}
        entry["bf16"]["max_abs_err"] = max(r["max_abs_err"] for r in (
            members_res["bfloat16"][k][name] for k in POPULATION_SIZES))
        kernels.append(entry)
    for model_name, res in train_res.items():
        log(json.dumps({"model": model_name, "train_step_ms": res["timing"]["step_ms"],
                        "epoch_ms": res["timing"]["epoch_ms"]}))
    for model_name, res in train_bf16_res.items():
        log(json.dumps({"model": model_name, "compute_dtype": "bfloat16",
                        "train_step_ms": res["timing"]["step_ms"],
                        "epoch_ms": res["timing"]["epoch_ms"]}))
    for res in population_res:
        log(json.dumps({"population": res}))
    for res in rate_timing:
        log(json.dumps({"member_rate_timing": res}))
    probe_timing = harness["probe_base-verify"]["timing"]
    resume_epochs = {path: harness[path]["epoch"] for path in HARNESS_PATHS
                     if "resume" in path}
    log(json.dumps({"harness_timing": {"probe_base-verify": probe_timing, **resume_epochs}}))
    busy_rows = [res[name] for res in population_res for name in ("population", "sequential")]
    busy_rows += [res[name] for res in rate_timing for name in ("per_member", "shared")]
    busy_rows += [probe_timing[step][name] for step in ("base_step", "probe_step")
                  for name in ("graphed", "eager")] + list(resume_epochs.values())
    ratios = []
    for dtype, trains, serves in (("float32", train_res, serve_res),
                                  ("bfloat16", train_bf16_res, serve_bf16_res)):
        for model_name in MODELS:  # graphed against eager: windows, busy, host shares
            rows = {"train_step": trains[model_name]["timing"]["graphed_step"],
                    **serves[model_name]["graphs"]}
            busy_rows += [row[name] for row in rows.values() for name in ("graphed", "eager")]
            ratios += [row["busy_ratio"] for row in rows.values()]
            log(json.dumps({"graphs": {"model": model_name, "compute_dtype": dtype, **rows}}))
    ratios += [probe_timing[step]["busy_ratio"] for step in ("base_step", "probe_step")]
    summary = {"rows": len(busy_rows),
               "measured": sum(r["busy_ms"] is not None for r in busy_rows),
               "failed": sum("failed" in r for r in busy_rows),
               "stretch": [min(r["stretch"] for r in busy_rows if r["stretch"]),
                           max(r["stretch"] for r in busy_rows if r["stretch"])],
               "graphed_over_eager_busy": [min(ratios), max(ratios)]}
    log(json.dumps({"busy_rows": summary}))
    require(summary["failed"] == 0 and summary["measured"] == summary["rows"],
            f"busy rows failed: {json.dumps(summary)}")
    log(json.dumps({"kernels": kernels}))
    log(f"clocks: {nvidia_smi('clocks.sm,clocks.max.sm,temperature.gpu,power.draw')}")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
