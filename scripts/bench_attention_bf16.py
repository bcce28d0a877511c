#!/usr/bin/env python3
"""The bf16 attention kernels on one CUDA card, against other trees' builds
of the same entry points, in one process.

    python3 scripts/bench_attention_bf16.py [--tree DIR ...] [--backward]
        [--serving] [--training] [--dh16] [--out build/attention_bf16_ab.json]

Times K5''s bf16 instance (`rlt_attention_packed_fwd_bf16`) at dh = 64
(N = 63, 189 and 768 rows of 4 heads in groups of 2) and dh = 16 (N = 63
and 256 rows of 8 heads in one group), and K3''s (`rlt_attention_fwd_bf16`,
dh = 128) at 378 and 1536 slices, all at L = 300, and all three at L = 2048
(8 rows of dh 64 or 16, 8 slices: about the products of N = 189 at L = 300
in a few long lists), at dropout rates 0 and 0.1, beside bf16
`scaled_dot_product_attention` of the same q, k, v. Every library's o and
lse are first held to the plain version (`rlt_tpu_torch.ops.attention`)
with `chip_smoke.py`'s bound.

- `--backward`: the same rows of the backwards instead, K6''s bf16 instance
  (`rlt_attention_packed_bwd_bf16`) and K4''s (`rlt_attention_bwd_bf16`),
  on the plain forward's o and lse, beside the backward alone of bf16
  `scaled_dot_product_attention` (its own dropout mask at rate 0.1); every
  library's dq, dk and dv first held to the plain backward with
  `chip_smoke.py`'s bound.
- `--dh16`: only the kernel rows of dh = 16.
- `--tree DIR` (repeatable): DIR holds another tree (`git archive <commit>
  rlt_tpu_torch/csrc | tar -x -C DIR`), named by DIR's last part. Its
  `rlt_tpu_torch/csrc` is built as this tree's is (`ops/build.py`) and
  loaded through ctypes beside this tree's library ("new"), and every row
  times them all in turns (`utils/timing.py::interleaved_ms`, 14 rounds of
  20 calls, the order reversed in odd rounds), medians. At N = 189 (378
  slices), rate 0, the host's microseconds a launch (200 launches without a
  synchronise) are taken for each library's entry point, this tree's
  wrapper in `ops/attention.py` and SDPA, and for reading the current
  stream as `ops/build.py::stream_handle` does and through a
  `torch.cuda.Stream` object. With `--backward`, every row at N = 189 and
  every dh = 16 row also gives each build's kernels' device microseconds
  by name (torch.profiler): the two passes apart.
- `--serving`: the bf16 Predictor's forward of MMOECut, PLECut, Choopy and
  MtChoopy at buckets 64 and 256 (robust04 width, seeded weights), once through the
  first tree's bf16 attention forward and once through this tree's, in
  turns, each with the card's busy ms (torch.profiler) and the host's share.
- `--training`: the bf16 train step (forward with the loss, backward, Adam;
  the drmm_tks preset, B = 63, robust04 width) of MMOECut, MOECut (dropout
  rate 0), PLECut and AttnCut, once through the first tree's bf16 attention
  backward and once through this tree's, and of Choopy and MtChoopy once
  through the first tree's dh = 16 forward and backward and once through
  this tree's, in turns, each with the card's busy ms and the host's share.

Prints one JSON line a row and the card's name and power limit, and writes
every row to `--out`. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import bf16_grads_check, bf16_o_check  # noqa: E402
from rlt_tpu_torch.ops import attention, build  # noqa: E402
from rlt_tpu_torch.utils.timing import busy_row, device_busy, interleaved_ms  # noqa: E402

SEQ_LEN = 300
LONG_L = 2048  # about the products of N = 189 at L = 300, in few long lists
RATE = 0.1
ROUNDS = 14
PACKED_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_uint,
                                                            ctypes.c_void_p]
SLICE_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_uint,
                                                           ctypes.c_void_p]
PACKED_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_uint,
                                                                 ctypes.c_void_p]
SLICE_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_uint,
                                                                ctypes.c_void_p]
# the rows of either pass: (kernel, dh, rows or slice pairs, L)
CASES = ([("packed", 64, n, SEQ_LEN) for n in (63, 189, 768)]
         + [("packed", 16, n, SEQ_LEN) for n in (63, 256)]
         + [("slice", 128, n, SEQ_LEN) for n in (189, 768)]
         + [("packed", 64, 8, LONG_L), ("slice", 128, 4, LONG_L), ("packed", 16, 8, LONG_L)])


def log(row: dict) -> None:
    print(json.dumps(row), flush=True)


def bind(lib: ctypes.CDLL, symbol: str, argtypes: list):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a launch: `calls` launches without a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def qkv(rng, shape, dev):
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).bfloat16()
            for _ in range(3)]


def kernel_rows(dev, libs: dict, cases: list) -> list[dict]:
    rng = np.random.default_rng(12)
    stream = build.stream_handle(dev)
    rows = []
    for kind, dh, n, length in cases:
        if kind == "packed":
            heads, d = (4, 256) if dh == 64 else (8, 128)
            pack = attention.packed_group_size(d, heads)
            q, k, v = qkv(rng, (n, length, d), dev)
            lse_shape = (n, heads // pack, length, pack)
            by_head = [t.view(n, length, heads, dh).transpose(1, 2) for t in (q, k, v)]
        else:
            q, k, v = qkv(rng, (n, 2, length, dh), dev)
            lse_shape = (2 * n, 1, length)
            by_head = (q, k, v)
        streams = torch.from_numpy(rng.integers(-2**31, 2**31, size=lse_shape[0],
                                                dtype=np.int64).astype(np.int32)).to(dev)
        for rate in (0.0, RATE):
            if kind == "packed":
                want = attention.attention_packed_plain(q, k, v, heads, pack, rate, streams)
                wrapper = lambda: attention.attention_packed_fwd_bf16(  # noqa: E731
                    q, k, v, heads, pack, rate, streams)
            else:
                want = attention.attention_plain(q, k, v, rate, streams)
                wrapper = lambda: attention.attention_fwd_bf16(q, k, v, rate,  # noqa: E731
                                                               streams)
            threshold = attention.keep_threshold(rate)
            s_ptr = ctypes.c_void_p(streams.data_ptr() if rate > 0 else None)
            symbol, argtypes = (("rlt_attention_packed_fwd_bf16", PACKED_ARGS)
                                if kind == "packed" else ("rlt_attention_fwd_bf16", SLICE_ARGS))
            cands, errs = {}, {}
            for name, lib in libs.items():
                fn = bind(lib, symbol, argtypes)
                o = torch.empty_like(q)
                lse = torch.empty(lse_shape, device=dev, dtype=torch.float32)
                ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o, lse)] + [s_ptr]
                shape = [n, length, heads, dh, pack] if kind == "packed" else [2 * n, length]
                args = ptrs + shape + [rate, threshold, stream]

                def call(fn=fn, args=args, name=name):
                    code = fn(*args)
                    if code != 0:
                        raise RuntimeError(f"{name} {symbol}: CUDA error {code}")
                call()
                torch.cuda.synchronize()
                errs[name] = bf16_o_check(f"{name} {kind} dh={dh} n={n} L={length} "
                                          f"rate={rate}", o, lse, *want)
                cands[name] = call
            cands["sdpa"] = lambda: F.scaled_dot_product_attention(*by_head, dropout_p=rate)
            row = timed_row({"kernel": kind, "dh": dh, "n": n, "length": length, "rate": rate},
                            cands, libs, {"o_lse_errs": errs})
            if rate == 0.0 and n == 189:
                row["host_us"] = host_row(dev, cands, libs, wrapper)
            log(row)
            rows.append(row)
    return rows


def timed_row(meta: dict, cands: dict, libs: dict, errs: dict) -> dict:
    """One row: every library's build and SDPA in turns (14 rounds of 20
    calls, odd rounds reversed), medians, spreads, ratios to SDPA and this
    tree's build over each other's."""
    t = interleaved_ms(cands, iters=20, repeats=ROUNDS, alternate=True)
    row = {**meta, "ms": {name: r["median"] for name, r in t.items()},
           "spread_ms": {name: [r["min"], r["max"]] for name, r in t.items()}, **errs}
    row["library_ratio"] = {name: row["ms"][name] / row["ms"]["sdpa"] for name in libs}
    row["new_over"] = {name: row["ms"]["new"] / row["ms"][name]
                       for name in libs if name != "new"}
    return row


def host_row(dev, cands: dict, libs: dict, wrapper) -> dict:
    """Host microseconds a launch of each library's entry point, this tree's
    wrapper and SDPA, and of reading the current stream two ways."""
    return {**{name: host_us(cands[name]) for name in libs},
            "wrapper": host_us(wrapper), "sdpa": host_us(cands["sdpa"]),
            "stream_handle": host_us(lambda: build.stream_handle(dev)),
            "stream_object": host_us(lambda: ctypes.c_void_p(
                torch.cuda.current_stream(dev).cuda_stream))}


def backward_rows(dev, libs: dict, cases: list) -> list[dict]:
    """The bf16 backwards (K6' packed, K4' per slice) at `cases`, on the
    plain forward's o and lse, every library's build and SDPA's backward in
    turns."""
    rng = np.random.default_rng(13)
    stream = build.stream_handle(dev)
    rows = []
    for kind, dh, n, length in cases:
        if kind == "packed":
            heads, d = (4, 256) if dh == 64 else (8, 128)
            pack = attention.packed_group_size(d, heads)
            q, k, v, do = qkv(rng, (n, length, d), dev) + qkv(rng, (n, length, d), dev)[:1]
            slices, n_streams = n * heads, n
            by_head = lambda t: t.view(n, length, heads, dh).transpose(1, 2)  # noqa: E731
            shape = [n, length, heads, dh, pack]
            symbol, argtypes = "rlt_attention_packed_bwd_bf16", PACKED_BWD_ARGS
        else:
            q, k, v, do = qkv(rng, (n, 2, length, dh), dev) + qkv(rng, (n, 2, length, dh),
                                                                 dev)[:1]
            slices, n_streams = 2 * n, 2 * n
            by_head = lambda t: t  # noqa: E731
            shape = [2 * n, length]
            symbol, argtypes = "rlt_attention_bwd_bf16", SLICE_BWD_ARGS
        streams = torch.from_numpy(rng.integers(-2**31, 2**31, size=n_streams,
                                                dtype=np.int64).astype(np.int32)).to(dev)
        for rate in (0.0, RATE):
            if kind == "packed":
                o, lse = attention.attention_packed_plain(q, k, v, heads, pack, rate, streams)
                want = attention.attention_packed_bwd_plain(q, k, v, o, lse, do, heads, pack,
                                                            rate, streams)
                wrapper = lambda: attention.attention_packed_bwd_bf16(  # noqa: E731
                    q, k, v, o, lse, do, heads, pack, rate, streams)
            else:
                o, lse = attention.attention_plain(q, k, v, rate, streams)
                want = attention.attention_bwd_plain(q, k, v, o, lse, do, rate, streams)
                wrapper = lambda: attention.attention_bwd_bf16(  # noqa: E731
                    q, k, v, o, lse, do, rate, streams)
            threshold = attention.keep_threshold(rate)
            s_ptr = ctypes.c_void_p(streams.data_ptr() if rate > 0 else None)
            cands, errs = {}, {}
            for name, lib in libs.items():
                fn = bind(lib, symbol, argtypes)
                grads = [torch.empty_like(q) for _ in range(3)]
                delta = torch.empty(slices, length, device=dev, dtype=torch.float32)
                ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o, do, lse)] + \
                    [s_ptr] + [ctypes.c_void_p(t.data_ptr()) for t in (*grads, delta)]
                args = ptrs + shape + [rate, threshold, stream]

                def call(fn=fn, args=args, name=name):
                    code = fn(*args)
                    if code != 0:
                        raise RuntimeError(f"{name} {symbol}: CUDA error {code}")
                call()
                torch.cuda.synchronize()
                errs[name] = bf16_grads_check(f"{name} {kind} bwd dh={dh} n={n} L={length} "
                                              f"rate={rate}", grads, want)
                cands[name] = call
            leaves = [by_head(t).detach().clone().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, dropout_p=rate)
            g_out = by_head(do)
            cands["sdpa"] = lambda: torch.autograd.grad(out, leaves, g_out, retain_graph=True)
            row = timed_row({"kernel": f"{kind}_bwd", "dh": dh, "n": n, "slices": slices,
                             "length": length, "rate": rate}, cands, libs,
                            {"grad_errs": errs})
            if n == 189 or dh == 16:
                row["kernel_us"] = {name: kernel_us(cands[name]) for name in libs}
            if rate == 0.0 and n == 189:
                row["host_us"] = host_row(dev, cands, libs, wrapper)
            log(row)
            rows.append(row)
    return rows


def kernel_us(fn, calls: int = 20) -> dict:
    """Device microseconds a call of each kernel that `fn` launches, by name
    (torch.profiler): the backward's passes apart."""
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


def serving_rows(dev, other: ctypes.CDLL) -> list[dict]:
    """The bf16 Predictor of MMOECut, PLECut, Choopy and MtChoopy, its bf16
    attention forward through `other`'s entry point or this tree's, in
    turns."""
    from rlt_tpu_torch.config import TrainConfig
    from rlt_tpu_torch.infer import Predictor

    kernels = {"mmoecut": (attention.ATTENTION_PACKED_FWD_BF16, PACKED_ARGS),
               "mtple": (attention.ATTENTION_FWD_BF16, SLICE_ARGS),
               "choopy": (attention.ATTENTION_PACKED_FWD_BF16, PACKED_ARGS),
               "mtchoopy": (attention.ATTENTION_PACKED_FWD_BF16, PACKED_ARGS)}
    rows = []
    for model_name, (kernel, argtypes) in kernels.items():
        cfg = TrainConfig(model_name=model_name, compute_dtype="bfloat16")
        # eager: each call goes through the entry point bound at that
        # moment; a graph would replay the one it captured
        predictor = Predictor(cfg, device=dev, graphs=False)
        fns = {"other": bind(other, kernel.symbol, argtypes)}
        rng = np.random.default_rng(5)
        for b in (64, 256):
            x = torch.from_numpy(rng.normal(size=(b, cfg.seq_len, cfg.input_size))
                                 .astype(np.float32)).to(dev)
            predictor._forward(x)  # this tree's entry point bound as kernel._fn
            fns["new"] = kernel._fn

            def through(name):
                def call():
                    kernel._fn = fns[name]
                    return predictor._forward(x)
                return call

            cands = {name: through(name) for name in ("other", "new")}
            t = interleaved_ms(cands, iters=3, repeats=ROUNDS, alternate=True)
            row = {"model": model_name, "compute_dtype": "bfloat16", "bucket": b,
                   "ms": {n: r["median"] for n, r in t.items()},
                   "spread_ms": {n: [r["min"], r["max"]] for n, r in t.items()}}
            for name, fn in cands.items():
                busy = busy_row(device_busy(fn), row["ms"][name])
                row.update({f"{name}_{k}": v for k, v in busy.items()})
            kernel._fn = fns["new"]
            log(row)
            rows.append(row)
    return rows


def training_rows(dev, other: ctypes.CDLL) -> list[dict]:
    """The bf16 train step of MMOECut, MOECut, PLECut and AttnCut, its bf16
    attention backward through `other`'s entry point or this tree's, and of
    Choopy and MtChoopy, both of their dh = 16 attention kernels (forward
    and backward) through `other`'s or this tree's, in turns."""
    from rlt_tpu_torch.config import TrainConfig, apply_preset
    from rlt_tpu_torch.train import Trainer, forward

    packed_bwd = (attention.ATTENTION_PACKED_BWD_BF16, PACKED_BWD_ARGS)
    dh16 = ((attention.ATTENTION_PACKED_FWD_BF16, PACKED_ARGS), packed_bwd)
    models = {"mmoecut": (packed_bwd,), "moecut": (packed_bwd,),
              "mtple": ((attention.ATTENTION_BWD_BF16, SLICE_BWD_ARGS),),
              "attncut": (packed_bwd,), "choopy": dh16, "mtchoopy": dh16}
    rows = []
    for model_name, swapped in models.items():
        cfg = apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04",
                                       compute_dtype="bfloat16"))
        trainer = Trainer(cfg, device=dev)
        idx, valid = trainer.data.plan(trainer.generator, "train")
        x, y, v = trainer.data.x_train[idx[0]], trainer.data.y_train[idx[0]], valid[0]
        model, opt = trainer.model, trainer.optimizer
        model.train()

        def step():
            opt.zero_grad()
            loss = trainer.criterion(forward(model, x, trainer.generator, trainer.dtype), y,
                                     valid=v)
            loss.backward()
            opt.step()

        step()  # this tree's entry points bound as each kernel's _fn
        fns = {"other": [bind(other, kernel.symbol, argtypes) for kernel, argtypes in swapped],
               "new": [kernel._fn for kernel, _ in swapped]}

        def through(name):
            def call():
                for (kernel, _), fn in zip(swapped, fns[name]):
                    kernel._fn = fn
                step()
            return call

        cands = {name: through(name) for name in ("other", "new")}
        t = interleaved_ms(cands, iters=3, repeats=ROUNDS, alternate=True)
        row = {"model": model_name, "compute_dtype": "bfloat16", "batch": cfg.batch_size,
               "dropout": cfg.dropout, "swapped": [k.symbol for k, _ in swapped],
               "ms": {n: r["median"] for n, r in t.items()},
               "spread_ms": {n: [r["min"], r["max"]] for n, r in t.items()}}
        for name, fn in cands.items():
            busy = busy_row(device_busy(fn), row["ms"][name])
            row.update({f"{name}_{k}": v for k, v in busy.items()})
        through("new")
        log(row)
        rows.append(row)
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", type=Path, action="append", default=[])
    p.add_argument("--backward", action="store_true")
    p.add_argument("--serving", action="store_true")
    p.add_argument("--training", action="store_true")
    p.add_argument("--dh16", action="store_true", help="only the rows of dh = 16")
    p.add_argument("--out", type=Path, default=REPO / "build" / "attention_bf16_ab.json")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_attention_bf16: no CUDA card is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    libs = {}
    for tree in args.tree:
        other = build.KernelLibrary(tree / "rlt_tpu_torch" / "csrc")
        libs[tree.name] = other.get()
        result[f"{tree.name}_build_seconds"] = other.build_seconds
    libs["new"] = build.LIBRARY.get()
    result["build_seconds"] = build.LIBRARY.build_seconds
    log(dict(result))
    cases = [c for c in CASES if c[1] == 16] if args.dh16 else CASES
    result["rows"] = (backward_rows if args.backward else kernel_rows)(dev, libs, cases)
    if args.serving and args.tree:
        result["serving"] = serving_rows(dev, libs[args.tree[0].name])
    if args.training and args.tree:
        result["training"] = training_rows(dev, libs[args.tree[0].name])
    result["seconds"] = time.perf_counter() - t0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
