#!/usr/bin/env python3
"""The bf16 LSTM kernels K1' and K2' on one CUDA card, against other trees'
builds of the same entry points, in one process.

    python3 scripts/bench_lstm_bf16.py [--tree DIR ...] [--sweep] [--serving]
        [--training] [--dh16] [--out build/lstm_bf16_ab.json]

Times K1''s bf16 instance (`rlt_lstm_fwd_bf16`) and K2''s
(`rlt_lstm_bwd_bf16`) at L = 300 over ndir = 1, 2 and 8 directions (8: the
BiLSTM layers of K = 4 population members) of B = 1, 63 and 256 rows each,
and the float32 instances (`rlt_lstm_fwd`, `rlt_lstm_bwd`) at ndir = 2,
B = 63, every library in turns beside cuDNN's bf16 (float32) LSTM of the
same rows (`torch.nn.LSTM`, one layer, bidirectional at ndir >= 2 over
ndir / 2 * B rows, weights flattened; its backward alone for K2'). Every
library's outputs are first held to the plain version
(`rlt_tpu_torch.ops.lstm`) with `chip_smoke.py`'s bounds, and every row
gives each library's device ms by kernel name (torch.profiler): K2''s
passes apart.

- `--tree DIR` (repeatable): DIR holds another tree (`git archive <commit>
  rlt_tpu_torch/csrc | tar -x -C DIR`), named by DIR's last part. Its
  `rlt_tpu_torch/csrc` is built as this tree's is (`ops/build.py`) and
  loaded through ctypes beside this tree's library ("new"), and every row
  times them all in turns (`utils/timing.py::interleaved_ms`, 14 rounds of
  10 calls, the order reversed in odd rounds), medians.
- `--sweep`: K1''s bf16 instance at L = 1, 2, 8, 32 and 300 (B = 63,
  ndir = 2) for every library, with the least-squares line through the
  five times: the slope is a step's cost, the intercept the launch and the
  load of W_hh^T.
- `--serving`: the bf16 Predictor's forward of MMOECut and BiCut at buckets
  64 and 256 (robust04 width, seeded weights), once through the first
  tree's bf16 LSTM kernels and once through this tree's, in turns, each
  with the card's busy ms (torch.profiler) and the host's share.
- `--training`: the bf16 train step (forward with the loss, backward, Adam;
  the drmm_tks preset, B = 63, robust04 width) of MMOECut, PLECut, AttnCut
  and BiCut, once through the first tree's bf16 LSTM kernels and once
  through this tree's, in turns, with busy ms and the host's share.
- `--dh16`: K5''s bf16 instance at dh = 16 (8 heads in one group, L = 300,
  N = 63 and 256 rows, rates 0 and 0.1) and bf16
  `scaled_dot_product_attention` of the same q, k, v, each as the device
  time of its kernels alone (torch.profiler), beside their windows.

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

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import LSTM_ATOL, LSTM_BWD_REL, bf16_step, kernel_us, max_errs  # noqa: E402
from rlt_tpu_torch.ops import attention, build, lstm  # noqa: E402
from rlt_tpu_torch.utils.timing import device_busy_ms, host_share, interleaved_ms  # noqa: E402

SEQ_LEN = 300
HIDDEN = 128
ROUNDS = 14
ITERS = 10
SWEEP_L = (1, 2, 8, 32, 300)
FWD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
BWD_BF16_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# (ndir, B) of the bf16 rows; the f32 instances at (2, 63)
BF16_CASES = [(2, 63), (2, 256)] + [(ndir, b) for ndir in (1, 2, 8) for b in (1, 63, 256)
                                    if (ndir, b) not in ((2, 63), (2, 256))]


def log(row: dict) -> None:
    print(json.dumps(row), flush=True)


def bind(lib: ctypes.CDLL, symbol: str, argtypes: list):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def checked(fn, name: str):
    def call(*args):
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{name}: CUDA error {code}")
    return call


def inputs(rng, length: int, ndir: int, batch: int, dev, dtype):
    xw = torch.from_numpy(rng.normal(size=(length, ndir * batch, 4 * HIDDEN))
                          .astype(np.float32)).to(dev).to(dtype)
    w = torch.from_numpy((rng.uniform(-1, 1, size=(ndir * HIDDEN, 4 * HIDDEN))
                          / np.sqrt(HIDDEN)).astype(np.float32)).to(dev).to(dtype)
    return xw, w


def fwd_check(name: str, hs, cs, want_hs, want_cs) -> float:
    """chip_smoke.py's bound of K1': cs within LSTM_ATOL, hs (bf16) within
    one bf16 step of the plain hs beyond that (float32: LSTM_ATOL)."""
    cs_err = (cs - want_cs).abs().max().item()
    diff = (hs.float() - want_hs.float()).abs()
    beyond = (diff - bf16_step(want_hs)).max().item() if hs.dtype == torch.bfloat16 \
        else diff.max().item()
    if not (torch.isfinite(hs.float()).all() and cs_err <= LSTM_ATOL
            and beyond <= LSTM_ATOL):
        raise AssertionError(f"{name}: cs err {cs_err}, hs {beyond} (limit {LSTM_ATOL})")
    return max(cs_err, diff.max().item())


def bwd_check(name: str, dxw, dw, want_dxw, want_dw) -> float:
    """chip_smoke.py's bound of K2': dxw (bf16) within one bf16 step of the
    plain dxw beyond LSTM_BWD_REL of its max abs (float32: LSTM_BWD_REL
    relative), dW_hh^T within LSTM_BWD_REL relative."""
    diff = (dxw.float() - want_dxw.float()).abs()
    if dxw.dtype == torch.bfloat16:
        beyond = (diff - bf16_step(want_dxw)).max().item()
        ok = beyond <= LSTM_BWD_REL * want_dxw.float().abs().max().item()
    else:
        ok = max_errs(dxw, want_dxw)[1] <= LSTM_BWD_REL
    dw_rel = max_errs(dw, want_dw)[1]
    if not (torch.isfinite(dxw.float()).all() and ok and dw_rel <= LSTM_BWD_REL):
        raise AssertionError(f"{name}: dxw off by {diff.max().item()}, dW_hh^T rel "
                             f"{dw_rel} (limit {LSTM_BWD_REL})")
    return max(diff.max().item(), (dw - want_dw).abs().max().item())


FAILED: list[str] = []


def check(fn, name: str, *args):
    """fn's error, or the failed check's message (kept in FAILED: the row is
    still timed, and the script exits with 1 at the end)."""
    try:
        return fn(name, *args)
    except AssertionError as e:
        FAILED.append(str(e))
        print(f"check failed: {e}", flush=True)
        return str(e)


def cudnn_fwd_bwd(rng, ndir: int, batch: int, dev, dtype):
    """cuDNN's one-layer LSTM over the same rows (bidirectional at ndir >= 2,
    over ndir / 2 * B rows), weights flattened: (forward, backward alone)."""
    bidir = ndir >= 2
    rows = batch * (ndir // 2 if bidir else 1)
    net = torch.nn.LSTM(HIDDEN, HIDDEN, batch_first=True, bidirectional=bidir, device=dev,
                        dtype=dtype)
    net.flatten_parameters()
    x = torch.from_numpy(rng.normal(size=(rows, SEQ_LEN, HIDDEN)).astype(np.float32)
                         ).to(dev).to(dtype).requires_grad_()
    out, _ = net(x)
    g = torch.randn_like(out)
    wrt = [x, *net.parameters()]

    def fwd():
        with torch.no_grad():
            net(x)

    return fwd, lambda: torch.autograd.grad(out, wrt, g, retain_graph=True)


def timed_row(meta: dict, cands: dict, libs: dict, errs: dict) -> dict:
    t = interleaved_ms(cands, iters=ITERS, repeats=ROUNDS, alternate=True)
    row = {**meta, "ms": {name: r["median"] for name, r in t.items()},
           "spread_ms": {name: [r["min"], r["max"]] for name, r in t.items()},
           "max_abs_err": errs}
    row["ms_per_step"] = {name: row["ms"][name] / meta["length"] for name in libs}
    row["library_ratio"] = {name: row["ms"][name] / row["ms"]["cudnn"] for name in libs}
    row["new_over"] = {name: row["ms"]["new"] / row["ms"][name]
                       for name in libs if name != "new"}
    row["kernel_us"] = {name: kernel_us(cands[name]) for name in libs}
    return row


def fwd_calls(libs: dict, symbol: str, xw, w, ndir: int, dev):
    """Each library's K1' entry point `symbol` on (xw, w), with its outputs."""
    length, rows, gates = xw.shape
    stream = build.stream_handle(dev)
    calls, outs = {}, {}
    for name, lib in libs.items():
        fn = checked(bind(lib, symbol, FWD_ARGS), f"{name} {symbol}")
        hs = torch.empty(length, rows, gates // 4, device=dev, dtype=xw.dtype)
        cs = torch.empty(length, rows, gates // 4, device=dev, dtype=torch.float32)
        args = [ctypes.c_void_p(t.data_ptr()) for t in (xw, w, hs, cs)] + \
            [length, rows // ndir, gates // 4, ndir, stream]
        calls[name] = lambda fn=fn, args=args, keep=(hs, cs): fn(*args)
        outs[name] = (hs, cs)
    return calls, outs


def bwd_calls(libs: dict, symbol: str, xw, w, hs, cs, dho, ndir: int, dev):
    """Each library's K2' entry point `symbol`, with its outputs and the
    wrapper's scratch arrays."""
    length, rows, gates = xw.shape
    bf16 = xw.dtype == torch.bfloat16
    stream = build.stream_handle(dev)
    calls, outs = {}, {}
    for name, lib in libs.items():
        fn = checked(bind(lib, symbol, BWD_BF16_ARGS if bf16 else BWD_ARGS),
                     f"{name} {symbol}")
        # each build with its own wrapper's chunks of dW_hh^T: this tree's
        # bf16 rule for "new", the parent's for the others
        splits = (lstm.dw_splits_bf16 if bf16 and name == "new" else lstm.dw_splits)(
            length, rows // ndir)
        partial, gf = lstm._bwd_scratch(xw, ndir, splits)
        dxw = torch.empty_like(xw)
        dw = torch.empty(w.shape, device=dev, dtype=torch.float32)
        scratch = [partial, gf] + ([torch.empty(xw.shape, device=dev, dtype=torch.float32)]
                                   if bf16 else [])
        args = [ctypes.c_void_p(t.data_ptr())
                for t in (xw, w, hs, cs, dho, dxw, dw, *scratch)] + \
            [length, rows // ndir, gates // 4, ndir, splits, stream]
        # the scratch arrays ride along with the call: the kernel writes
        # them at every launch, so they must outlive it
        calls[name] = lambda fn=fn, args=args, keep=scratch: fn(*args)
        outs[name] = (dxw, dw)
    return calls, outs


def kernel_rows(dev, libs: dict) -> list[dict]:
    rng = np.random.default_rng(14)
    rows = []
    cases = [(ndir, b, torch.bfloat16) for ndir, b in BF16_CASES] + [(2, 63, torch.float32)]
    for ndir, batch, dtype in cases:
        bf16 = dtype == torch.bfloat16
        suffix = "_bf16" if bf16 else ""
        xw, w = inputs(rng, SEQ_LEN, ndir, batch, dev, dtype)
        cudnn_fwd, cudnn_bwd = cudnn_fwd_bwd(rng, ndir, batch, dev, dtype)
        meta = {"ndir": ndir, "batch": batch, "length": SEQ_LEN, "dtype": str(dtype)[6:]}
        # K1'
        calls, outs = fwd_calls(libs, "rlt_lstm_fwd" + suffix, xw, w, ndir, dev)
        want = lstm.lstm_recurrence_plain(xw, w, ndir)
        errs = {}
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            errs[name] = check(fwd_check, f"{name} K1' {meta}", *outs[name], *want)
        row = timed_row({"kernel": "lstm_fwd" + suffix, **meta}, {**calls, "cudnn": cudnn_fwd},
                        libs, errs)
        log(row)
        rows.append(row)
        # K2' on the plain forward's hs and cs
        hs, cs = want
        dho = torch.from_numpy(rng.normal(size=tuple(hs.shape)).astype(np.float32)
                               ).to(dev).to(dtype)
        calls, outs = bwd_calls(libs, "rlt_lstm_bwd" + suffix, xw, w, hs, cs, dho, ndir, dev)
        want = lstm.lstm_bwd_plain(xw, w, hs, cs, dho, ndir)
        errs = {}
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            errs[name] = check(bwd_check, f"{name} K2' {meta}", *outs[name], *want)
        row = timed_row({"kernel": "lstm_bwd" + suffix, **meta}, {**calls, "cudnn": cudnn_bwd},
                        libs, errs)
        log(row)
        rows.append(row)
    return rows


def sweep_rows(dev, libs: dict) -> list[dict]:
    """K1' bf16 at L in SWEEP_L (B = 63, ndir = 2), every library in turns,
    and each library's least-squares line ms = intercept + slope L."""
    rng = np.random.default_rng(15)
    times = {name: [] for name in libs}
    rows = []
    for length in SWEEP_L:
        xw, w = inputs(rng, length, 2, 63, dev, torch.bfloat16)
        calls, _ = fwd_calls(libs, "rlt_lstm_fwd_bf16", xw, w, 2, dev)
        t = interleaved_ms(calls, iters=ITERS, repeats=ROUNDS, alternate=True)
        row = {"kernel": "lstm_fwd_bf16", "sweep": True, "ndir": 2, "batch": 63,
               "length": length, "ms": {n: r["median"] for n, r in t.items()},
               "spread_ms": {n: [r["min"], r["max"]] for n, r in t.items()}}
        for name in libs:
            times[name].append(row["ms"][name])
        log(row)
        rows.append(row)
    for name, ms in times.items():
        slope, intercept = np.polyfit(np.array(SWEEP_L, dtype=np.float64), np.array(ms), 1)
        fit = {"kernel": "lstm_fwd_bf16", "fit": name, "ms_per_step": float(slope),
               "intercept_ms": float(intercept)}
        log(fit)
        rows.append(fit)
    return rows


def swap(libs: dict, name: str):
    """Bind the bf16 LSTM wrappers' kernels to library `name`'s entry points."""
    lstm.LSTM_FWD_BF16._fn = bind(libs[name], "rlt_lstm_fwd_bf16", FWD_ARGS)
    lstm.LSTM_BWD_BF16._fn = bind(libs[name], "rlt_lstm_bwd_bf16", BWD_BF16_ARGS)


def through(libs: dict, name: str, fn):
    def call():
        swap(libs, name)
        return fn()
    return call


def ab_row(meta: dict, libs: dict, first: str, fn) -> dict:
    cands = {name: through(libs, name, fn) for name in (first, "new")}
    t = interleaved_ms(cands, iters=3, repeats=ROUNDS, alternate=True)
    row = {**meta, "ms": {n: r["median"] for n, r in t.items()},
           "spread_ms": {n: [r["min"], r["max"]] for n, r in t.items()}}
    for name, call in cands.items():
        busy = device_busy_ms(call)
        row[f"{name}_busy_ms"] = busy
        row[f"{name}_host_share"] = host_share(busy, row["ms"][name])
    swap(libs, "new")
    log(row)
    return row


def serving_rows(dev, libs: dict, first: str) -> list[dict]:
    from rlt_tpu_torch.config import TrainConfig
    from rlt_tpu_torch.infer import Predictor

    rows = []
    for model_name in ("mmoecut", "bicut"):
        cfg = TrainConfig(model_name=model_name, compute_dtype="bfloat16")
        predictor = Predictor(cfg, device=dev)
        rng = np.random.default_rng(5)
        for b in (64, 256):
            x = torch.from_numpy(rng.normal(size=(b, cfg.seq_len, cfg.input_size))
                                 .astype(np.float32)).to(dev)
            rows.append(ab_row({"model": model_name, "compute_dtype": "bfloat16",
                                "bucket": b}, libs, first,
                               lambda x=x: predictor._forward(x)))
    return rows


def training_rows(dev, libs: dict, first: str) -> list[dict]:
    from rlt_tpu_torch.config import TrainConfig, apply_preset
    from rlt_tpu_torch.train import Trainer, forward

    rows = []
    for model_name in ("mmoecut", "mtple", "attncut", "bicut"):
        cfg = apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04",
                                       compute_dtype="bfloat16"))
        trainer = Trainer(cfg, device=dev)
        idx, valid = trainer.data.plan(trainer.generator, "train")
        x, y, v = trainer.data.x_train[idx[0]], trainer.data.y_train[idx[0]], valid[0]
        model, opt = trainer.model, trainer.optimizer
        model.train()

        def step(model=model, opt=opt, trainer=trainer, x=x, y=y, v=v):
            opt.zero_grad()
            loss = trainer.criterion(forward(model, x, trainer.generator, trainer.dtype), y,
                                     valid=v)
            loss.backward()
            opt.step()

        rows.append(ab_row({"model": model_name, "compute_dtype": "bfloat16",
                            "batch": cfg.batch_size}, libs, first, step))
    return rows


def dh16_rows(dev) -> list[dict]:
    """K5' bf16 at dh = 16 against SDPA, device time of the kernels alone."""
    import torch.nn.functional as F

    rng = np.random.default_rng(16)
    heads, d, length = 8, 128, SEQ_LEN
    pack = attention.packed_group_size(d, heads)
    rows = []
    for n in (63, 256):
        q, k, v = (torch.from_numpy(rng.normal(size=(n, length, d)).astype(np.float32))
                   .to(dev).bfloat16() for _ in range(3))
        by_head = [t.view(n, length, heads, 16).transpose(1, 2) for t in (q, k, v)]
        streams = torch.from_numpy(rng.integers(-2**31, 2**31, size=n, dtype=np.int64)
                                   .astype(np.int32)).to(dev)
        for rate in (0.0, 0.1):
            cands = {
                "kernel": lambda: attention.attention_packed_fwd_bf16(q, k, v, heads, pack,
                                                                      rate, streams),
                "sdpa": lambda: F.scaled_dot_product_attention(*by_head, dropout_p=rate)}
            t = interleaved_ms(cands, iters=20, repeats=ROUNDS, alternate=True)
            dev_us = {name: kernel_us(fn, calls=20) for name, fn in cands.items()}
            device_ms = {name: sum(us.values()) / 1e3 for name, us in dev_us.items()}
            row = {"kernel": "attention_packed_fwd_bf16", "dh": 16, "n": n, "length": length,
                   "rate": rate, "window_ms": {k_: r["median"] for k_, r in t.items()},
                   "device_ms": device_ms, "device_us_by_kernel": dev_us,
                   "device_ratio": device_ms["kernel"] / device_ms["sdpa"],
                   "window_ratio": t["kernel"]["median"] / t["sdpa"]["median"]}
            log(row)
            rows.append(row)
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", type=Path, action="append", default=[])
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--serving", action="store_true")
    p.add_argument("--training", action="store_true")
    p.add_argument("--dh16", action="store_true")
    p.add_argument("--no-rows", action="store_true",
                   help="skip the kernel rows (with --sweep or --dh16 alone)")
    p.add_argument("--out", type=Path, default=REPO / "build" / "lstm_bf16_ab.json")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_lstm_bf16: no CUDA card is available", file=sys.stderr)
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
    if args.sweep:
        result["sweep"] = sweep_rows(dev, libs)
    if not args.no_rows:
        result["rows"] = kernel_rows(dev, libs)
    first = args.tree[0].name if args.tree else None
    if args.serving and first:
        result["serving"] = serving_rows(dev, libs, first)
    if args.training and first:
        result["training"] = training_rows(dev, libs, first)
    if args.dh16:
        result["dh16"] = dh16_rows(dev)
    result["seconds"] = time.perf_counter() - t0
    result["failed"] = FAILED
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(card, flush=True)
    if FAILED:
        print(f"{len(FAILED)} check(s) failed: {FAILED}", file=sys.stderr)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
