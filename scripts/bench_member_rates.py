#!/usr/bin/env python3
"""K3'-K6' at a shared dropout rate, this tree's build against another
tree's, every instance, on one CUDA card in one process.

    python3 scripts/bench_member_rates.py --tree DIR [--out build/member_rates_ab.json]

The attention kernels take a keep threshold and a scale per row where a
population's members differ in their dropout rate, and read the launch's
scalars otherwise. This times the shared-rate launches, the Trainer's and
the server's, at the Trainer's B = 63 shapes (packed dh 64 at N = 189 and
63 rows of 4 heads, packed dh 16 at N = 63 rows of 8 heads, PLECut's 378
slices of dh 128; L = 300), forward and backward, f32 and bf16, at rates
0 and 0.1, through this tree's entry points ("new") and DIR's (`git
archive <commit> rlt_tpu_torch/csrc | tar -x -C DIR`, built as this tree's
is by `ops/build.py`, its entry points bound with the arguments its own
sources take). Each pair first gives the same outputs bit for bit, then
both are timed in turns (`utils/timing.py::interleaved_ms`, 14 rounds of
20 calls, odd rounds reversed), medians with their spread, and each
build's kernels' device microseconds by name (torch.profiler).

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

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from bench_attention_bf16 import entry, kernel_us, load  # noqa: E402
from rlt_tpu_torch.ops import attention, build  # noqa: E402
from rlt_tpu_torch.utils.timing import interleaved_ms  # noqa: E402

SEQ_LEN = 300
RATE = 0.1
ROUNDS = 14
# (kind, dh, rows): the expert stacks' and the unstacked encoders' packed
# rows, Choopy's rows and PLECut's 189 rows of 2 slices, at B = 63
CASES = (("packed", 64, 189), ("packed", 64, 63), ("packed", 16, 63), ("slice", 128, 189))


def launcher(lib, kind: str, backward: bool, bf16: bool):
    """A caller of lib's entry point of the instance, in this tree's
    argument order (`bench_attention_bf16.entry`), that raises on an error."""
    symbol = (f"rlt_attention{'_packed' if kind == 'packed' else ''}"
              f"_{'bwd' if backward else 'fwd'}{'_bf16' if bf16 else ''}")
    fn = entry(lib, symbol)

    def call(*args):
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{symbol}: CUDA error {code}")
    return call


def rows_of(dev, libs: dict) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(21)
    stream = build.stream_handle(dev)
    null = ctypes.c_void_p(None)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for kind, dh, n in CASES:
            if kind == "packed":
                heads, d = (4, 256) if dh == 64 else (8, 128)
                pack = attention.packed_group_size(d, heads)
                shape, ints = (n, SEQ_LEN, d), [n, SEQ_LEN, heads, dh, pack]
                n_streams, lse_shape = n, (n, heads // pack, SEQ_LEN, pack)
                delta_shape = (n, heads, SEQ_LEN)
            else:
                shape, ints = (n, 2, SEQ_LEN, dh), [2 * n, SEQ_LEN]
                n_streams, lse_shape, delta_shape = 2 * n, (2 * n, 1, SEQ_LEN), (2 * n, SEQ_LEN)
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            streams = torch.randint(-2**31, 2**31 - 1, (n_streams,), generator=gen,
                                    device=dev).to(torch.int32)
            for rate in (0.0, RATE):
                threshold = attention.keep_threshold(rate)
                s_ptr = ctypes.c_void_p(streams.data_ptr() if rate > 0 else None)
                o = torch.empty_like(q)
                lse = torch.empty(lse_shape, device=dev)
                for backward in (False, True):
                    outs, cands = {}, {}
                    for name, lib in libs.items():
                        call = launcher(lib, kind, backward, bf16)
                        if backward:
                            res = [torch.empty_like(q) for _ in range(3)]
                            delta = torch.empty(delta_shape, device=dev)
                            ptrs = [q, k, v, o, do, lse]
                            tail = [*res, delta]
                        else:
                            res = [torch.empty_like(q), torch.empty(lse_shape, device=dev)]
                            ptrs, tail = [q, k, v, *res], []
                        args = ([ctypes.c_void_p(t.data_ptr()) for t in ptrs]
                                + [s_ptr, null, null]
                                + [ctypes.c_void_p(t.data_ptr()) for t in tail]
                                + ints + [rate, threshold, stream])
                        cands[name] = lambda call=call, args=args: call(*args)
                        cands[name]()
                        outs[name] = res
                    torch.cuda.synchronize()
                    if not backward:  # the backward's o and lse: this forward's
                        o.copy_(outs["new"][0])
                        lse.copy_(outs["new"][1])
                    same = all(torch.equal(a, b) for other in outs.values()
                               for a, b in zip(outs["new"], other))
                    if not same:
                        raise AssertionError(f"{kind} dh={dh} N={n} rate={rate} "
                                             f"{'bwd' if backward else 'fwd'} {dtype}: "
                                             "the builds' outputs differ")
                    t = interleaved_ms(cands, iters=20, repeats=ROUNDS, alternate=True)
                    row = {"kernel": f"{kind}_{'bwd' if backward else 'fwd'}",
                           "dtype": str(dtype).split(".")[-1], "dh": dh, "n": n,
                           "rate": rate, "bit_equal": same,
                           "ms": {name: r["median"] for name, r in t.items()},
                           "spread_ms": {name: [r["min"], r["max"]] for name, r in t.items()},
                           "kernel_us": {name: kernel_us(fn) for name, fn in cands.items()}}
                    row["new_over"] = {name: row["ms"]["new"] / ms
                                       for name, ms in row["ms"].items() if name != "new"}
                    print(json.dumps(row), flush=True)
                    out.append(row)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", type=Path, action="append", default=[], required=True)
    p.add_argument("--out", type=Path, default=REPO / "build" / "member_rates_ab.json")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_member_rates: no CUDA card is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    libs = {}
    for tree in args.tree:
        libs[tree.name], result[f"{tree.name}_build_seconds"] = load(
            tree / "rlt_tpu_torch" / "csrc")
    libs["new"], result["build_seconds"] = load(build.CSRC)
    result["rows"] = rows_of(dev, libs)
    result["seconds"] = time.perf_counter() - t0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
