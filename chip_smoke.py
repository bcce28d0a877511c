#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rlt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `rlt_tpu_torch/csrc`, holds each one
against its plain PyTorch version on the card at the serving shapes and
times both, then serves MMOECut at robust04 width (L = 300, F = 3, float32,
seeded random weights) over HTTP through `TruncationService`, checks the
cuts against the same model run through the plain versions on the card,
and checks that the served requests went through the kernels. It prints a
`kernels` JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Any failed check raises, and the script
then exits with a non-zero code; without a CUDA card it exits before any
result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

SEQ_LEN, FEATURES, HIDDEN, HEADS, D_MODEL, EXPERTS = 300, 3, 128, 4, 256, 3
BATCHES = (63, 256)
# f32 tolerances on the card, kernel against plain version:
# - the LSTM carries h and c through 300 steps, each a 128-term dot product
#   summed in another order than cuBLAS sums it;
# - attention sums 300 scores of 64-term dot products, outputs O(1);
# - the served distributions are softmaxes over 300 positions mixed by
#   gates from a 76,800-term contraction of the LSTM outputs.
LSTM_ATOL = 1e-4
ATTN_ATOL = 1e-5
DIST_ATOL = 1e-5
# H100 SXM peak rates: HBM3 bandwidth, and dense f32 without tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# Phases 2 and 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_lstm(dev, rng) -> dict:
    from rlt_tpu_torch.ops import lstm

    rows = []
    for batch in BATCHES:
        xw = torch.from_numpy(rng.normal(size=(SEQ_LEN, batch, 4 * HIDDEN))
                              .astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.uniform(-1, 1, size=(HIDDEN, 4 * HIDDEN))
                              / np.sqrt(HIDDEN)).astype(np.float32)).to(dev)
        hs, cs = lstm.lstm_fwd(xw, w)
        torch.cuda.synchronize()
        want_hs, want_cs = lstm.lstm_recurrence_plain(xw, w)
        err = max((hs - want_hs).abs().max().item(), (cs - want_cs).abs().max().item())
        require(bool(torch.isfinite(hs).all()), "lstm_fwd: non-finite hs")
        require(err <= LSTM_ATOL, f"lstm_fwd B={batch}: max abs err {err} > {LSTM_ATOL}")
        ms = cuda_ms(lambda: lstm.lstm_fwd(xw, w), iters=20)
        plain_ms = cuda_ms(lambda: lstm.lstm_recurrence_plain(xw, w), iters=3, warmup=1)
        cudnn = torch.nn.LSTM(HIDDEN, HIDDEN, batch_first=True).to(dev)
        x_in = torch.from_numpy(rng.normal(size=(batch, SEQ_LEN, HIDDEN))
                                .astype(np.float32)).to(dev)
        with torch.no_grad():
            library_ms = cuda_ms(lambda: cudnn(x_in), iters=20)
        nbytes = 4 * (SEQ_LEN * batch * 4 * HIDDEN + HIDDEN * 4 * HIDDEN
                      + 2 * SEQ_LEN * batch * HIDDEN)
        flops = 2 * SEQ_LEN * batch * HIDDEN * 4 * HIDDEN + 10 * SEQ_LEN * batch * HIDDEN
        bound_ms, bound_by = bound(nbytes, flops)
        row = dict(batch=batch, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        log("lstm_fwd " + json.dumps(row))
        rows.append(row)
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


def check_attention(dev, rng) -> dict:
    from rlt_tpu_torch.ops import attention

    pack = attention.packed_group_size(D_MODEL, HEADS)
    dh = D_MODEL // HEADS
    rows = []
    for batch in BATCHES:
        n = EXPERTS * batch
        q, k, v = (torch.from_numpy(rng.normal(size=(n, SEQ_LEN, D_MODEL))
                                    .astype(np.float32)).to(dev) for _ in range(3))
        o, lse = attention.fused_attention_packed(q, k, v, heads=HEADS, pack=pack)
        torch.cuda.synchronize()
        want_o, want_lse = attention.attention_packed_plain(q, k, v, HEADS, pack)
        err = max((o - want_o).abs().max().item(), (lse - want_lse).abs().max().item())
        require(bool(torch.isfinite(o).all()), "attention_packed_fwd: non-finite o")
        require(err <= ATTN_ATOL,
                f"attention_packed_fwd N={n}: max abs err {err} > {ATTN_ATOL}")
        ms = cuda_ms(lambda: attention.fused_attention_packed(q, k, v, heads=HEADS,
                                                              pack=pack), iters=10)
        plain_ms = cuda_ms(lambda: attention.attention_packed_plain(q, k, v, HEADS, pack),
                           iters=10)
        heads4 = [t.view(n, SEQ_LEN, HEADS, dh).transpose(1, 2) for t in (q, k, v)]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads4), iters=10)
        nbytes = 4 * (4 * n * SEQ_LEN * D_MODEL + n * HEADS * SEQ_LEN)
        flops = 4 * n * HEADS * SEQ_LEN * SEQ_LEN * dh
        bound_ms, bound_by = bound(nbytes, flops)
        row = dict(n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        log("attention_packed_fwd " + json.dumps(row))
        rows.append(row)
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


# ---------------------------------------------------------------------------
# Phase 4: serving end to end
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_ops():
    """Route the model's two kernel calls to their plain versions (for the
    reference run on the card); restored on exit."""
    from rlt_tpu_torch.models import layers
    from rlt_tpu_torch.ops import attention, lstm

    saved = layers.fused_lstm, layers.fused_attention_packed
    layers.fused_lstm = lambda xw, w: lstm.lstm_recurrence_plain(xw, w)[0]
    layers.fused_attention_packed = (
        lambda q, k, v, heads, pack: attention.attention_packed_plain(q, k, v, heads, pack))
    try:
        yield
    finally:
        layers.fused_lstm, layers.fused_attention_packed = saved


def post(base: str, body: dict) -> dict:
    req = urllib.request.Request(f"{base}/truncate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def get(base: str, path: str) -> dict:
    with urllib.request.urlopen(f"{base}{path}", timeout=60) as r:
        return json.load(r)


def serve_end_to_end(rng) -> dict:
    from rlt_tpu_torch.config import TrainConfig
    from rlt_tpu_torch.ops import KERNELS
    from rlt_tpu_torch.serve import TruncationService, make_server

    cfg = TrainConfig(model_name="mmoecut", retrieve_data="robust04")
    require(cfg.seq_len == SEQ_LEN and cfg.input_size == FEATURES, "robust04 shapes")
    service = TruncationService(cfg, max_batch=256, device="cuda")
    predictor = service.predictor
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address
    requests = []
    for n_lists, want_dist in ((1, False), (5, True), (63, False)):
        lengths = rng.integers(1, SEQ_LEN + 1, size=n_lists)
        lengths[0] = SEQ_LEN
        feats = [rng.normal(size=(int(n), FEATURES)).astype(np.float32) for n in lengths]
        requests.append((lengths, feats, want_dist))
    try:
        health = get(base, "/healthz")
        require(health["ok"] and health["seq_len"] == SEQ_LEN, f"healthz: {health}")
        for kernel in KERNELS.values():  # the main path's counts start here
            kernel.launches = 0
        t0 = time.perf_counter()
        outs = [post(base, {"features": [f.tolist() for f in feats],
                            "return_distribution": want_dist})
                for _, feats, want_dist in requests]
        serve_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in KERNELS.items()}
        stats = get(base, "/stats")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    require(not thread.is_alive(), "server thread did not stop")
    log(f"served {len(outs)} requests in {serve_s:.3f} s (first dispatches "
        f"included); stats {json.dumps(stats)}")
    require(stats["requests"] == 3 and stats["dispatches"] == 3, f"stats: {stats}")
    require([o["bucket"] for o in outs] == [1, 8, 64], "buckets")
    require(launches == {"lstm_fwd": 4 * 3, "attention_packed_fwd": 3},
            f"kernel launches on the main path: {launches}")

    # the same model through the plain versions on the card
    worst_dist, near_ties = 0.0, 0
    for (lengths, feats, want_dist), out in zip(requests, outs):
        bucket = out["bucket"]
        x = np.zeros((bucket, SEQ_LEN, FEATURES), np.float32)
        for i, f in enumerate(feats):
            x[i, :len(f)] = f
        with plain_ops():
            ks_ref, dist_ref = predictor.predict_with_distribution(x)
        ks = np.asarray(out["k"])
        require(len(ks) == len(lengths) and np.all(ks >= 1) and np.all(ks <= lengths),
                f"k outside [1, length]: {ks.tolist()}")
        if want_dist:
            for i, d in enumerate(out["distribution"]):
                d = np.asarray(d)
                require(d.shape == (lengths[i],) and np.all(np.isfinite(d)), "dist shape")
                worst_dist = max(worst_dist,
                                 float(np.abs(d - dist_ref[i, :lengths[i]]).max()))
        # a cut may differ only where the reference's top two are within tolerance
        top2 = np.sort(dist_ref[:len(lengths)], axis=-1)[:, -2:]
        tied = (top2[:, 1] - top2[:, 0]) <= DIST_ATOL
        want_ks = np.minimum(ks_ref[:len(lengths)], lengths)
        require(np.all((ks == want_ks) | tied),
                f"cuts differ from the plain run: {ks.tolist()} vs {want_ks.tolist()}")
        near_ties += int(np.sum(tied))
    require(worst_dist <= DIST_ATOL, f"distribution err {worst_dist} > {DIST_ATOL}")
    log(f"served cuts equal the plain run; distributions max abs err "
        f"{worst_dist:.3e}; near-ties {near_ties}")

    timing = {}
    for b in (1, 8, 64, 256):
        timing[b] = predictor.forward_ms(b, iters=10)
        log(f"forward bucket {b}: {timing[b]} ms; stages {json.dumps(stage_ms(predictor.model, b))}")
    log(json.dumps({"lists_per_s": {"63 lists (bucket 64)": 63 / timing[64] * 1e3,
                                    "256 lists (bucket 256)": 256 / timing[256] * 1e3}}))
    return launches


@torch.inference_mode()
def stage_ms(model, batch: int, iters: int = 10) -> dict:
    """Device ms of each stage of one MMOECut forward at `batch`: the BiLSTM
    (4 lstm_fwd launches and the input projections), the expert stack (one
    attention_packed_fwd launch and the projections and FFN), and the gates
    with the towers."""
    x = torch.zeros(batch, SEQ_LEN, FEATURES, device="cuda")
    experts_in = model.pre_encoding(x)
    experts_o = model.experts(experts_in)
    return {"bilstm": cuda_ms(lambda: model.pre_encoding(x), iters),
            "experts": cuda_ms(lambda: model.experts(experts_in), iters),
            "gates_towers": cuda_ms(lambda: model.heads(experts_in, experts_o), iters)}


def bounds_to_port() -> dict:
    """bound_ms of the TPU kernels not ported yet, at the shapes of the
    MMOECut / PLECut training step (B = 63 lists, L = 300), from the bytes
    each must move once and its float32 operations."""
    b, length, h, d = 63, SEQ_LEN, HIDDEN, D_MODEL
    n = EXPERTS * b  # attention rows: experts x lists
    state = length * b * h
    # K2: reads xw, W_hh^T, hs, cs, dho; writes dxw, dW_hh^T. Recomputed
    # gates, the carried dh and dW_hh^T are each a (B, H) x (H, 4H) per step.
    lstm_bwd = bound(4 * (2 * (4 * state + h * 4 * h) + 3 * state), 3 * 2 * 4 * state * h)
    # K3 / K4: PLECut's per-slice attention, 2 heads of dh = 128.
    slices = n * 2 * length * 128
    attn_fwd = bound(4 * (4 * slices + n * 2 * length), 4 * slices * length)
    # backward: reads q, k, v, o, do, lse; writes dq, dk, dv; five L x L x dh
    # products (scores, dp, dv, dq, dk)
    attn_bwd = bound(4 * (8 * slices + n * 2 * length), 10 * slices * length)
    packed_bwd = bound(4 * (8 * n * length * d + n * HEADS * length),
                       10 * n * length * d * length)
    return {name: {"bound_ms": t, "bound_by": by} for name, (t, by) in (
        ("K2 lstm backward, one direction", lstm_bwd),
        ("K3 per-slice attention forward (PLECut)", attn_fwd),
        ("K4 per-slice attention backward (PLECut)", attn_bwd),
        ("K6 packed attention backward", packed_bwd))}


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
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("ptxas " + line.strip())

    rng = np.random.default_rng(0)
    lstm_res = check_lstm(dev, rng)
    attn_res = check_attention(dev, rng)
    launches = serve_end_to_end(rng)

    kernels = []
    for name, res, source, replaces, library in (
            ("lstm_fwd", lstm_res, "rlt_tpu_torch/csrc/lstm_fwd.cu",
             "rlt_tpu/ops/lstm.py:82",
             "torch.nn.LSTM (cuDNN), 1 layer 1 direction, input projection included"),
            ("attention_packed_fwd", attn_res,
             "rlt_tpu_torch/csrc/attention_packed_fwd.cu",
             "rlt_tpu/ops/attention.py:369",
             "torch.nn.functional.scaled_dot_product_attention")):
        row = res["rows"][0]  # the flagship batch of 63 lists
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": res["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_call": library, "batch": BATCHES[0]})
    log(json.dumps({"bounds_of_kernels_to_port": bounds_to_port()}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
