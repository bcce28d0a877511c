"""On a CUDA card: what torch.profiler hands `utils/timing.py::device_busy`
in one long process, and what capturable Adam costs the eager step.

It prints whether torch has the APIs the graph runner and the busy time
need (`CUDAGraph.register_generator_state`, `_KinetoEvent.is_user_annotation`).
Then, for bf16 train steps (Choopy, PLECut, MMOECut) and serving buckets
(bf16 BiCut at 64 and PLECut at 256, f32 BiCut at 64 and MtAttnCut at
256), graphed and eager, it times the
window in turns without the profiler (`interleaved_ms`, as `chip_smoke.py`
does) and profiles SESSIONS sessions of CALLS calls each. Each session's
JSON line counts its device records, the profiler's annotations among them,
the records that start before the session's first host record (work from
before the session) and those kept, with the plain sum of the device
records, their union with the annotations, the union of those kept
(`session_busy_ns`) and the CUDA-event window of the profiled calls, all
in ms per call. Each row then gives `device_busy` and `busy_row` against
the unprofiled window, as the smoke reads them. Last, the eager step of
Choopy and PLECut in bf16 with capturable Adam (the port's) against the
default Adam (the eager step before the graphs), with the graphed step, in
turns.

    python3 scripts/probe_device_busy.py
"""
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rlt_tpu_torch.config import TrainConfig, apply_preset  # noqa: E402
from rlt_tpu_torch.infer import Predictor  # noqa: E402
from rlt_tpu_torch.train import Trainer  # noqa: E402
from rlt_tpu_torch.utils.timing import (  # noqa: E402
    busy_row,
    device_busy,
    interleaved_ms,
    session_busy_ns,
    union_ns,
)

SESSIONS = 8
CALLS = 3


def cfg_of(model_name: str, dtype: str = "bfloat16") -> TrainConfig:
    cfg = apply_preset(TrainConfig(model_name=model_name, retrieve_data="robust04",
                                   compute_dtype=dtype))
    return dataclasses.replace(cfg, dropout=cfg.dropout or 0.1)


def sessions(fn) -> list[dict]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(SESSIONS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(CALLS):
                fn()
            end.record()
            torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        dev = [e for e in events if e.device_type() == DeviceType.CUDA]
        own = [e for e in dev if not e.is_user_annotation()]
        first = min(e.start_ns() for e in events
                    if e.device_type() != DeviceType.CUDA and not e.is_user_annotation())
        kept, busy = session_busy_ns(
            (e.start_ns(), e.end_ns(), e.device_type() == DeviceType.CUDA)
            for e in events if not e.is_user_annotation())
        out.append({
            "device_records": len(dev), "annotations": len(dev) - len(own),
            "before_session": sum(e.start_ns() < first for e in own),
            "kept": kept,
            "sum_ms": sum(e.duration_ns() for e in dev) / 1e6 / CALLS,
            "union_with_annotations_ms": union_ns((e.start_ns(), e.end_ns())
                                                  for e in dev) / 1e6 / CALLS,
            "busy_ms": busy / 1e6 / CALLS,
            "event_window_ms": start.elapsed_time(end) / CALLS})
    return out


def row(name: str, fns: dict) -> None:
    t = interleaved_ms(fns, 2, alternate=True)
    for route, fn in fns.items():
        for s in sessions(fn):
            print(json.dumps({"row": name, "route": route, **s}), flush=True)
        window = t[route]["median"]
        print(json.dumps({"row": name, "route": route, "window_ms": window,
                          "spread_ms": [t[route]["min"], t[route]["max"]],
                          **busy_row(device_busy(fn, CALLS), window)}), flush=True)


def trainers(model_name: str):
    cfg = cfg_of(model_name)
    graphed, eager = Trainer(cfg, device="cuda"), Trainer(cfg, device="cuda", graphs=False)
    idx, valid = graphed.data.plan(graphed.generator, "train")
    return cfg, graphed, eager, idx, valid


def main() -> None:
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    print(json.dumps({
        "register_generator_state": hasattr(torch.cuda.CUDAGraph, "register_generator_state"),
        "is_user_annotation": hasattr(torch._C._autograd._KinetoEvent, "is_user_annotation")}))
    for model_name in ("choopy", "mtple", "mmoecut"):
        cfg, graphed, eager, idx, valid = trainers(model_name)
        row(f"{model_name} bf16 step", {
            "graphed": lambda: graphed.train_batch(idx[0], valid[0]),
            "eager": lambda: eager.train_batch(idx[0], valid[0])})
        if model_name != "mmoecut":  # the eager step with the default Adam
            default = Trainer(cfg, device="cuda", graphs=False)
            default.optimizer = torch.optim.Adam(
                default.model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=cfg.weight_decay)
            t = interleaved_ms({
                "graphed": lambda: graphed.train_batch(idx[0], valid[0]),
                "eager capturable Adam": lambda: eager.train_batch(idx[0], valid[0]),
                "eager default Adam": lambda: default.train_batch(idx[0], valid[0])},
                2, alternate=True)
            print(json.dumps({"row": f"{model_name} bf16 step, Adam", **{
                k: [v["median"], v["min"], v["max"]] for k, v in t.items()}}), flush=True)
        del graphed, eager
    for model_name, dtype, b in (("bicut", "bfloat16", 64), ("mtple", "bfloat16", 256),
                                 ("bicut", "float32", 64), ("mtattncut", "float32", 256)):
        cfg = cfg_of(model_name, dtype)
        graphed, eager = Predictor(cfg, device="cuda"), Predictor(cfg, device="cuda",
                                                                    graphs=False)
        x = torch.randn(b, cfg.seq_len, cfg.input_size, device="cuda")
        row(f"{model_name} {dtype} bucket {b}", {"graphed": lambda: graphed._forward(x),
                                                 "eager": lambda: eager._forward(x)})


if __name__ == "__main__":
    main()
