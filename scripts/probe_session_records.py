"""On a CUDA card: which device records a profiled session loses.

MtChoopy's bf16 train step, eager and graphed (one CUDA graph a step), is
profiled SESSIONS times, CALLS steps a session, in one process, the way
`rlt_tpu_torch/utils/timing.py::device_busy` profiled it before its
sessions opened with spin kernels. Each session's device records are
grouped by the correlation id of the host call that launched them: a graph
replay's kernels share its `cudaGraphLaunch`'s. A session with fewer device
records than the most any session of its side kept prints one JSON line:
its records, the records of each graph replay in launch order, the records
whose launch the session did not record, and the start of its first device
record against its first host record (ms; negative: before it). Every
twentieth session prints too.

    python3 scripts/probe_session_records.py [SESSIONS]
"""
import collections
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rlt_tpu_torch.config import TrainConfig, apply_preset  # noqa: E402
from rlt_tpu_torch.train import Trainer  # noqa: E402

SESSIONS = int(sys.argv[1]) if len(sys.argv) > 1 else 120
CALLS = 5


def main() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = apply_preset(TrainConfig(model_name="mtchoopy", retrieve_data="robust04",
                                   compute_dtype="bfloat16"))
    cfg = dataclasses.replace(cfg, dropout=cfg.dropout or 0.1)
    trainers = {"eager": Trainer(cfg, device="cuda", graphs=False),
                "graphed": Trainer(cfg, device="cuda")}
    idx, valid = trainers["eager"].data.plan(trainers["eager"].generator, "train")
    most = dict.fromkeys(trainers, 0)
    for i in range(SESSIONS):
        for side, trainer in trainers.items():
            trainer.train_batch(idx[0], valid[0])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    trainer.train_batch(idx[0], valid[0])
                torch.cuda.synchronize()
            events = [e for e in prof.profiler.kineto_results.events()
                      if not e.is_user_annotation()]
            device = [e for e in events if e.device_type() == DeviceType.CUDA]
            host = [e for e in events if e.device_type() != DeviceType.CUDA]
            by_launch = collections.Counter(e.correlation_id() for e in device)
            host_ids = {e.correlation_id() for e in host}
            replays = sorted((e.start_ns(), e.correlation_id()) for e in host
                             if "GraphLaunch" in e.name())
            most[side] = max(most[side], len(device))
            if len(device) < most[side] or i % 20 == 0:
                print(json.dumps({
                    "session": i, "side": side, "device_records": len(device),
                    "most": most[side],
                    "records_by_replay": [by_launch.get(c, 0) for _, c in replays],
                    "records_launched_unrecorded": sum(
                        n for c, n in by_launch.items() if c not in host_ids),
                    "first_device_after_first_host_ms": (
                        min(e.start_ns() for e in device)
                        - min(e.start_ns() for e in host)) / 1e6}), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "torch": torch.__version__}))


if __name__ == "__main__":
    main()
