"""Device timing on the card, shared by `infer.Predictor.forward_ms` and
`chip_smoke.py`.

`interleaved_ms` takes named candidates (a kernel, its plain version and a
library call; a population epoch and K sequential ones) and runs them in
turns, round after round, each round timing `iters` calls of each between
two CUDA events; it reports each one's median over the rounds with the
least and the most. Taking the candidates in turns inside one process puts
the host's and the card's drifts on all of them alike, and the median of
the rounds drops a round that a neighbour on the host slowed. A ratio of
two candidates is the ratio of their medians.

An event window on a step that the host cannot feed counts the host's gaps
as well as the card's work. `device_busy_ms` sums the device time of every
kernel, copy and fill that torch.profiler records over a few calls; beside
a window, host share = 1 - busy / window says how much of it the card sat
idle waiting for the host.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

REPEATS = 7


def interleaved_ms(candidates: dict[str, Callable], iters: int | dict[str, int] = 1,
                   repeats: int = REPEATS, warmup: int = 1,
                   alternate: bool = False) -> dict[str, dict]:
    """Each candidate's device ms per call: `repeats` rounds in which every
    candidate in turn runs `iters` calls (an int, or one per name) between
    two CUDA events; with `alternate`, odd rounds take the candidates in
    reverse order, so that none always follows the same one. Returns
    {name: {"median", "min", "max"}} over the rounds. Every candidate is
    called `warmup` times first. A device measurement: raises off the
    card."""
    if not torch.cuda.is_available():
        raise RuntimeError("interleaved_ms times the CUDA card, and none is available")
    counts = iters if isinstance(iters, dict) else dict.fromkeys(candidates, iters)
    for fn in candidates.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    rounds: dict[str, list[float]] = {name: [] for name in candidates}
    names = list(candidates)
    for r in range(repeats):
        for name in (names[::-1] if alternate and r % 2 else names):
            fn = candidates[name]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(counts[name]):
                fn()
            end.record()
            end.synchronize()
            rounds[name].append(start.elapsed_time(end) / counts[name])
    return {name: {"median": statistics.median(times), "min": min(times),
                   "max": max(times)} for name, times in rounds.items()}


def device_busy_ms(fn: Callable, calls: int = 3, warmup: int = 1) -> float | None:
    """The card's busy time per call of `fn`: the device time of every
    kernel, copy and fill that torch.profiler records over `calls` calls,
    summed (the port runs on one stream, so they do not overlap), over
    `calls`. It reads the profiler's raw events: building its event tree
    takes seconds a train step. None when the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy_ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)
    return busy_ns / 1e6 / calls if busy_ns > 0 else None


def host_share(busy_ms: float | None, window_ms: float) -> float | None:
    """1 - busy / window: the share of an event window in which the card
    waited for the host; None where the busy time was not measured."""
    return None if busy_ms is None else 1.0 - busy_ms / window_ms
