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
as well as the card's work. `device_busy` takes the time in which the card
ran at least one kernel, copy or fill that torch.profiler records over a
few calls: the union of their intervals, overlaps merged (`union_ns`), so
that two activities at once count once, with the profiler's annotations
(spans it draws around an op's kernels, gaps included) left out. Beside
the window of the same function timed without the profiler
(`interleaved_ms`), host share = 1 - busy / window says how much of that
window the card sat idle waiting for the host (`busy_row`). A busy time
above its window is no share: `host_share` refuses it and `busy_row`
reports the row as failed.

A profiled session may be handed device records of work done before it,
and may lose some of its own (`scripts/probe_device_busy.py` counts both):
`session_busy_ns` keeps only the device records that start after the
session's first host record (the card is idle when a session begins, so no
work of its calls starts before its first launch), and `device_busy` takes,
of PROFILE_SESSIONS sessions, the one with the most such records.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

REPEATS = 7
PROFILE_SESSIONS = 3


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


def union_ns(intervals) -> int:
    """The length of the union of (start, end) intervals: overlapping and
    nested ones merged before summing, identical ones counted once."""
    total, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def session_busy_ns(records) -> tuple[int, int]:
    """(records, busy) of one profiled session's records (start, end,
    on_device): the device records that start at or after the first host
    record's start, and the union of their intervals (`union_ns`)."""
    records = list(records)
    first = min((start for start, _, on_device in records if not on_device), default=None)
    spans = [(start, end) for start, end, on_device in records
             if on_device and (first is None or start >= first)]
    return len(spans), union_ns(spans)


def device_busy(fn: Callable, calls: int = 3, warmup: int = 1,
                sessions: int = PROFILE_SESSIONS) -> float | None:
    """The card's busy ms per call of `fn`: the union of the device
    intervals of every kernel, copy and fill that torch.profiler records
    over `calls` calls (its annotations left out), from the one of
    `sessions` profiled sessions with the most records of its own
    (`session_busy_ns`); None where no session records device work. It
    reads the profiler's raw events: building its event tree takes seconds
    a train step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = (0, 0)
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        best = max(best, session_busy_ns(
            (e.start_ns(), e.end_ns(), e.device_type() == DeviceType.CUDA)
            for e in prof.profiler.kineto_results.events() if not e.is_user_annotation()))
    return best[1] / 1e6 / calls if best[1] > 0 else None


def host_share(busy_ms: float | None, window_ms: float | None) -> float | None:
    """1 - busy / window: the share of a window in which the card waited
    for the host; None where either was not measured. A busy time above
    its window raises ValueError: the two did not measure the same work,
    and no share is made of them."""
    if busy_ms is None or window_ms is None:
        return None
    if busy_ms > window_ms:
        raise ValueError(f"busy {busy_ms} ms above its {window_ms} ms window")
    return 1.0 - busy_ms / window_ms


def busy_row(busy_ms: float | None, window_ms: float | None) -> dict:
    """The busy time (`device_busy`) with the host share of the window of
    the same function timed without the profiler; a busy time above that
    window is reported as a failed row, with no share."""
    if busy_ms is not None and window_ms is not None and busy_ms > window_ms:
        return {"busy_ms": busy_ms, "failed": f"busy above its {window_ms} ms window"}
    return {"busy_ms": busy_ms, "host_share": host_share(busy_ms, window_ms)}
