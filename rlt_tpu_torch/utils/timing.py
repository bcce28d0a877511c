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
(spans it draws around an op's kernels, gaps included) left out. The
profiler lengthens device work a little, so busy is held to the window of
the same calls in the same profiled session, timed with CUDA events around
them (the profiled window): host share = 1 - busy / profiled window says
how much of that window the card sat idle waiting for the host
(`busy_row`), and the profiler's stretch = profiled window / the window
of the same function timed without the profiler (`interleaved_ms`) is
printed beside it.

The profiler's device timestamps and the CUDA events are two clocks, and
in some sessions they disagree: on an H100 (torch 2.11) whole smokes read
a session's union 0.2-2% above its event window with its usual records,
or a graph's busy half its eager twin's. So each session brackets its
calls with two mark kernels right inside the CUDA events: the calls'
device records are clipped to the time between the marks
(`session_busy_ns`), and busy is that union's share of the marks' span
(first mark's start to second mark's end, the event window in the
profiler's clock) times the event window. Busy then lies within its
window by construction, and a scale fault of the profiler's clock
cancels; the ratio of the two clocks (marks' span over event window) is
kept beside it.

A profiled session may be handed device records of work done before it,
and may lose some of its own (`scripts/probe_device_busy.py` counts both):
`session_busy_ns` keeps only the device records that start after the
session's first host record (the card is idle when a session begins, so no
work of its calls starts before its first launch). A session may lose
records of the work launched as its tracing starts: in one process, 5 of
120 sessions of MtChoopy's eager bf16 train step kept 5464-5482 of its
5510 device records, 3 of them with device records that start before the
session's first host record (`scripts/probe_session_records.py` on an
H100, torch 2.11). So each session first runs HEAD_KERNELS spin kernels
and waits for them, and then the calls: a session that recorded none of
the spins may have lost the calls' first records, and is short. A session
is short too when it keeps fewer device records between its marks than
its calls are known to make: at least one a kernel launch that
`ops.KERNELS` counts in the session (a graph replay adds its captured
launches), or a caller's own count (a graph's eager twin's records). The
calls make the same device work in every session, so a session is short
as well when it keeps fewer than PEER_SHARE of the records of the fullest
session of its row (`pick_session`). `device_busy` takes, of
PROFILE_SESSIONS sessions (up to MAX_SESSIONS while all are short), the
complete session of the median busy, so that one session whose clock
misread its work does not make the row; a row whose every session is
short is a failed row. A loss that every session of a row shares alike is
seen only by a caller's own count.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

REPEATS = 7
PROFILE_SESSIONS = 3
MAX_SESSIONS = 6
# a session keeping fewer than this share of the device records of its
# row's fullest session lost some (`pick_session`)
PEER_SHARE = 0.9
# the spin kernels that open a profiled session (`torch.cuda._sleep`), about
# 2.5 ms of device work on an H100
HEAD_KERNELS, HEAD_CYCLES = 256, 20_000
# the two mark kernels around a session's calls, a few us each
MARK_CYCLES = 1_000
_SPIN = "spin_kernel"  # the name of both in the profiler's records


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


def session_busy_ns(records, between: tuple[int, int] | None = None) -> tuple[int, int]:
    """(records, busy) of one profiled session's records (start, end,
    on_device): the device records that start at or after the first host
    record's start, each clipped to `between` (the time between the
    session's marks) where it is given, those left empty dropped; and the
    union of their intervals (`union_ns`)."""
    records = list(records)
    first = min((start for start, _, on_device in records if not on_device), default=None)
    spans = [(start, end) for start, end, on_device in records
             if on_device and (first is None or start >= first)]
    if between is not None:
        lo, hi = between
        spans = [(max(start, lo), min(end, hi)) for start, end in spans]
        spans = [(start, end) for start, end in spans if end > start]
    return len(spans), union_ns(spans)


def _launches() -> int:
    from rlt_tpu_torch.ops import KERNELS

    return sum(kernel.launches for kernel in KERNELS.values())


def pick_session(sessions: list[tuple]) -> tuple[tuple | None, list[tuple]]:
    """(best, short) of a row's profiled sessions, each (head, records,
    need, busy, ...): `head` the opening spin kernels it recorded, `records`
    its device records, `need` the least its calls make. A session is
    complete when it recorded a spin kernel, keeps `need` records and at
    least PEER_SHARE of the records of the fullest such session; best is the
    complete one of the median busy (the lower middle one of an even
    count; None where none is complete), short the sessions that are not
    complete, in order."""
    full = [s for s in sessions if s[0] > 0 and s[1] >= max(s[2], 1)]
    top = max((s[1] for s in full), default=0)
    complete = [s for s in full if s[1] >= PEER_SHARE * top]
    ranked = sorted(complete, key=lambda s: s[3])
    return (ranked[(len(ranked) - 1) // 2] if ranked else None,
            [s for s in sessions if s not in complete])


def device_busy(fn: Callable, calls: int = 3, warmup: int = 1,
                sessions: int = PROFILE_SESSIONS,
                min_records: float | None = None) -> dict:
    """The card's busy ms per call of `fn`: the share of the time between
    two mark kernels around `calls` calls in which torch.profiler records a
    kernel, copy or fill of theirs (its annotations and the session's spin
    kernels left out), times the CUDA-event window of those calls, from the
    complete one of the profiled sessions of the median busy
    (`session_busy_ns`, `pick_session`). A session needs at least
    `min_records` device records a call, or, without it, one a kernel
    launch counted in the session. Returns {"busy_ms", "profiled_ms" (the
    CUDA-event window of the same session's calls, per call), "records"
    (the session's device records a call), "clock" (the marks' span in the
    profiler's clock over the event window), "sessions", "busy_each" (every
    complete session's busy ms, in order), "short" (each short session's
    device records a call)}; busy_ms, profiled_ms and clock are None where
    every session is short. It reads the profiler's raw events: building its
    event tree takes seconds a train step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    taken: list[tuple] = []
    while len(taken) < sessions or (pick_session(taken)[0] is None
                                    and len(taken) < MAX_SESSIONS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(HEAD_KERNELS):
                torch.cuda._sleep(HEAD_CYCLES)
            torch.cuda.synchronize()
            launched = _launches()
            start.record()
            torch.cuda._sleep(MARK_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(MARK_CYCLES)
            end.record()
            torch.cuda.synchronize()
        need = calls * min_records if min_records is not None else _launches() - launched
        events = [(e.start_ns(), e.end_ns(), e.device_type() == DeviceType.CUDA, e.name())
                  for e in prof.profiler.kineto_results.events() if not e.is_user_annotation()]
        spins = sorted((s, e) for s, e, on_device, name in events if on_device and _SPIN in name)
        window_ms = start.elapsed_time(end)
        # the last two spins are the marks: tracing loses records at its start
        head, marks = len(spins) - 2, spins[-2:]
        span = marks[1][1] - marks[0][0] if len(marks) == 2 else 0
        if span <= 0 or marks[1][0] <= marks[0][1]:
            taken.append((0, 0, need, 0.0, window_ms, None))
            continue
        records, busy_ns = session_busy_ns(
            ((s, e, on_device) for s, e, on_device, name in events
             if not (on_device and _SPIN in name)), between=(marks[0][1], marks[1][0]))
        taken.append((head, records, need, busy_ns / span * window_ms, window_ms,
                       span / 1e6 / window_ms))
    best, short = pick_session(taken)
    out = {"busy_ms": None, "profiled_ms": None, "records": None, "clock": None,
           "sessions": len(taken),
           "busy_each": [s[3] / calls for s in taken if s not in short],
           "short": [s[1] / calls for s in short]}
    if best is not None:
        out.update(busy_ms=best[3] / calls, profiled_ms=best[4] / calls,
                   records=best[1] / calls, clock=best[5])
    return out


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


def busy_row(busy: dict, window_ms: float | None) -> dict:
    """A `device_busy` result as a row: busy ms, the host share of the
    profiled window of the same session, the profiler's stretch (that
    window over `window_ms`, the function's window timed without the
    profiler), the session's records and clock ratio, and every complete
    session's busy. A row whose every session was short, or whose busy time
    is above its profiled window, is reported as failed, with no share."""
    busy_ms, profiled = busy["busy_ms"], busy["profiled_ms"]
    row = {"busy_ms": busy_ms, "profiled_ms": profiled,
           "stretch": (profiled / window_ms if profiled is not None and window_ms
                       else None),
           "records": busy["records"], "clock": busy.get("clock"),
           "sessions": busy["sessions"], "busy_each": busy.get("busy_each"),
           "short_sessions": busy["short"]}
    if busy_ms is None:
        return dict(row, failed=f"every one of {busy['sessions']} profiled sessions "
                                "kept fewer device records than its calls make")
    if busy_ms > profiled:
        return dict(row, failed=f"busy above its {profiled} ms profiled window")
    return dict(row, host_share=host_share(busy_ms, profiled))
