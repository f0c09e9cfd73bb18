"""One profiled stretch of whole calls, reduced to what the metric readers
and the result's `breakdown` need.

`torch.profiler` records the host's operations and every device
operation (kernels, copies, sets) with their intervals and the card each
ran on.  From them, card by card over the cell's cards: a card's busy
time = the union of its own device intervals, and its idle gaps between
them, each named by the innermost host operation that was running at its
middle; then device busy = the mean of the cards' busy times, and the
idle seconds per host operation summed over the cards.  Besides: each
device operation's total time by name and the count of device
operations, over every card; and the host wall of the stretch, read on
the host clock around calls that each end in a synchronise of every
card.  With one card, busy is the union of every device interval.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import torch

RANGE = "bench.call"          # the range around each call; its device-side copy is no device work


@dataclasses.dataclass
class Trace:
    calls: int
    wall_s: float
    busy_s: float                               # the mean over the cards of busy_s_by_card
    busy_s_by_card: list[float]                 # each card's union of its device intervals, in card order
    device_ops: int
    device_by_name: dict[str, float]            # seconds per device operation name
    gaps_by_host: dict[str, float]              # idle seconds per host operation name
    outputs: list                               # each profiled call's output

    def kernel_seconds(self, names: tuple[str, ...]) -> float:
        """Device seconds of the kernels whose function name (without its
        namespace, template and arguments) is one of `names`."""
        return sum(s for k, s in self.device_by_name.items() if base_name(k) in names)

    def idle_pct(self) -> float:
        """1 - device busy (per card the union of every kernel, copy and
        set interval, averaged over the cards) / the host wall of the
        profiled whole calls, percent: the cards' mean idle share."""
        return 100.0 * (1.0 - self.busy_s / self.wall_s)

    def busy_ms_per_call(self) -> float:
        return 1e3 * self.busy_s / self.calls

    def launches_per_call(self) -> float:
        """Device operations (kernels, copies, sets) on every card per call:
        the launches of the chunk step's host dispatch."""
        return self.device_ops / self.calls

    def breakdown(self) -> dict:
        top = lambda d: [[k[:64], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(self.device_by_name), "idle_gaps": top(self.gaps_by_host)}


def for_op(op: str, value):
    """A metric reader giving `value(trace)` in the cells of operation `op`
    and nothing in the others."""
    return lambda ctx: value(ctx["trace"]) if ctx["op"] == op else None


def base_name(kernel: str) -> str:
    """"void (anonymous namespace)::qmf_taps_kernel<4>(float const*, ...)" -> "qmf_taps_kernel"."""
    head = kernel.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return head.split("::")[-1].split(" ")[-1]


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge intervals [(start, end)] into disjoint sorted ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: list[tuple[float, float]], start: float, end: float) -> list[tuple[float, float]]:
    """The idle stretches of [start, end] between merged busy intervals."""
    out, t = [], start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def name_gaps(idle: list[tuple[float, float]], host: list[tuple[float, float, str]]) -> dict[str, float]:
    """Seconds of idle time per host operation: each gap goes to the
    innermost (latest started) host operation running at its middle, or
    to "(no host op)"."""
    out: dict[str, float] = collections.defaultdict(float)
    host = sorted(host)
    starts = [h[0] for h in host]
    for s, e in idle:
        mid = (s + e) / 2
        best = "(no host op)"
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[j][1] >= mid:
                best = host[j][2]
                break
        out[best] += e - s
    return dict(out)


def per_card(device: list[tuple[int, float, float]], host: list[tuple[float, float, str]],
             cards: list[int]) -> tuple[list[float], dict[str, float]]:
    """(each card's busy seconds, the idle seconds per host operation summed
    over the cards) of device intervals [(card, start, end)] within the
    host's `RANGE` calls, for the card indices `cards` (a card with no
    interval is idle throughout)."""
    calls = [(s, e) for s, e, name in host if name == RANGE]
    start = min(s for s, _ in calls) if calls else 0.0
    end = max(e for _, e in calls) if calls else 0.0
    busy, idle = [], collections.defaultdict(float)
    for card in cards:
        merged = union([(s, e) for c, s, e in device if c == card])
        busy.append(sum(e - s for s, e in merged))
        for name, seconds in name_gaps(gaps(merged, start, end), host).items():
            idle[name] += seconds
    return busy, dict(idle)


def profile(call, n: int, sync, cards: list[int]) -> Trace:
    """Run `call(j)` for j in range(n) under the profiler, each inside a
    `RANGE` range and ending in `sync()`; reduce the trace over the card
    indices `cards`."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    outputs = []
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        for j in range(n):
            with torch.profiler.record_function(RANGE):
                outputs.append(call(j))
                sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev_iv, host_iv, by_name = [], [], collections.defaultdict(float)
    for ev in events:
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.name == RANGE:
                continue
            dev_iv.append((ev.device_index, s, e))
            by_name[ev.name] += e - s
        else:
            host_iv.append((s, e, ev.name))
    busy, idle = per_card(dev_iv, host_iv, cards)
    return Trace(calls=n, wall_s=wall, busy_s=sum(busy) / len(busy), busy_s_by_card=busy, device_ops=len(dev_iv),
                 device_by_name=dict(by_name), gaps_by_host=idle, outputs=outputs)
