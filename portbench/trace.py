"""The traced run's reading of the profiler: every device operation of the
window, the net each kernel belongs to, the device's busy time, and the
longest idle gaps with what the host was doing.

The benchmark opens a profiler range around each net's forward (hooks it
registers on the program's nets) and around its own steps: each call of the
program's `run_sequence`, the labels' read-back, and its loop. A kernel
belongs to the net whose range was open on the host when the op that
launched it ran; a kernel with no such link (one launched through the
program's own ctypes binding) belongs where the kernel before it on the
stream does: one stream runs a net's work back to back. Where the profiler
also gives the ranges on the device's timeline, those decide.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

RANGE_PREFIX = "portbench."
NET_RANGE = RANGE_PREFIX + "net."


@dataclass
class Op:
    name: str
    start_ns: int
    end_ns: int
    kind: str  # "kernel", "memcpy", "memset"
    owner: str | None = None  # the net it belongs to


@dataclass
class Trace:
    """What the metric readers read. Times in seconds unless named _ns."""

    window_s: float
    tracked_frames: int
    ops: list
    host_run_s: float  # seconds the host spent inside the program's run_sequence calls
    launches: dict  # {kernel wrapper: launches in the window}, the program's counters
    cfg: dict  # the configuration file
    ranges: list = field(default_factory=list)  # host ranges (name, start_ns, end_ns)

    def kernels(self):
        return [op for op in self.ops if op.kind == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which any device operation ran (the union of intervals)."""
        total, end = 0, None
        for op in sorted(self.ops, key=lambda o: o.start_ns):
            if end is None or op.start_ns >= end:
                total += op.end_ns - op.start_ns
                end = op.end_ns
            elif op.end_ns > end:
                total += op.end_ns - end
                end = op.end_ns
        return total / 1e9


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _innermost(ranges, t_ns):
    """The latest-opened range (name, start, end) that holds t_ns."""
    best = None
    for name, s, e in ranges:
        if s <= t_ns < e and (best is None or s >= best[1]):
            best = (name, s, e)
    return best


def _net_at(nets, starts, t_ns):
    """The net whose range, of `nets` (never nested; `starts` their sorted
    starts), holds t_ns, or None."""
    i = bisect.bisect_right(starts, t_ns) - 1
    return nets[i][0][len(NET_RANGE):] if i >= 0 and t_ns < nets[i][2] else None


def read_profile(prof) -> tuple:
    """(device ops in the window with their owners, host ranges) from a
    torch.profiler.profile that traced CPU and CUDA activity. The window is
    the benchmark's "loop" range, in the profiler's own clock: it opens after
    the warm-up's last device op and closes after the window's last."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, host_ops, ranges, dev_ranges = [], {}, [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            if name.startswith(RANGE_PREFIX):
                dev_ranges.append((name, s, s + e.duration_ns()))
            elif e.duration_ns() > 0:
                device.append((Op(name, s, s + e.duration_ns(), _kind(name)),
                               e.linked_correlation_id()))
        elif e.linked_correlation_id() == 0:  # a host op or range, not a runtime call
            host_ops[e.correlation_id()] = e.start_ns()
            if name.startswith(RANGE_PREFIX):
                ranges.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    (_, lo, hi), = (r for r in ranges if r[0] == RANGE_PREFIX + "loop")
    device = sorted((d for d in device if lo <= d[0].start_ns < hi), key=lambda d: d[0].start_ns)
    nets = sorted((r for r in ranges if r[0].startswith(NET_RANGE)), key=lambda r: r[1])
    dev_nets = sorted((r for r in dev_ranges if r[0].startswith(NET_RANGE)), key=lambda r: r[1])
    net_starts, dev_starts = [r[1] for r in nets], [r[1] for r in dev_nets]
    owner, ops = None, []
    for op, link in device:
        if dev_nets:  # the ranges on the device's timeline decide
            owner = _net_at(dev_nets, dev_starts, op.start_ns)
        elif link in host_ops:  # the net whose range was open when the op ran
            owner = _net_at(nets, net_starts, host_ops[link])
        # else where the kernel before it on the stream is
        op.owner = owner if op.kind == "kernel" else None
        ops.append(op)
    return ops, ranges


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """The `top` longest stretches in which no device operation ran, each
    [what the host was doing, seconds]: "upload" where a host-to-device copy
    ends the gap, else the innermost of the benchmark's host ranges open at
    the gap's start (a net's forward, run_sequence, readback, loop)."""
    ops = sorted(trace.ops, key=lambda o: o.start_ns)
    gaps, end = [], None
    for op in ops:
        if end is not None and op.start_ns > end:
            gaps.append((op.start_ns - end, end, op))
        end = op.end_ns if end is None else max(end, op.end_ns)
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, start, after in gaps[:top]:
        if after.kind == "memcpy" and "htod" in after.name.lower():
            label = "upload"
        else:
            r = _innermost(trace.ranges, start)
            label = r[0][len(RANGE_PREFIX):] if r else "outside the benchmark's ranges"
        out.append([label, length / 1e9])
    return out


def top_ops(trace: Trace, top: int = 10) -> list:
    """The `top` device operations by total time, [name, seconds]."""
    totals = {}
    for op in trace.ops:
        totals[op.name] = totals.get(op.name, 0) + op.end_ns - op.start_ns
    return [[name, ns / 1e9] for name, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]
