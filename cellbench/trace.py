"""What a traced window's ``torch.profiler`` record says, for the per-layer
readers under ``metrics/``.

Device time is attributed by the launch's correlation: each device
activity shares its correlation id with the CUDA runtime call that
launched it, and that call's chain of parents on the host names the spans
it ran under (the program's ``step.*``, ``render.*`` and ``eval.*``
ranges), whether an aten op or a hand-written kernel's binding made the
call. ``loss.backward()`` runs
its kernels on autograd's own thread, under no span: those are attributed
by the ``autograd::engine`` event at the root of their chain. Device busy
time is the union of the device activities' intervals (kernels, copies,
sets), so two streams that overlap count once. The arithmetic of busy
share and outermost aten ops is ``chip_smoke.py``'s ``phase_profile``.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

from torch.autograd import DeviceType

SPAN_PREFIXES = ("step.", "render.", "eval.")
BACKWARD = "autograd::engine::evaluate_function"
# the CUDA runtime calls that launch device work
RUNTIME = ("cuda", "cuLaunch")


def _is_cpu(e) -> bool:
    return e.device_type == DeviceType.CPU


def outermost_aten(e) -> bool:
    """An aten op that no other aten op called: one op the host dispatched."""
    if not e.name.startswith("aten::"):
        return False
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith("aten::"):
            return False
        p = p.cpu_parent
    return True


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceView:
    """The traced window's numbers. ``units``: what one per-unit metric
    divides by ({"iterations": n} or {"images": n, "chunks": m}); ``counters``
    and ``counts``: the program's counters and the yardstick's counts for
    the window."""

    def __init__(self, prof, window_s: float, mode: str, units: dict, counters: dict,
                 counts: dict):
        self.window_s, self.mode = window_s, mode
        self.units, self.counters, self.counts = units, counters, counts
        events = prof.events()
        cpu = [e for e in events if _is_cpu(e)]
        # the spans also appear on the device's timeline (annotations):
        # a device event named as a host event is one of those, no work
        names = {e.name for e in cpu}
        dev = [e for e in events if not _is_cpu(e) and e.name not in names]
        outer = [e for e in cpu if outermost_aten(e)]
        self.aten_ops = len(outer)
        # device activities, by name and as a union of intervals (us)
        by_name = defaultdict(float)
        for e in dev:
            by_name[e.name] += e.time_range.end - e.time_range.start
        self.device_by_name = dict(by_name)
        busy = _union([[e.time_range.start, e.time_range.end] for e in dev])
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        # each activity's launch (the runtime call with its correlation id)
        # and the spans that hold the launch
        launch = {e.id: e for e in cpu if e.name.startswith(RUNTIME)}
        span_us, claimed, unlinked = defaultdict(float), 0.0, 0.0
        for d in dev:
            us = d.time_range.end - d.time_range.start
            r = launch.get(d.id)
            if r is None:
                unlinked += us
                continue
            found, root, p = set(), r, r
            while p is not None:
                if p.name.startswith(SPAN_PREFIXES):
                    found.add(p.name)
                root = p
                p = p.cpu_parent
            if not found and root.name.startswith(BACKWARD):
                found.add("backward")
            for n in found:
                span_us[n] += us
            claimed += us if found else 0.0
        total = sum(by_name.values())
        self.span_ms = {k: v / 1e3 for k, v in span_us.items()}
        self.kernel_ms_total = total / 1e3
        self.unclaimed_ms = (total - claimed - unlinked) / 1e3
        self.unlinked_ms = unlinked / 1e3
        self._gaps(busy, cpu)
        self._host(cpu, outer)

    def _gaps(self, busy: list, cpu: list) -> None:
        """Idle gaps between device activities, each named by the span the
        host was in at the gap's middle (a ``render.*`` span before the
        ``step.*`` or ``eval.*`` one that holds it)."""
        fams = []
        for pref in (("render.",), ("step.", "eval.")):
            sp = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                        if e.name.startswith(pref))
            fams.append(([s for s, _, _ in sp], sp))
        by = defaultdict(float)
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid, name = (e0 + s1) / 2, "outside spans"
            for starts, sp in fams:
                i = bisect.bisect_right(starts, mid) - 1
                if i >= 0 and sp[i][1] > mid:
                    name = sp[i][2]
                    break
            by[name] += (s1 - e0) / 1e6
        self.idle_by_span = dict(by)

    def _host(self, cpu: list, outer: list) -> None:
        """Host time of each span (the sum of its ranges), the outermost
        aten ops dispatched in it, and those that took most host time:
        {span: {"host_ms", "aten_ops", "top": [[op, host ms, count], ...]}}."""
        spans = defaultdict(lambda: dict(host_ms=0.0, aten_ops=0, ops=defaultdict(lambda: [0.0, 0])))
        for e in cpu:
            if e.name.startswith(SPAN_PREFIXES):
                spans[e.name]["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        for e in outer:
            p = e.cpu_parent
            while p is not None and not p.name.startswith(SPAN_PREFIXES):
                p = p.cpu_parent
            rec = spans["outside spans" if p is None else p.name]
            rec["aten_ops"] += 1
            op = rec["ops"][e.name]
            op[0] += (e.time_range.end - e.time_range.start) / 1e3
            op[1] += 1
        self.host_by_span = {
            k: dict(host_ms=v["host_ms"], aten_ops=v["aten_ops"],
                    top=[[n, ms, c] for n, (ms, c) in
                         sorted(v["ops"].items(), key=lambda kv: -kv[1][0])[:8]])
            for k, v in spans.items()}

    def span_device_ms(self, names) -> float:
        return sum(self.span_ms.get(n, 0.0) for n in names)

    def kernel_device_ms(self, pattern: str) -> float:
        """Device ms of the activities whose name matches ``pattern`` (a
        regular expression, searched)."""
        rx = re.compile(pattern)
        return sum(v for k, v in self.device_by_name.items() if rx.search(k)) / 1e3

    def breakdown(self) -> dict:
        top = sorted(self.device_by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return dict(device_ops=[[k, v / 1e6] for k, v in top],
                    idle_gaps=[[k, v] for k, v in gaps])
