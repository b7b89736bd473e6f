"""Named ranges of the port's host work, for ``torch.profiler`` and a host
clock of their own.

``spans("render.traverse")`` closes the previous range and opens the next;
``spans.close()`` ends the last. ``with span("image.render"):`` is one
range around a block. Each range is a ``torch.profiler.record_function``:
with no profiler running it costs a few microseconds of host time and
records nothing, so the profiler's record and the host table below see
the same boundaries.

The host table. After ``collect(True)`` each range also records, in
memory, on the host's clock (``time.perf_counter_ns``): its entry count,
its host ns in total and in itself (its total less the ranges that ran
inside it on the same thread), the ns it spent as the outermost range of
the main thread, and the name of the range that held its latest entry. Ranges nest on a
stack a thread, which every ``Spans`` of the thread shares: the
trainer's ``step.render`` holds the renderer's ``render.*``, and a
backward that autograd runs on a thread of its own starts a stack there.
``snapshot()`` returns the table as a plain dict, ``diff`` the change
between two snapshots, ``current()`` the innermost range open on the
calling thread. While not collecting a boundary adds one branch to the
profiler range and touches no tensor.

Names: ``step.*`` / ``eval.*`` and ``render.*`` are families of
consecutive ranges (never one of a family inside another of it on a
thread); ``setup.*``, ``build.*``, ``backward.*`` and ``image.*`` hold or
sit inside them.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_collecting = False
_local = threading.local()
_lock = threading.Lock()
# name -> [count, total_ns, self_ns, top_ns, parent]
_table: dict[str, list] = {}
_FIELDS = ("count", "total_ns", "self_ns", "top_ns")


class _Frame:
    __slots__ = ("name", "t0", "child_ns", "stack")

    def __init__(self, name: str, stack: list):
        self.name, self.stack, self.child_ns = name, stack, 0
        self.t0 = time.perf_counter_ns()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _push(name: str) -> _Frame:
    st = _stack()
    f = _Frame(name, st)
    st.append(f)
    return f


def _pop(f: _Frame) -> None:
    t = time.perf_counter_ns()
    st = f.stack
    if f not in st:
        return
    while st[-1] is not f:              # ranges an exception left open
        st.pop()
    st.pop()
    dt = t - f.t0
    parent = st[-1] if st else None
    if parent is not None:
        parent.child_ns += dt
    top = parent is None and threading.current_thread() is threading.main_thread()
    with _lock:
        rec = _table.get(f.name)
        if rec is None:
            rec = _table[f.name] = [0, 0, 0, 0, None]
        rec[0] += 1
        rec[1] += dt
        rec[2] += dt - f.child_ns
        rec[3] += dt if top else 0
        rec[4] = None if parent is None else parent.name


def collect(on: bool) -> bool:
    """Record the host table from now on (or stop); returns the previous
    setting. Ranges open at the switch are recorded if they opened while
    collecting."""
    global _collecting
    was, _collecting = _collecting, bool(on)
    return was


def snapshot() -> dict:
    """The table of the ranges closed so far: {name: {"count", "total_ns",
    "self_ns", "top_ns", "parent"}}."""
    with _lock:
        return {k: dict(zip(_FIELDS + ("parent",), v)) for k, v in _table.items()}


def diff(after: dict, before: dict) -> dict:
    """The table of what closed between two snapshots."""
    out = {}
    for k, v in after.items():
        b = before.get(k, {})
        d = {f: v[f] - b.get(f, 0) for f in _FIELDS}
        if d["count"]:
            out[k] = dict(d, parent=v["parent"])
    return out


def current() -> str | None:
    """The innermost range open on the calling thread (known while
    collecting), or None."""
    st = _stack()
    return st[-1].name if st else None


class Spans:
    """Consecutive ranges: each call closes the open one and opens the next."""

    __slots__ = ("_cur", "_frame")

    def __init__(self):
        self._cur = None
        self._frame = None

    def __call__(self, name: str) -> None:
        self.close()
        self._cur = torch.profiler.record_function(name)
        self._cur.__enter__()
        if _collecting:
            self._frame = _push(name)

    def close(self) -> None:
        if self._frame is not None:
            _pop(self._frame)
            self._frame = None
        if self._cur is not None:
            self._cur.__exit__(None, None, None)
            self._cur = None


@contextlib.contextmanager
def span(name: str):
    """One range around a block."""
    s = Spans()
    s(name)
    try:
        yield
    finally:
        s.close()
