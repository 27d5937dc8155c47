"""Throughput and traces of the training loop (port of
vqa_tpu/train/profiling.py).

:class:`SyncedRateTracker`: PyTorch returns from a CUDA step before the card
has run it, so a host clock read right after dispatch measures the enqueue.
The tracker is marked only where a device value was just fetched (the loss,
read at each log interval) and derives steps per second from the (step,
time) deltas between those points.

:class:`ProfileWindow`: ``--profile_steps N``, a ``torch.profiler`` trace of
N train steps from the first step >= 3 (warm-up excluded), written into the
run directory as a Chrome trace (the host's operations and, on the card,
its kernels and copies): the counterpart of vqa_tpu's ``profile_trace``
around the same window (vqa_tpu/main.py:658-695).

:func:`span`: a named interval of host time around one phase of a train
step or a serving batch (the names are ``vqa.<layer>.<phase>``; README,
"Spans"). Each closed span appends a :class:`SpanRecord` (name, start and
end on ``time.perf_counter_ns``, its own id, the innermost span open on the
same thread when it opened, and the outermost, so all spans of one step or
batch share a root) to a process-wide log, :data:`LOG`, of the newest
:data:`SPAN_CAPACITY` records. While a ``torch.profiler`` session records,
the span also enters ``record_function``, so it shows in the Chrome trace
as a ``user_annotation`` on the clock of the kernels it launched; with no
profiler it touches no profiler API. Under ``torch.compile`` or
``torch.export`` tracing it records nothing, so no profiler op is captured.

:func:`count`: a named counter of device values (``vqa.<layer>.<what>``),
summed on the device where they were made, so counting adds one addition
kernel and no synchronisation; :func:`counter` reads it to the host (and
waits for the card then).
"""

from __future__ import annotations

import itertools
import os
import statistics
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
import torch.autograd.profiler as autograd_profiler

PROFILE_START_STEP = 3
SPAN_CAPACITY = 65536


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None     # the innermost span open on this thread at the start
    root: int              # the outermost; its own id for a root span

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class SpanLog:
    """A bounded log of closed spans, kept in memory (see the module's doc).

    Records are kept as plain tuples and become :class:`SpanRecord` s when
    read. No lock: a deque's ``append`` and ``copy`` each run in C under the
    interpreter lock, so a reader never sees a half-made record."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._records: deque[tuple] = deque(maxlen=capacity)
        self._local = threading.local()
        self._ids = itertools.count(1)

    def span(self, name: str) -> "_Span":
        return _Span(self, name)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def records(self, since: int | None = None) -> list[SpanRecord]:
        """The kept records in the order they closed; with ``since`` (a
        ``perf_counter_ns`` reading) only those that started at or after it."""
        return [SpanRecord._make(r) for r in self._records.copy()
                if since is None or r[1] >= since]

    def durations(self, name: str) -> list[float]:
        """Host seconds of each kept call of ``name``, in the order they closed."""
        return [r.seconds for r in self.records() if r.name == name]

    def self_seconds(self, since: int | None = None) -> dict[int, float]:
        """{span id: its duration less the time its kept children cover}. A
        child opens and closes inside its parent on the parent's thread, and
        siblings one after another, so what they cover is their sum."""
        records = self.records(since)
        out = {r.id: r.seconds for r in records}
        for r in records:
            if r.parent in out:
                out[r.parent] -= r.seconds
        return out

    def summary(self, since: int | None = None) -> dict[str, dict]:
        """{name: {"count", "median_ms", "p95_ms"}} over the kept records
        (those started at or after ``since``, if given)."""
        by_name: dict[str, list[float]] = {}
        for r in self.records(since):
            by_name.setdefault(r.name, []).append(1e3 * r.seconds)
        out = {}
        for name, ms in sorted(by_name.items()):
            p95 = statistics.quantiles(ms, n=20, method="inclusive")[18] if len(ms) > 1 else ms[0]
            out[name] = {"count": len(ms), "median_ms": statistics.median(ms), "p95_ms": p95}
        return out


class _Span:
    __slots__ = ("log", "name", "stack", "start", "id", "parent", "root", "rf")

    def __init__(self, log: SpanLog, name: str):
        self.log, self.name, self.rf = log, name, None

    def __enter__(self):
        if torch.compiler.is_compiling():
            self.id = None
            return self
        self.stack = stack = self.log._stack()
        self.id = next(self.log._ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[0].id
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        if autograd_profiler._is_profiler_enabled:
            self.rf = autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.id is None:
            return False
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        self.log._records.append((self.name, self.start, end, self.id, self.parent,
                                  self.root))
        return False


LOG = SpanLog()


def span(name: str) -> _Span:
    """A span of ``name`` in the process-wide :data:`LOG`."""
    return _Span(LOG, name)


def durations(name: str) -> list[float]:
    """Host seconds of each kept call of ``name`` in :data:`LOG`, in order."""
    return LOG.durations(name)


def summary(since: int | None = None) -> dict[str, dict]:
    """:meth:`SpanLog.summary` of :data:`LOG`."""
    return LOG.summary(since)


COUNTERS: dict[str, torch.Tensor] = {}


def count(name: str, values: torch.Tensor) -> None:
    """Add ``values`` (a tensor of a fixed shape for ``name``) to the counter
    ``name``, on their device."""
    if torch.compiler.is_compiling():
        return
    held = COUNTERS.get(name)
    if held is None:
        COUNTERS[name] = values.detach().clone()
    else:
        held.add_(values.detach())


def counter(name: str) -> list | None:
    """The counter ``name``'s sums as a (nested) list, or None if nothing was counted."""
    held = COUNTERS.get(name)
    return None if held is None else held.tolist()


def counter_names(prefix: str = "") -> list[str]:
    return sorted(n for n in COUNTERS if n.startswith(prefix))


class SyncedRateTracker:
    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._last: tuple[int, float] | None = None
        self._rate = 0.0

    def mark(self, step: int) -> None:
        """Call immediately after fetching a device value at ``step``."""
        now = time.perf_counter()
        if self._last is not None:
            dsteps = step - self._last[0]
            dt = now - self._last[1]
            if dsteps > 0 and dt > 0:
                self._rate = dsteps / dt
        self._last = (step, now)

    @property
    def steps_per_sec(self) -> float:
        return self._rate

    @property
    def qa_pairs_per_sec(self) -> float:
        return self._rate * self.batch_size

    def summary(self) -> str:
        return (f"{self.steps_per_sec:.2f} steps/s | "
                f"{self.qa_pairs_per_sec:.0f} QA-pairs/s")


class ProfileWindow:
    """A trace of ``steps`` train steps; call :meth:`before_step` at the top
    of every step and :meth:`close` when the loop ends. Each returns the
    trace's path when it has just written it, else None."""

    def __init__(self, log_dir: str, steps: int):
        self.log_dir = log_dir
        self.steps = steps
        self._prof = None
        self._span = None
        self.done = steps <= 0

    def before_step(self, step: int) -> str | None:
        if self.done:
            return None
        if self._prof is None:
            if step >= PROFILE_START_STEP:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.start()
                self._span = (step, step + self.steps)
            return None
        return self.close() if step >= self._span[1] else None

    def close(self) -> str | None:
        if self.done or self._prof is None:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.done = True
        path = os.path.join(self.log_dir, f"profile_steps_{self._span[0] + 1}-"
                                          f"{self._span[1]}.pt.trace.json")
        self._prof.export_chrome_trace(path)
        return path
