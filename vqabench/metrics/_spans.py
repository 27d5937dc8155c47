"""What the readers of the program's own spans compute.

The program (``vqa_tpu_torch.train.profiling``) keeps each closed span,
named ``vqa.<layer>.<phase>``, in an in-process log on the host's clock,
and while a profiler records mirrors it into the trace as a
``user_annotation``. Two readings, frozen here:

- host milliseconds: the median of a span's durations from the program's
  log, less its last ``ctx.steps`` calls (the traced steps, which the
  profiler slows); set-up's few calls are outliers the median ignores;
- device operations a step: each kernel, copy and memset of the trace is
  put down to the innermost ``vqa.`` span, on any thread, whose interval
  holds its launch (the ``cuda_runtime`` or ``cuda_driver`` event with the
  same ``correlation``).

A program without the log or without the span gives None.
"""

from __future__ import annotations

import statistics

from . import _trace

PREFIX = "vqa."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def program_durations(name: str) -> list | None:
    """Host seconds of each call of span ``name`` in the program's log, or
    None where the program keeps no such log."""
    try:
        from vqa_tpu_torch.train import profiling
    except ImportError:
        return None
    durations = getattr(profiling, "durations", None)
    return None if durations is None else durations(name)


def host_ms(ctx, name: str):
    """Median host ms of span ``name`` outside the traced steps."""
    d = program_durations(name)
    kept = d[:-ctx.steps] if d else None
    return 1e3 * statistics.median(kept) if kept else None


def program_spans(events: list) -> list[tuple[str, float, float]]:
    """The program's spans in a trace: (name, start us, end us)."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(PREFIX)]


def ops_by_span(events: list) -> dict[str, int]:
    """{span name: device operations launched while it was the innermost
    open program span}; operations launched outside every span are left out."""
    spans = sorted(program_spans(events), key=lambda s: s[2] - s[1])
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    out: dict[str, int] = {}
    for e in _trace.device_events(events):
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        inner = next((s for s in spans if s[1] <= t < s[2]), None)
        if inner is not None:
            out[inner[0]] = out.get(inner[0], 0) + 1
    return out


def ops_a_step(ctx, name: str):
    """Device operations a traced step put down to span ``name``."""
    if not any(s[0] == name for s in program_spans(ctx.events)):
        return None
    return ops_by_span(ctx.events).get(name, 0) / ctx.steps
