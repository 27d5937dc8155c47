"""What the per-layer readers compute; each metric file binds one of these."""

from __future__ import annotations

from . import _trace, _work


def span_ms(ctx, name: str):
    """Milliseconds a step of the host span ``name``, from the measured
    window without the profiler (whose own cost would swell it)."""
    s = ctx.host_spans.get(name)
    return None if s is None else 1e3 * s


def encode_ms(ctx):
    return span_ms(ctx, "vqabench.encode")


def step_host_ms(ctx):
    return span_ms(ctx, "vqabench.train_step")


def device_ops(ctx):
    """Device kernels, copies and memsets a step."""
    n = len(_trace.device_events(ctx.events))
    return n / ctx.steps if n else None


def _groups(ctx) -> dict:
    """Device microseconds and calls of kernels A and B over the traced steps."""
    out = {}
    for e in _trace.device_events(ctx.events):
        g = _trace.group_of(e.get("name", ""), "", e["cat"])
        if g in (_trace.KERNEL_A, _trace.KERNEL_B):
            us, calls = out.get(g, (0.0, 0))
            out[g] = (us + float(e.get("dur", 0)), calls + 1)
    return out


def tower_ab_ms(ctx):
    """Device milliseconds a step of kernels A and B."""
    groups = _groups(ctx)
    return sum(us for us, _ in groups.values()) / 1e3 / ctx.steps if groups else None


def ab_roofline(ctx):
    """Percent: the least time kernels A and B could take on their calls
    (per group, the larger of bytes over HBM bandwidth and int8 operations
    over the int8 peak, from the VGG's shapes) over the time they took."""
    groups = _groups(ctx)
    if not groups:
        return None
    work = _work.vgg_int8_work(ctx.batch, ctx.config["image_size"])
    floor_s = 0.0
    for key, label, per_forward in (("A", _trace.KERNEL_A, 1), ("B", _trace.KERNEL_B, 7)):
        if label in groups:
            forwards = groups[label][1] / per_forward
            ops, moved = work[key]
            floor_s += forwards * max(ops / _work.INT8_OPS, moved / _work.HBM_BPS)
    took_s = sum(us for us, _ in groups.values()) / 1e6
    return 100.0 * floor_s / took_s


def mfu(ctx):
    """Percent: the step's least time at the peaks over its wall time."""
    ideal = _work.ideal_seconds(ctx.config, ctx.batch, ctx.kind == "train")
    return 100.0 * ideal / ctx.wall_s_per_step


def device_idle(ctx):
    """Percent of a step's wall time (without the profiler) in which no
    kernel or copy ran (busy time from the traced steps)."""
    device = _trace.device_events(ctx.events)
    if not device:
        return None
    busy_s = _trace.busy_us(_trace.intervals(device)) / 1e6 / ctx.steps
    return 100.0 * (1.0 - busy_s / ctx.wall_s_per_step)


def peak_mem_gib(ctx):
    """GiB: the device memory allocated at most during the measured window."""
    return ctx.window_peak_bytes / 2 ** 30 if ctx.window_peak_bytes else None
