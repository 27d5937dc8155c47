"""Device kernels, copies and memsets a step launched inside the program's span
vqa.train.backward (a count: it repeats exactly)."""

from vqabench.metrics import _spans


def read(ctx):
    return _spans.ops_a_step(ctx, "vqa.train.backward")
