"""Median host ms of a serving batch's inputs to the device: the image preprocess,
ids and lengths (the program's span vqa.serve.to_device), outside the traced batches."""

from vqabench.metrics import _spans


def read(ctx):
    return _spans.host_ms(ctx, "vqa.serve.to_device")
