"""Offline scoring by one client: a closed loop of batches.

Each batch is ``batch`` uint8 images at the model's size, from a ring of
``image_ring`` pinned pre-decoded batches, and as many raw question
strings, from a ring of ``question_ring`` batches (the two ring lengths
are coprime, so pairs vary). It goes through the serving engine's
per-batch path, reached through the adapter the traffic file names:
question encoding, then the device forward to softmax probabilities on the
host. Static int8 scales are calibrated from the first image batch during
set-up, as the engine calibrates on its first request batch.

A batch's latency runs from the start of its encoding to its
probabilities on the host. It is read on the device's clock: a CUDA event
recorded at each end, on a stream that is idle at both (the batch before
ended in a copy to the host, and so does this one).

The check: once the window has closed, ``check_batches`` of the window's
batches, drawn from the seed, are scored again by the reference. Every
batch holds the longest questions of the mix.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from vqabench import harness, inputs, judge, tracing
from vqabench.reference import steps as ref_steps
from vqabench.reference import weights

TAG_WEIGHTS, TAG_IMAGES, TAG_QUESTIONS, TAG_SAMPLE = 1, 2, 3, 6


class _Clock:
    """Stamps on the device's clock (CUDA events), or the host's on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


class Loop:
    kind = "serve"

    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.batch = self.traffic["batch"]
        self.adapter = harness.load_module("traffic", self.traffic["adapter"])
        self.served = 0            # batches through the engine so far
        self.encode_s = 0.0        # host seconds in question encoding
        self.outputs = None

    def _batch(self):
        g = self.served
        t = time.perf_counter()
        with record_function("vqabench.encode"):
            ids, lens = self.adapter.encode(self.predictor, self.texts[g % len(self.texts)])
        self.encode_s += time.perf_counter() - t
        with record_function("vqabench.forward"):
            probs = self.adapter.probs(self.predictor, self.images[g % len(self.images)],
                                       ids, lens)
        self.served += 1
        return g, probs

    def setup(self) -> None:
        cfg, tr, dev, b = self.cfg, self.traffic, self.device, self.batch
        clock = tracing.Phases()
        w = weights.make(cfg, inputs.subseed(self.seed, TAG_WEIGHTS), dev)
        clock("weights")
        self.predictor = self.adapter.build(cfg, inputs.vocab_dict(cfg), b, dev)
        self.adapter.load_weights(self.predictor, w)
        del w
        clock("model")
        self.images = inputs.image_ring(self.seed, TAG_IMAGES, tr["image_ring"], b,
                                        cfg["image_size"], dev)
        self.ids, self.lens = inputs.questions(cfg, tr, self.seed, TAG_QUESTIONS,
                                               tr["question_ring"], b)
        self.texts = [inputs.question_text(i, n) for i, n in zip(self.ids, self.lens)]
        clock("inputs")
        self.adapter.calibrate(self.predictor, self.images[0])
        clock("calibration")
        for _ in range(tr["warmup_batches"]):
            self._batch()
        tracing.sync(dev)
        clock("warm-up")

    def window(self, seconds: float) -> dict:
        dev, clock = self.device, _Clock(self.device)
        tracing.sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        stamps, outs = [], {}
        self.encode_s = 0.0
        t0 = time.perf_counter()
        while True:
            a = clock.stamp()
            g, probs = self._batch()
            stamps.append((a, clock.stamp()))
            outs[g] = probs
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        tracing.sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        lat = [clock.ms(a, z) for a, z in stamps]
        n = len(lat)
        p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] if n > 1 else lat[0]
        failed = sum(int((~np.isfinite(p).all(axis=1)).sum()) for p in outs.values())
        rng = np.random.default_rng(inputs.subseed(self.seed, TAG_SAMPLE))
        picks = rng.choice(sorted(outs), size=min(self.traffic["check_batches"], n),
                           replace=False)
        self.outputs = {int(g): outs[int(g)] for g in picks}
        tenth = max(n // 10, 1)
        print(f"# serve window: {n} batches of {self.batch} in {t1 - t0:.3f} s; batch "
              f"latency median {statistics.median(lat):.4f} ms, p95 {p95:.4f} ms over {n} "
              f"batches; checked batches {sorted(self.outputs)}; mean ms by tenths "
              f"{[round(statistics.mean(lat[i:i + tenth]), 3) for i in range(0, n, tenth)]}",
              flush=True)
        return {"start": t0, "seconds": t1 - t0, "steps": n, "attempted": n * self.batch,
                "failed": failed, "window_peak_bytes": peak,
                "host_spans": {"vqabench.encode": self.encode_s / n},
                "metrics": {"serve_qa_per_s": n * self.batch / (t1 - t0),
                            "serve_batch_p95_ms": p95}}

    def traced(self, steps: int, out_dir: str):
        return tracing.profile(lambda i: self._batch(), steps, out_dir, self.device)

    def release(self) -> None:
        self.predictor = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control=ref_steps.EXACT) -> dict:
        """The reference's log-probabilities of the checked batches."""
        cfg, dev = self.cfg, self.device
        out = {}
        with ref_steps.strict():
            w = weights.make(cfg, inputs.subseed(self.seed, TAG_WEIGHTS), dev)
            amax = ref_steps.calibrate(cfg, w, self.images[0], dev, control)
            for g in sorted(self.outputs):
                q = g % len(self.texts)
                out[g] = ref_steps.serve_logp(cfg, w, amax, self.images[g % len(self.images)],
                                              self.ids[q], self.lens[q], dev, control).numpy()
        return out

    def control_outputs(self, control) -> dict:
        return {g: np.exp(v) for g, v in self.reference(control).items()}

    @staticmethod
    def numbers(outputs: dict, reference: dict) -> dict:
        keys = sorted(reference)
        return {"logp_err": judge.logp_err(np.concatenate([outputs[g] for g in keys]),
                                           np.concatenate([reference[g] for g in keys]))}
