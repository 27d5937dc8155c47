"""Closed-loop training, as the port's ``main`` trains without host decode.

A ring of ``ring`` batches (uint8 images in pinned host memory, question
ids and lengths, labels) goes round through ``device_prefetch(...,
device_batch(...))`` into ``make_train_step()`` (forward, fp32
cross-entropy, backward, Adam at ``lr``), the int8 tower's static scales
calibrated first on the ring's first batch, as ``main`` calibrates. The
loss is read every ``log_every`` steps, as a log interval reads it; the
window ends in a synchronise.

Set-up drives the training state from the seed through ``check_steps``
steps on distinct batches, through the window's own call and feed, and
records what the check compares: each step's loss, each trained leaf's
first gradient as Adam received it (its first moment after one step over
1 - beta1), and each leaf's change after the steps. Then ``warmup_steps``
more, and the same state goes on into the window.
"""

from __future__ import annotations

import gc
import itertools
import math
import time

import torch
from torch.profiler import record_function

from vqabench import inputs, judge, tracing
from vqabench.reference import steps as ref_steps
from vqabench.reference import weights

TAG_WEIGHTS, TAG_IMAGES, TAG_QUESTIONS, TAG_LABELS, TAG_DROPOUT = 1, 2, 3, 4, 5


class Loop:
    kind = "train"

    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.batch = self.traffic["batch"]
        self.outputs = None
        self.host_s = 0.0          # host seconds inside train_step calls

    def _step(self):
        batch = next(self.feed)
        t = time.perf_counter()
        with record_function("vqabench.train_step"):
            out = self.train_step(self.state, batch)
        self.host_s += time.perf_counter() - t
        return out

    def setup(self) -> None:
        from vqa_tpu_torch.config import build_model, compute_dtype_for_opt_lvl
        from vqa_tpu_torch.data.pipeline import device_batch, device_prefetch, \
            make_image_preprocessor
        from vqa_tpu_torch.train.calibrate import calibrate_model
        from vqa_tpu_torch.train.state import create_train_state
        from vqa_tpu_torch.train.steps import make_train_step

        cfg, tr, dev, b = self.cfg, self.traffic, self.device, self.batch
        clock = tracing.Phases()
        w = weights.make(cfg, inputs.subseed(self.seed, TAG_WEIGHTS), dev)
        clock("weights")
        model, _ = build_model(cfg["model"], cfg["vocab_size"], cfg["num_classes"], device=dev,
                               opt_lvl=cfg["opt_lvl"], int8_backbone=cfg["int8_backbone"],
                               max_seq_length=cfg["max_seq_length"],
                               generator=torch.Generator().manual_seed(0))
        model.load_state_dict(w, strict=True)
        del w
        clock("model")
        r = tr["ring"]
        images = inputs.image_ring(self.seed, TAG_IMAGES, r, b, cfg["image_size"], dev)
        ids, lens = inputs.questions(cfg, tr, self.seed, TAG_QUESTIONS, r, b)
        labels = inputs.labels(cfg, self.seed, TAG_LABELS, r, b)
        self.ring = [{"image": images[i], "question": ids[i], "ques_len": lens[i],
                      "label": labels[i]} for i in range(r)]
        clock("inputs")
        preprocess = make_image_preprocessor(cfg["image_size"],
                                             compute_dtype_for_opt_lvl(cfg["opt_lvl"]), dev)
        calibrate_model(cfg["model"], model, preprocess, [self.ring[0]["image"]],
                        log=lambda s: None)
        clock("calibration")
        self.dropout_seed = inputs.subseed(self.seed, TAG_DROPOUT)
        self.state = create_train_state(model, tr["lr"], seed=self.dropout_seed)
        self.train_step = make_train_step()

        def prepare(host_batch):
            with record_function("vqabench.device_batch"):
                return device_batch(host_batch, preprocess, dev)
        self.feed = device_prefetch(itertools.cycle(self.ring), prepare, depth=2)

        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        start = {n: p.detach().clone() for n, p in params.items()}
        opt = self.state.optimizer
        losses = []
        for i in range(tr["check_steps"]):
            losses.append(self._step()["loss"])
            if i == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                first = {n: (opt.state[p]["exp_avg"] / (1 - beta1)).cpu()
                         for n, p in params.items() if p in opt.state}
        change = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
        self.outputs = {"loss": [float(v) for v in losses],
                        "grad": {n: float(t.norm()) for n, t in first.items()},
                        "change": change, "first": first}
        del start
        clock("checked steps")
        for _ in range(tr["warmup_steps"]):
            out = self._step()
        float(out["loss"])
        tracing.sync(dev)
        clock("warm-up")

    def window(self, seconds: float) -> dict:
        """Train for ``seconds``; the end-to-end numbers."""
        dev, every = self.device, self.traffic["log_every"]
        tracing.sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reads, n, marks = [], 0, []
        self.host_s = 0.0
        t0 = time.perf_counter()
        while True:
            out = self._step()
            n += 1
            if n % every == 0:
                with record_function("vqabench.read_loss"):
                    reads.append(float(out["loss"]))
                marks.append(time.perf_counter() - t0)
            if time.perf_counter() - t0 >= seconds:
                break
        tracing.sync(dev)
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        reads.append(float(out["loss"]))
        print(f"# train window: {n} steps of {self.batch} in {t1 - t0:.3f} s, "
              f"losses read {reads[0]:.6f} .. {reads[-1]:.6f}; seconds at each "
              f"{every} steps {[round(m, 3) for m in marks]}", flush=True)
        return {"start": t0, "seconds": t1 - t0, "steps": n, "attempted": n * self.batch,
                "failed": self.batch * sum(not math.isfinite(v) for v in reads),
                "window_peak_bytes": peak,
                "host_spans": {"vqabench.train_step": self.host_s / n},
                "metrics": {"train_qa_per_s": n * self.batch / (t1 - t0)}}

    def traced(self, steps: int, out_dir: str):
        def one(i):
            out = self._step()
            if i == steps - 1:
                with record_function("vqabench.read_loss"):
                    float(out["loss"])
        return tracing.profile(one, steps, out_dir, self.device)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.feed = self.state = self.train_step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control=ref_steps.EXACT) -> dict:
        cfg, dev = self.cfg, self.device
        with ref_steps.strict():
            w = weights.make(cfg, inputs.subseed(self.seed, TAG_WEIGHTS), dev)
            amax = ref_steps.calibrate(cfg, w, self.ring[0]["image"], dev, control)
            return ref_steps.train_readings(cfg, w, amax,
                                            self.ring[:self.traffic["check_steps"]],
                                            self.traffic["lr"], self.dropout_seed, dev, control)

    def control_outputs(self, control) -> dict:
        return self.reference(control)

    @staticmethod
    def numbers(outputs: dict, reference: dict) -> dict:
        return judge.train_numbers(outputs, reference)
