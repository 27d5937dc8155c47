"""Batched inference engine + serving CLI (port of vqa_tpu/serve.py).

:class:`_ServingEngine` is the host side that every predictor shares
(vqa_tpu/serve.py:62-125): question encoding, image decode, padding a
partial batch to ``batch_size``, top-k answer strings, and the per-batch
wall times. :class:`VQAPredictor` puts a model on one device under it,
preprocesses on the device and calibrates the int8 stages on the first
batch; ``vqa_tpu_torch.export.ExportedPredictor`` puts a program exported
with ``torch.export`` under it. :func:`main` is the JSONL CLI with
vqa_tpu.serve's flags plus ``--device``::

    python -m vqa_tpu_torch.serve --model attention|baseline|bert|kimi_vl \\
        --vocab_file vocab.pkl --img_dir imgs --input pairs.txt --output preds.jsonl
    python -m vqa_tpu_torch.serve --model attention --vocab_file vocab.pkl \\
        --model_ckpt run/model_3744.ckpt --export_to run/export/
    python -m vqa_tpu_torch.serve --from_export run/export/ --vocab_file vocab.pkl \\
        --img_dir imgs --input pairs.txt

The image size is the model's (448² for attention and kimi_vl, 224² for
baseline and bert) unless ``--image_size`` says otherwise. ``--model_ckpt`` takes the
port's own ``model_<step>.ckpt`` or a ``.pth`` (the reference format, or
vqa_tpu's flat bert dict); the head's width comes from the checkpoint.

With int8 stages, static scales resolve in this order: ``--calib_file``,
then the checkpoint's ``int8_calib.json`` sidecar, then the first request
batch. ``--device cuda`` (the default) needs a card and never falls back to
the CPU; the CPU runs only with an explicit ``--device cpu``. The data
contract (text, vocab, image decode) is the port's copy of vqa_tpu's
(``vqa_tpu_torch.{text,vocab,data.images}``). This module imports nothing of
``vqa_tpu_torch.models`` until a :class:`VQAPredictor` is built, so a server
of an exported program runs without the model code.

Each batch's phases are spans (``train.profiling.span``): ``vqa.serve.decode``,
``vqa.serve.encode``, and ``vqa.serve.forward`` (the device forward, host to
host) around ``vqa.serve.to_device`` and ``vqa.serve.to_host``. At exit the
CLI prints each one's count, median and p95 on one line of stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .config import resolve_device
from .data.images import decode_batch
from .text import pad_sequences, preprocess_text
from .train.profiling import span, summary
from .vocab import UNK_TOKEN, Vocab


class _ServingEngine:
    """Host-side serving logic shared by :class:`VQAPredictor` and
    ``vqa_tpu_torch.export.ExportedPredictor``. Subclasses set ``vocab``,
    ``batch_size``, ``image_size``, ``synthetic_images`` and
    ``batch_seconds`` (a list), provide ``_probs`` (the device forward) and
    may hook ``_prepare_batch`` (first-batch calibration)."""

    vocab: Vocab
    batch_size: int
    image_size: int
    synthetic_images: bool
    batch_seconds: list

    def _prepare_batch(self, images_u8) -> None:
        """Called with each batch's decoded images before its forward."""

    def _probs(self, images_u8, ids, lens) -> np.ndarray:
        """uint8 [B, S, S, 3] + [B, L] / [B] int32 -> softmax probabilities [B, K]."""
        raise NotImplementedError

    def encode_questions(self, questions: list[str]):
        """Raw question strings -> (ids [N, L], lengths [N])."""
        with span("vqa.serve.encode"):
            unk = self.vocab.word2idx[UNK_TOKEN]
            ids = np.zeros((len(questions), self.vocab.max_seq_length), np.int32)
            lens = np.zeros((len(questions),), np.int32)
            for i, q in enumerate(questions):
                toks = [self.vocab.word2idx.get(w, unk) for w in preprocess_text(q)]
                ids[i] = pad_sequences(toks, self.vocab.max_seq_length)
                lens[i] = int(np.count_nonzero(ids[i]))
            return ids, lens

    def predict_probs(self, image_paths: list[str], questions: list[str]) -> np.ndarray:
        """Softmax probabilities [N, K] of (image, question) pairs, batch by
        batch, each batch padded to ``batch_size``. ``batch_seconds`` gets
        each batch's wall time, host decode to probabilities on the host."""
        if len(image_paths) != len(questions):
            raise ValueError("image_paths and questions differ in length")
        out = []
        bs = self.batch_size
        for start in range(0, len(questions), bs):
            t0 = time.perf_counter()
            chunk_qs = questions[start:start + bs]
            n = len(chunk_qs)
            with span("vqa.serve.decode"):
                images = decode_batch(image_paths[start:start + bs], self.image_size,
                                      synthetic_fallback=self.synthetic_images)
            self._prepare_batch(images)
            ids, lens = self.encode_questions(chunk_qs)
            if n < bs:
                images = np.concatenate(
                    [images, np.zeros((bs - n,) + images.shape[1:], images.dtype)])
                ids = np.concatenate([ids, np.zeros((bs - n, ids.shape[1]), ids.dtype)])
                lens = np.concatenate([lens, np.ones((bs - n,), lens.dtype)])
            out.append(self._probs(images, ids, lens)[:n])
            self.batch_seconds.append(time.perf_counter() - t0)
        return np.concatenate(out) if out else np.zeros((0, 0), np.float32)

    def predict(self, image_paths: list[str], questions: list[str],
                top_k: int = 1) -> list[dict]:
        """Answer (image, question) pairs, batch by batch.

        Returns per-sample dicts: {answer, prob, topk: [(answer, prob), ...]};
        class ids beyond the vocab's labels (untrained head slots) read
        UNKNOWN.
        """
        probs = self.predict_probs(image_paths, questions)
        results = []
        for row, top in zip(probs, np.argsort(-probs, axis=-1)[:, :top_k]):
            topk = [(self.vocab.idx2label.get(int(i), "UNKNOWN"), float(row[i])) for i in top]
            results.append({"answer": topk[0][0], "prob": topk[0][1], "topk": topk})
        return results


def _head_width(model_name: str, sd: dict, checkpoint: str) -> int:
    """The classifier head's width from a state dict (vqa_tpu/serve.py:45-60)."""
    head = {"attention": "mlp_classify.W_h.weight",
            "kimi_vl": "classifier.weight"}.get(model_name, "fc_final.weight")
    if head not in sd:
        raise ValueError(f"{checkpoint}: not a {model_name!r} checkpoint (no {head})")
    return int(sd[head].shape[0])


class VQAPredictor(_ServingEngine):
    """Batch predictor over a checkpoint (``.ckpt`` or ``.pth``) or seeded weights."""

    def __init__(self, model_name: str, vocab: Vocab, checkpoint: str | None = None,
                 *, num_cls: int | None = None, batch_size: int = 32,
                 opt_lvl: int = 1, use_pallas: bool = False,
                 int8_backbone: bool | None = None, hpack_pool: bool = True,
                 fused_stem: bool = True, int8_handoff: bool = True,
                 int8_stages: tuple | None = None, calib_file: str | None = None,
                 int8_dynamic: bool = False, synthetic_images: bool = False,
                 image_size: int | None = None, device: str = "cuda"):
        from .config import build_model
        from .data.pipeline import make_image_preprocessor

        self.vocab = vocab
        self.model_name = model_name
        self.batch_size = batch_size
        self.synthetic_images = synthetic_images
        self.device = resolve_device(device)
        self._needs_calib = False
        self.calibrated_on_batch = None     # 1-based batch index, if any
        self.batch_seconds: list[float] = []

        sd = None
        if checkpoint:
            from .train.checkpoint import load_params_only
            sd = load_params_only(checkpoint)
            num_classes = _head_width(model_name, sd, checkpoint)
        else:
            num_classes = (num_cls + 1) if num_cls is not None else vocab.num_labels
        self.num_classes = num_classes
        self.model, cfg = build_model(
            model_name, vocab.size, num_classes, device=self.device,
            hpack_pool=hpack_pool, fused_stem=fused_stem,
            int8_handoff=int8_handoff, int8_stages_override=int8_stages,
            opt_lvl=opt_lvl, use_pallas=use_pallas, int8_backbone=int8_backbone,
            max_seq_length=vocab.max_seq_length, generator=torch.Generator().manual_seed(0))
        if sd is not None:
            self.model.load_state_dict(sd, strict=True)
        self.model.eval()
        if self.model.int8_stages:
            from .train.calibrate import load_calib, load_calib_file
            amax = None
            if calib_file:
                amax = load_calib_file(calib_file, self.model.int8_stages, model_name)
            if amax is None and checkpoint:
                amax = load_calib(os.path.dirname(os.path.abspath(checkpoint)),
                                  self.model.int8_stages)
            if amax is not None:
                self.model.int8_amax = amax
            elif int8_dynamic:
                print("NOTE: no int8_calib.json next to the checkpoint; "
                      "int8 stages use dynamic per-batch activation scales "
                      "(predictions depend on batch composition)")
            else:
                self._needs_calib = True
                print("NOTE: no int8_calib.json next to the checkpoint; "
                      "static scales will be calibrated from the first "
                      "request batch (pass --int8_dynamic for per-batch "
                      "scales, or --calib_file for a curated sidecar)")
        self.image_size = image_size or cfg.image_size
        self.preprocess = make_image_preprocessor(self.image_size, device=self.device)

    def _calibrate(self, images_u8) -> None:
        """Bake static int8 scales from the first request batch."""
        from .train.calibrate import calibrate_model
        print(f"int8 serve calibration: static per-channel scales from the "
              f"first request batch ({len(images_u8)} images)")
        calibrate_model(self.model_name, self.model, self.preprocess,
                        [images_u8], log=lambda s: None)
        self._needs_calib = False

    def _prepare_batch(self, images_u8) -> None:
        if self._needs_calib:
            self._calibrate(images_u8)
            self.calibrated_on_batch = len(self.batch_seconds) + 1

    @torch.no_grad()
    def _probs(self, images_u8, ids, lens) -> np.ndarray:
        dev = self.device
        with span("vqa.serve.forward"):
            with span("vqa.serve.to_device"):
                x = self.preprocess(images_u8)
                ids = torch.from_numpy(ids).long().to(dev)
                lens = torch.from_numpy(lens).long().to(dev)
            logits = self.model(x, ids, lens)
            with span("vqa.serve.to_host"):
                return torch.softmax(logits.float(), dim=-1).cpu().numpy()


# the flags that build a VQAPredictor: an exported artifact fixes all of them
PREDICTOR_FLAGS = ("model", "model_ckpt", "batch_size", "num_cls", "opt_lvl", "int8_backbone",
                   "int8_stages", "calib_file", "int8_dynamic", "use_pallas", "image_size")


def build_parser():
    ap = argparse.ArgumentParser(description="VQA batched inference (PyTorch/CUDA)")
    ap.add_argument("--model", choices=["baseline", "attention", "bert", "kimi_vl"],
                    help="required unless --from_export (the artifact's manifest "
                         "names the model)")
    ap.add_argument("--vocab_file", required=True)
    ap.add_argument("--model_ckpt", help="the port's model_<step>.ckpt or a reference .pth")
    ap.add_argument("--img_dir", default=".", help="image directory")
    ap.add_argument("--input", help="dataset .txt (img\\tq\\t[ans]) or '-' for stdin "
                                    "pairs 'img\\tq'; required unless --export_to")
    ap.add_argument("--from_export",
                    help="serve from an artifact directory of vqa_tpu_torch.export "
                         "instead of building the model from a checkpoint")
    ap.add_argument("--export_to",
                    help="after building the predictor, export it as an artifact to "
                         "this directory and exit (unless --input is also given)")
    ap.add_argument("--output", help="output JSONL (default stdout)")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--top_k", type=int, default=1)
    ap.add_argument("--num_cls", type=int)
    ap.add_argument("--opt_lvl", type=int, default=1, choices=[0, 1, 2, 3])
    ap.add_argument("--int8_backbone", type=str, default="auto",
                    choices=["auto", "true", "false"],
                    help="int8-PTQ frozen backbone; auto = on at --opt_lvl >= 1 "
                         "on a CUDA device")
    ap.add_argument("--int8_stages", type=str, default="auto",
                    help="comma-separated conv indices to int8-quantize")
    ap.add_argument("--calib_file", type=str,
                    help="explicit int8 calibration sidecar (int8_calib.json "
                         "format, or keyed by model name)")
    ap.add_argument("--int8_dynamic", action="store_true",
                    help="dynamic per-batch activation scales instead of "
                         "calibrating static ones from the first batch")
    ap.add_argument("--use_pallas", action="store_true")
    ap.add_argument("--synthetic_images", action="store_true")
    ap.add_argument("--image_size", type=int,
                    help="override input resolution (default: per-model)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (default) fails without a card")
    return ap


def predictor_from_args(args, vocab: Vocab) -> VQAPredictor:
    """The :class:`VQAPredictor` that the serve and export CLIs' flags describe."""
    return VQAPredictor(
        args.model, vocab, args.model_ckpt, num_cls=args.num_cls,
        batch_size=args.batch_size, opt_lvl=args.opt_lvl,
        use_pallas=args.use_pallas,
        int8_backbone={"auto": None, "true": True, "false": False}[args.int8_backbone],
        int8_stages=(None if args.int8_stages == "auto" else
                     tuple(int(i) for i in args.int8_stages.split(",") if i)),
        calib_file=args.calib_file, int8_dynamic=args.int8_dynamic,
        synthetic_images=getattr(args, "synthetic_images", False),
        image_size=args.image_size, device=args.device)


def main(argv=None):
    """Serve a JSONL of answers (or only export); returns the predictor."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.from_export and args.export_to:
        parser.error("--from_export and --export_to are mutually exclusive")
    if not args.from_export and not args.model:
        parser.error("--model is required (unless serving --from_export)")
    if not args.input and not args.export_to:
        parser.error("--input is required (unless only exporting via --export_to)")
    vocab = Vocab.load(args.vocab_file)
    if args.from_export:
        ignored = [f"--{f}" for f in PREDICTOR_FLAGS
                   if getattr(args, f) != parser.get_default(f)]
        if ignored:
            print(f"NOTE: {', '.join(ignored)} {'is' if len(ignored) == 1 else 'are'} "
                  f"ignored with --from_export (the artifact fixes the model, its "
                  f"weights, precision and batch shape)")
        from .export import ExportedPredictor
        predictor = ExportedPredictor(args.from_export, vocab, vocab_path=args.vocab_file,
                                      synthetic_images=args.synthetic_images,
                                      device=args.device)
    else:
        predictor = predictor_from_args(args, vocab)
    if args.export_to:
        from .export import export_predictor
        manifest = export_predictor(predictor, args.export_to, vocab_path=args.vocab_file)
        print(f"exported serving artifact -> {args.export_to} "
              f"({manifest['artifact_bytes'] / 1e6:.1f} MB, platforms "
              f"{manifest['platforms']})")
        if not args.input:
            return predictor

    if args.input == "-":
        lines = sys.stdin.read().split("\n")
    else:
        with open(args.input) as f:
            lines = f.read().split("\n")
    img_paths, questions = [], []
    for lineno, line in enumerate(lines, 1):
        if not line.strip():
            continue
        parts = line.strip().split("\t")
        if len(parts) < 2:
            raise SystemExit(f"{args.input}:{lineno}: expected 'img\\tquestion"
                             f"[\\tanswer]', got: {line.strip()!r}")
        img_paths.append(os.path.join(args.img_dir, parts[0]))
        questions.append(parts[1])

    # stream results batch by batch: each finished batch is on disk before
    # the next one runs
    bs = predictor.batch_size
    out = open(args.output, "w") if args.output else sys.stdout
    n_written = 0
    try:
        for start in range(0, len(questions), bs):
            chunk_p = img_paths[start:start + bs]
            chunk_q = questions[start:start + bs]
            for path, q, r in zip(chunk_p, chunk_q,
                                  predictor.predict(chunk_p, chunk_q, top_k=args.top_k)):
                out.write(json.dumps({"image": os.path.basename(path),
                                      "question": q.replace(",", " "), **r}) + "\n")
                n_written += 1
            out.flush()
    finally:
        if args.output:
            out.close()
    if args.output:
        print(f"wrote {n_written} predictions to {args.output}")
    print_serve_spans()
    return predictor


def print_serve_spans() -> None:
    """One line on stderr (stdout may be the answers): each ``vqa.serve.*``
    span's count, median and p95 host ms in this process, then the sentence
    LSTM's calls by path where the model code ran here (an exported program
    runs none of it)."""
    spans = {k: v for k, v in summary().items() if k.startswith("vqa.serve.")}
    if spans:
        parts = [f"{k} n={v['count']} median {v['median_ms']:.3f} p95 {v['p95_ms']:.3f}"
                 for k, v in spans.items()]
        layers = sys.modules.get("vqa_tpu_torch.models.layers")
        if layers is not None:
            calls = layers.lstm_calls()
            parts.append(f"lstm calls fused={calls['fused']} loop={calls['loop']}")
        print("serve spans (host ms): " + "; ".join(parts), file=sys.stderr)


if __name__ == "__main__":
    main()
