"""Serving artifacts: the whole serving function as a program exported with
``torch.export`` (port of vqa_tpu/export.py).

:func:`export_predictor` traces one function of a built predictor, the
device image preprocess (uint8 -> normalized float), the model forward at
its precision policy (fp32, bf16, or int8 with its resolved static scales)
and the softmax, with ``torch.export.export`` under ``no_grad`` and saves it
with its weights into one directory:

    <out_dir>/serving_fn.pt2      # torch.export.save of the program
    <out_dir>/manifest.json       # shapes, platforms, vocab fingerprint, kernels

With several platforms (``--platforms cpu,cuda``) there is one program per
platform, ``serving_fn.<platform>.pt2``, each traced on a copy of the model
on that device: an exported program keeps the device it was traced on.
:class:`ExportedPredictor` serves from the directory with no model code and
no checkpoint or calibration logic: it imports the port's operator library
(``vqa_tpu_torch.ops.library``, named in the manifest), so the program's
``vqa_tpu_torch::*`` nodes launch the hand-written kernels on the card (or
run their plain versions on the CPU), and nothing of ``vqa_tpu_torch.models``.

Four faults of the JAX package's export are not carried over
(``ADVICE.md``): the files are written under temporary names and renamed
into place, the manifest last; the platform check compares torch's device
type with the manifest's names and suggests a value the CLI takes; a
manifest's vocab fingerprint that cannot be checked (no vocab path) warns;
the CLI takes ``--int8_stages``, ``--int8_dynamic`` and ``--use_pallas``.

CLI:
    python -m vqa_tpu_torch.export --model attention --vocab_file vocab.pkl \\
        --model_ckpt run/model_3744.ckpt --out run/export/
    python -m vqa_tpu_torch.serve --from_export run/export/ --vocab_file \\
        vocab.pkl --input val.txt --img_dir imgs/
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import warnings

import numpy as np
import torch

from .config import resolve_device
from .data.pipeline import preprocess_images
from .ops import library
from .serve import VQAPredictor, _ServingEngine, predictor_from_args
from .train.profiling import span
from .vocab import Vocab

ARTIFACT = "serving_fn.pt2"
MANIFEST = "manifest.json"
FORMAT = "vqa_tpu_torch.export.v1"
OP_LIBRARY = library.__name__
PLATFORMS = ("cpu", "cuda")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class ServingFunction(torch.nn.Module):
    """What an artifact computes: uint8 images [B, S, S, 3] on the device,
    question ids [B, L] and lengths [B] (int64) -> softmax probabilities
    [B, K] in float32, as ``VQAPredictor`` computes them."""

    def __init__(self, model: torch.nn.Module, image_size: int):
        super().__init__()
        self.model = model
        self.image_size = image_size

    def forward(self, image_u8, question, ques_len):
        x = preprocess_images(image_u8, self.image_size, device=image_u8.device)
        return torch.softmax(self.model(x, question, ques_len).float(), dim=-1)


def kernel_ops(program) -> dict:
    """{operator name: nodes} of the ``vqa_tpu_torch`` operators in an
    exported program, its nested graphs (autocast regions) included."""
    found: dict = {}
    for gm in program.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            target = node.target
            if node.op == "call_function" and isinstance(target, torch._ops.OpOverload) \
                    and target.namespace == library.NAMESPACE:
                name = target.name().split("::")[-1]
                found[name] = found.get(name, 0) + 1
    return found


def _tmp(path: str) -> str:
    """A process-unique temporary name beside ``path``, same extension."""
    root, ext = os.path.splitext(path)
    return f"{root}.tmp{os.getpid()}{ext}"


def export_predictor(predictor: VQAPredictor, out_dir: str, *,
                     platforms: tuple[str, ...] | None = None,
                     vocab_path: str | None = None) -> dict:
    """Export ``predictor``'s serving function and weights to ``out_dir``.

    Returns the manifest dict. The program's signature is ``(image_u8
    [B,S,S,3] uint8, question [B,L] int64, ques_len [B] int64) -> probs
    [B,K] float32`` at the predictor's batch shape, on the platform's
    device. ``platforms`` defaults to the predictor's device type; ``cuda``
    needs a card.
    """
    if getattr(predictor, "_needs_calib", False):
        raise ValueError(
            "int8 activation scales are unresolved; export would bake "
            "uncalibrated numerics. Pass calib_file= (or put an "
            "int8_calib.json sidecar next to the checkpoint), or run one "
            "predict() batch first to auto-calibrate, then export.")
    platforms = tuple(platforms) if platforms else (predictor.device.type,)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms {list(platforms)}: each must be one of {PLATFORMS}, once")
    bs, size = predictor.batch_size, predictor.image_size
    seq = predictor.vocab.max_seq_length

    os.makedirs(out_dir, exist_ok=True)
    names = {p: ARTIFACT if len(platforms) == 1 else f"serving_fn.{p}.pt2" for p in platforms}
    pending, kernels = [], None
    try:
        for p in platforms:
            dev = resolve_device(p)
            model = predictor.model if dev.type == predictor.device.type \
                else copy.deepcopy(predictor.model).to(dev)
            fn = ServingFunction(model, size).eval()
            args = (torch.zeros((bs, size, size, 3), dtype=torch.uint8, device=dev),
                    torch.zeros((bs, seq), dtype=torch.int64, device=dev),
                    torch.ones((bs,), dtype=torch.int64, device=dev))
            with torch.no_grad():
                program = torch.export.export(fn, args, strict=False)
            # the traced zeros would be saved too (19.3 MB at 448² b32)
            program.example_inputs = None
            kernels = kernel_ops(program) if kernels is None else kernels
            path = os.path.join(out_dir, names[p])
            tmp = _tmp(path)
            pending.append((tmp, path))
            torch.export.save(program, tmp)
        manifest = {
            "format": FORMAT,
            "model": predictor.model_name,
            "batch_size": bs,
            "image_size": size,
            "max_seq_length": seq,
            "num_classes": predictor.num_classes,
            "platforms": list(platforms),
            "artifacts": names,
            "artifact_bytes": sum(os.path.getsize(tmp) for tmp, _ in pending),
            "int8_stages": list(predictor.model.int8_stages),
            "vocab_sha256": _sha256(vocab_path) if vocab_path else None,
            "torch_version": torch.__version__,
            "op_library": OP_LIBRARY,
            "kernels": kernels,
        }
        path = os.path.join(out_dir, MANIFEST)
        tmp = _tmp(path)
        pending.append((tmp, path))
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        # an older manifest goes first: a crash from here on leaves no
        # manifest that names programs it was not written with
        if os.path.exists(path):
            os.remove(path)
        for tmp, path in pending:
            os.replace(tmp, path)
    finally:
        for tmp, _ in pending:
            if os.path.exists(tmp):
                os.remove(tmp)
    return manifest


class ExportedPredictor(_ServingEngine):
    """Serve from an exported artifact: no model code, no checkpoint.

    Shares the host side (question encoding, decode, batch padding, top-k)
    with ``vqa_tpu_torch.serve.VQAPredictor``; the device forward is the
    loaded program, on ``device`` (default ``cuda``, which needs a card).
    The vocab is still needed on the host and is checked against the
    fingerprint the artifact was exported with.
    """

    def __init__(self, artifact_dir: str, vocab: Vocab, *, vocab_path: str | None = None,
                 synthetic_images: bool = False, device: str = "cuda"):
        with open(os.path.join(artifact_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(
                f"{artifact_dir}: unknown artifact format "
                f"{self.manifest.get('format')!r} (expected {FORMAT})")
        want = self.manifest.get("vocab_sha256")
        if want and vocab_path is None:
            warnings.warn(f"{artifact_dir}: the artifact names its vocab's sha256 but no "
                          f"vocab path was given, so the vocab fingerprint is unverified",
                          stacklevel=2)
        elif want and _sha256(vocab_path) != want:
            raise ValueError(
                f"vocab fingerprint mismatch: {vocab_path} is not the vocab this "
                f"artifact was exported with (token ids / label order would "
                f"silently disagree); expected sha256 {want[:16]}...")
        if vocab.max_seq_length != self.manifest["max_seq_length"]:
            raise ValueError(f"vocab max_seq_length {vocab.max_seq_length} != exported "
                             f"{self.manifest['max_seq_length']}")
        if self.manifest.get("op_library") != OP_LIBRARY:
            raise ValueError(f"{artifact_dir}: the artifact needs the operator library "
                             f"{self.manifest.get('op_library')!r}, not {OP_LIBRARY}")
        self.device = resolve_device(device)
        platforms = self.manifest["platforms"]
        if self.device.type not in platforms:
            raise ValueError(
                f"artifact was exported for platforms {platforms}, but this predictor "
                f"runs on {self.device.type!r}; re-export with --platforms "
                f"{self.device.type} (or serve with --device {platforms[0]})")

        self.program = torch.export.load(
            os.path.join(artifact_dir, self.manifest["artifacts"][self.device.type]))
        self._fn = self.program.module()
        self.vocab = vocab
        self.model_name = self.manifest["model"]
        self.batch_size = int(self.manifest["batch_size"])
        self.image_size = int(self.manifest["image_size"])
        self.num_classes = int(self.manifest["num_classes"])
        self.synthetic_images = synthetic_images
        self.batch_seconds: list[float] = []

    @torch.no_grad()
    def _probs(self, images_u8, ids, lens) -> np.ndarray:
        dev = self.device
        with span("vqa.serve.forward"):
            with span("vqa.serve.to_device"):
                args = (torch.from_numpy(images_u8).to(dev),
                        torch.from_numpy(ids).long().to(dev),
                        torch.from_numpy(lens).long().to(dev))
            probs = self._fn(*args)
            with span("vqa.serve.to_host"):
                return probs.cpu().numpy()


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        description="Export a trained checkpoint as a serving artifact (torch.export)")
    ap.add_argument("--model", required=True, choices=["baseline", "attention", "bert"])
    ap.add_argument("--vocab_file", required=True)
    ap.add_argument("--model_ckpt", help="the port's model_<step>.ckpt or a reference .pth")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--num_cls", type=int)
    ap.add_argument("--opt_lvl", type=int, default=1, choices=[0, 1, 2, 3])
    ap.add_argument("--int8_backbone", type=str, default="auto",
                    choices=["auto", "true", "false"])
    ap.add_argument("--int8_stages", type=str, default="auto",
                    help="comma-separated conv indices to int8-quantize")
    ap.add_argument("--calib_file", type=str,
                    help="explicit int8 calibration sidecar when the checkpoint dir has none")
    ap.add_argument("--int8_dynamic", action="store_true",
                    help="export dynamic per-batch activation scales instead of "
                         "requiring static ones")
    ap.add_argument("--use_pallas", action="store_true")
    ap.add_argument("--image_size", type=int)
    ap.add_argument("--platforms", type=str,
                    help="comma-separated platforms of {cpu, cuda}, one program each; "
                         "default: the --device's type")
    ap.add_argument("--device", default="cuda",
                    help="torch device the predictor is built on; 'cuda' (default) "
                         "fails without a card")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    vocab = Vocab.load(args.vocab_file)
    predictor = predictor_from_args(args, vocab)
    manifest = export_predictor(
        predictor, args.out,
        platforms=(tuple(p for p in args.platforms.split(",") if p)
                   if args.platforms else None),
        vocab_path=args.vocab_file)
    print(f"exported {manifest['model']} b{manifest['batch_size']}@"
          f"{manifest['image_size']} K={manifest['num_classes']} for "
          f"{manifest['platforms']} -> {args.out} "
          f"({manifest['artifact_bytes'] / 1e6:.1f} MB, kernels {manifest['kernels']})")
    return manifest


if __name__ == "__main__":
    main()
