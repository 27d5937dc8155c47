"""Export a trained baseline's VGG to a torchvision ``vgg11_bn`` ``.pth``.

Port of tools/export_vgg_pth.py. It reads a port baseline checkpoint (a
``model_<step>.ckpt``, e.g. of a run with ``--vgg_train true``; any file
``train.checkpoint.load_params_only`` reads) and writes a state dict with
torchvision's exact key set, which ``vqa_tpu_torch.main --vgg_wts_path``,
vqa_tpu's and the reference's strict load take: ``features.*`` from the
conv stack, ``classifier.0`` and ``classifier.3`` from the classifier head,
and the final FC-1000 that torchvision's model has and every framework
drops, initialized from ``--seed`` (N(0, 0.01), zero bias). The
accuracy ladder's grid tasks need a backbone pretrained on the synthetic
task itself (a frozen random VGG caps them, BASELINE.md round 3), shared
through that weights file. It runs on the host.

    python -m vqa_tpu_torch.tools.export_vgg_pth --ckpt <run>/model_N.ckpt \\
        --out data/grid/vgg11_bn_pretrained.pth [--seed 0]
"""

from __future__ import annotations

import argparse

import torch

TOWER = "image_encoder.vgg11_encoder."


def vgg11_bn_state_dict(sd: dict, seed: int = 0) -> dict:
    """torchvision ``vgg11_bn``'s state dict from a baseline's state dict."""
    from .make_synth_dataset import vgg11_bn_keys

    out = {f"features.{k[len(TOWER + 'conv_layers.'):]}": v for k, v in sd.items()
           if k.startswith(TOWER + "conv_layers.")}
    for src, dst in ((1, 0), (4, 3)):
        for p in ("weight", "bias"):
            out[f"classifier.{dst}.{p}"] = sd[f"{TOWER}fc_layers.{src}.{p}"]
    torch.manual_seed(seed)
    fc6 = torch.nn.Linear(4096, 1000)
    torch.nn.init.normal_(fc6.weight, 0, 0.01)
    torch.nn.init.constant_(fc6.bias, 0)
    out["classifier.6.weight"] = fc6.weight.detach()
    out["classifier.6.bias"] = fc6.bias.detach()
    out = {k: torch.as_tensor(v).detach().cpu().contiguous() for k, v in out.items()}
    expect = vgg11_bn_keys()
    if set(out) != expect:
        raise ValueError(f"keyset mismatch: missing {expect - set(out)}, "
                         f"extra {set(out) - expect}")
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="baseline model .ckpt")
    ap.add_argument("--out", required=True, help="output .pth path")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the (unused) final FC-1000 that a strict load requires")
    args = ap.parse_args(argv)
    from ..train.checkpoint import load_params_only

    tensors = vgg11_bn_state_dict(load_params_only(args.ckpt), args.seed)
    torch.save(tensors, args.out)
    print(f"wrote {args.out} ({len(tensors)} tensors)")
    return args.out


if __name__ == "__main__":
    main()
