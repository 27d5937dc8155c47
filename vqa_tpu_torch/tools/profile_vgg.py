"""Per-stage times of the VGG-11 conv stack, on both of the port's routes.

Port of tools/profile_vgg.py (``STAGES`` :27-36): each of the 8 conv stages
(conv + folded BN + ReLU [+ 2x2 max-pool]) at b160 and 448², timed alone
with CUDA events over ``BENCH_STEPS`` calls after a warm-up, on its input
as the stack before it produces it. The stages are those of
``models/vgg.py``'s running-stats forward, on the model's seeded weights:

- ``int8``: the calibrated int8 route (static per-channel scales from 8
  seeded random images, the fused stem, int8 hand-offs): stage 0 is kernel
  A with conv1's requant, stages 1-7 kernel B, the last with a bf16 output;
- ``float`` (``--int8_backbone false``, bf16): stage 0 is kernel C, stages
  1-7 ``F.conv2d`` (cuDNN) + bias, ReLU and the pool.

The JAX tool times each stage with the BN affine applied apart and folded
into the conv. The port's model always folds, on every forward: it scales
the f32 weights by the BN factor (and, int8, by the input's scales),
quantizes them and packs them into the kernel's layout in each call. So
``bn`` times the stage as the model calls it (fold, quantize and pack
included) and ``folded`` the same stage on weights folded, quantized and
packed once beforehand (for the kernels: the launch alone). The chained
``bn`` outputs of each route must equal the model's own forward bit for bit,
and each call of stages 0 (both routes) and 1-7 (int8) must launch its
kernel once, the float route's cuDNN stages none.

    python -m vqa_tpu_torch.tools.profile_vgg     [BENCH_BATCH=160 BENCH_STEPS=10]

One JSON line a stage and variant, then the totals.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.nn.functional as F

# (H_in, C_in, C_out, pool) for VGG-11 at 448² (the JAX tool's STAGES)
STAGES = [
    (448, 3, 64, True),
    (224, 64, 128, True),
    (112, 128, 256, False),
    (112, 256, 256, True),
    (56, 256, 512, False),
    (56, 512, 512, True),
    (28, 512, 512, False),
    (28, 512, 512, True),
]


def _pools() -> list[bool]:
    from ..models.vgg import VGG11_CFG
    cfg = VGG11_CFG
    return [i + 1 < len(cfg) and cfg[i + 1] == "M" for i, v in enumerate(cfg) if v != "M"]


def int8_stages(vgg, x):
    """[(kernel, bn_fn, folded_fn)] of the calibrated int8 route, each on its
    stage's input; the last stage's output."""
    from .. import _build
    from ..models.vgg import VGG11_CFG
    from ..ops.conv_hpack import int8_conv3x3, launch_int8_conv3x3, pack_conv3x3_weights
    from ..ops.conv_stage1 import conv0_i8, launch_conv0_i8, pack_conv0_i8_weights
    from ..ops.quant import const, quantize, weight_quant

    if not vgg._take_fused_stem(x, False):
        raise ValueError("the int8 route needs the fused stem (static per-channel scales)")
    dev = x.device
    chans = [v for v in VGG11_CFG if v != "M"]
    pools = _pools()
    stages = []

    def stem0():
        k0, f0, b0 = vgg._params(0)
        s_c0, s1 = const(vgg._s_x[0], dev), const(vgg._s_x[1], dev)
        w_q0, s_w0 = weight_quant((k0 * f0).float() * s_c0[None, None, :, None])
        return conv0_i8(quantize(x, s_c0), w_q0, s_w0, b0.float(), s1=s1)

    k0, f0, b0 = vgg._params(0)
    s_c0, s1 = const(vgg._s_x[0], dev), const(vgg._s_x[1], dev)
    x_q = quantize(x, s_c0)
    w_q0, s_w0 = weight_quant((k0 * f0).float() * s_c0[None, None, :, None])
    wf0, b0f = pack_conv0_i8_weights(w_q0), b0.float()
    stages.append((_build.CONV0_S2D_I8, stem0,
                   lambda: launch_conv0_i8(x_q, wf0, s_w0, b0f, s1=s1)))
    h = stem0()
    for i in range(1, 8):
        s_next = vgg._handoff_scales(i + 1, chans[i], False)
        if h.dtype != torch.int8:
            raise ValueError(f"stage {i}: no int8 hand-off into it")

        def bn(i=i, h=h, s_next=s_next):
            kernel, s, b32 = vgg._params(i)
            s_c = const(vgg._s_x[i], dev)
            w_q, s_w = weight_quant(kernel * s * s_c[None, None, :, None])
            return int8_conv3x3(h, w_q, s_w, b32, pool=pools[i],
                                s_next=None if s_next is None else const(s_next, dev),
                                out_dtype=vgg.dtype)

        kernel, s, b32 = vgg._params(i)
        w_q, s_w = weight_quant(kernel * s * const(vgg._s_x[i], dev)[None, None, :, None])
        kw = dict(pool=pools[i], s_next=None if s_next is None else const(s_next, dev),
                  out_dtype=vgg.dtype)
        stages.append((_build.CONV3X3_I8, bn,
                       lambda h=h, wp=pack_conv3x3_weights(w_q), s_w=s_w, b32=b32, kw=kw:
                       launch_int8_conv3x3(h, wp, s_w, b32, **kw)))
        h = bn()
    return stages, h


def float_stages(vgg, x):
    """[(kernel or None, bn_fn, folded_fn)] of the float route; the output."""
    from .. import _build
    from ..models.vgg import _maxpool2x2
    from ..ops.conv_stage1 import (conv0_bn_relu_pool, conv0_f_kernel_weights,
                                   conv0_f_operands, launch_conv0_f)

    dt = vgg.dtype
    pools = _pools()
    stages = []

    def stage0(x=x):
        kernel, s, b32 = vgg._params(0)
        return conv0_bn_relu_pool(x, (kernel * s).to(dt), b32.to(dt), int8=False)

    kernel, s, b32 = vgg._params(0)
    w32, bias32 = conv0_f_operands(x, (kernel * s).to(dt), b32.to(dt))
    wk = conv0_f_kernel_weights(x, w32)
    stages.append((_build.CONV0_F, stage0, lambda: launch_conv0_f(x, wk, bias32)))
    h = stage0()

    def conv(h, w_oihw, b, pool):
        y = F.conv2d(h.permute(0, 3, 1, 2), w_oihw, b, padding=1)
        y = torch.relu(y).permute(0, 2, 3, 1).contiguous()
        return _maxpool2x2(y) if pool else y

    for i in range(1, 8):
        def bn(i=i, h=h):
            kernel, s, b32 = vgg._params(i)
            return conv(h, (kernel * s).to(dt).permute(3, 2, 0, 1), b32.to(dt), pools[i])

        kernel, s, b32 = vgg._params(i)
        w, b = (kernel * s).to(dt).permute(3, 2, 0, 1), b32.to(dt)
        stages.append((None, bn, lambda h=h, w=w, b=b, p=pools[i]: conv(h, w, b, p)))
        h = bn()
    return stages, h


def run_route(route: str, device: torch.device, batch: int, steps: int, image_size: int,
              card: str) -> list[dict]:
    from .. import _build
    from ._probe import cuda_ms
    from ._run import full_width_model, sync

    model = full_width_model("attention", image_size, device, route == "int8")
    vgg = model.vgg
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((batch, image_size, image_size, 3), generator=g, device=device).to(vgg.dtype)
    stages, out = (int8_stages if route == "int8" else float_stages)(vgg, x)
    if not torch.equal(out, vgg(x)):
        raise AssertionError(f"{route}: the chained stages differ from the model's forward")
    rows = []
    for i, (kernel, bn, folded) in enumerate(stages):
        h, cin, cout, pool = STAGES[i]
        h = h * image_size // 448
        gflop = 2 * 9 * cin * cout * h * h * batch / 1e9
        for variant, fn in (("bn", bn), ("folded", folded)):
            if device.type != "cuda" and variant == "folded" and kernel is not None:
                continue            # a bare launch needs the card
            fn()
            sync(device)
            _build.reset_counts()
            ms = cuda_ms(fn, steps) if device.type == "cuda" else None
            launches = {k.symbol: k.launches for k in _build.KERNELS if k.launches}
            if device.type == "cuda" and launches != ({kernel.symbol: steps} if kernel else {}):
                raise AssertionError(f"{route} stage {i} {variant}: launches {launches}")
            row = {"route": route, "stage": i, "h": h, "cin": cin, "cout": cout, "pool": pool,
                   "variant": variant, "kernel": kernel.symbol if kernel else "cuDNN",
                   "ms": ms, "gflop": gflop,
                   "t_ops_per_s": gflop / ms if ms else None, "batch": batch, "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    del stages, x, out, model
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_size", type=int, default=448,
                    help="a multiple of 32 (smaller only to rehearse on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) needs a card; cpu rehearses the stages (no "
                         "times)")
    args = ap.parse_args(argv)
    from ._run import device_and_card

    device, card = device_and_card(args.device)
    print(card, flush=True)
    batch = int(os.environ.get("BENCH_BATCH", 160 if device.type == "cuda" else 2))
    steps = int(os.environ.get("BENCH_STEPS", 10))
    rows = [r for route in ("int8", "float")
            for r in run_route(route, device, batch, steps, args.image_size, card)]
    totals = {}
    for r in rows:
        if r["ms"] is not None:
            key = f"total_ms_{r['route']}_{r['variant']}"
            totals[key] = totals.get(key, 0.0) + r["ms"]
    gflops = sum(2 * 9 * ci * co * (h * args.image_size // 448) ** 2 * batch / 1e9
                 for h, ci, co, _ in STAGES)
    summary = {**totals, "batch_gflops": gflops, "batch": batch, "card": card}
    print(json.dumps(summary), flush=True)
    return {"rows": rows, "summary": summary}


if __name__ == "__main__":
    main()
