"""Deterministic synthetic VQA datasets: real JPEGs and the data contract.

Port of tools/make_synth_dataset.py: for the same flags it writes the same
bytes (``imgs/synth_<i>.jpg``, ``train.txt``, ``val.txt``, ``vocab.pkl``
through :func:`vqa_tpu_torch.vocab.save_vocab`, and ``vgg11_bn_synth.pth``,
a random-init state dict with torchvision ``vgg11_bn``'s exact keys that
``main --vgg_wts_path`` loads). Three tasks (``--task``):

- ``redblue`` (K = 2): textured two-tone images; "yes" iff mean(R) >
  mean(B) of the decoded JPEG (BASELINE.md round 2's 10k-pair task);
- ``grid`` (K = ``--n_colors``): an n x n grid of colored cells over noise;
  each question names a cell, the answer is its color (round 3's ladder);
- ``gridpair`` (K = ``--n_colors`` squared): a question names two cells in
  order, the answer is "<color1>-<color2>".

It runs on the host only. The images are drawn in order from one seeded
generator; their JPEG encoding (and ``redblue``'s decode of the label) runs
in a pool of up to 8 processes, which changes no byte.

    python -m vqa_tpu_torch.tools.make_synth_dataset --out_dir data/redblue \\
        [--task grid] [--n_train 10000 --n_val 2000 --size 224 --seed 0]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from collections import Counter
from concurrent.futures import ProcessPoolExecutor

import numpy as np

TEMPLATES = [
    "is,the,image,more,red,than,blue",
    "does,red,dominate,over,blue,here",
    "is,this,picture,warmer,than,it,is,cold",
    "would,you,say,red,beats,blue,in,this,image",
    "is,the,red,channel,stronger,than,the,blue,one",
    "looking,at,the,colors,is,red,the,winner",
    "tell,me,if,red,is,brighter,than,blue",
    "compared,to,blue,is,red,more,present",
]

# torchvision configuration "A": channels per conv, 'M' = 2x2/2 max-pool
VGG11_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")

GRID_COLORS = {  # 12 names -> RGB, near pairs among them (red/pink/orange,
    "red": (220, 40, 40),     # blue/cyan/purple, white/gray)
    "green": (40, 200, 60),
    "blue": (40, 80, 220),
    "yellow": (230, 220, 50),
    "purple": (150, 50, 200),
    "orange": (240, 140, 30),
    "white": (235, 235, 235),
    "black": (25, 25, 25),
    "pink": (240, 150, 190),
    "brown": (130, 80, 40),
    "gray": (128, 128, 128),
    "cyan": (60, 210, 220),
}

GRID_POS_3 = {(0, 0): "top,left", (0, 1): "top,middle", (0, 2): "top,right",
              (1, 0): "middle,left", (1, 1): "center", (1, 2): "middle,right",
              (2, 0): "bottom,left", (2, 1): "bottom,middle",
              (2, 2): "bottom,right"}

GRID_POS_2 = {(0, 0): "top,left", (0, 1): "top,right",
              (1, 0): "bottom,left", (1, 1): "bottom,right"}

GRID_TEMPLATES = [
    "what,color,is,the,{pos},cell",
    "which,color,fills,the,{pos},cell",
    "tell,me,the,color,of,the,{pos},cell",
    "the,{pos},cell,is,what,color",
]

GRIDPAIR_TEMPLATES = [
    "what,colors,are,the,{p1},and,{p2},cells",
    "name,the,colors,of,the,{p1},cell,then,the,{p2},cell",
    "reading,{p1},first,then,{p2},which,colors,do,you,see",
    "give,the,{p1},cell,color,followed,by,the,{p2},cell,color",
]


def make_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """Textured two-tone image (the label comes from its decoded JPEG)."""
    r_level = rng.uniform(40, 215)
    b_level = rng.uniform(40, 215)
    while abs(r_level - b_level) < 25:  # keep labels robust to JPEG loss
        b_level = rng.uniform(40, 215)
    img = np.zeros((size, size, 3), np.float32)
    img[..., 0] = r_level
    img[..., 2] = b_level
    img[..., 1] = rng.uniform(40, 215)
    # low-frequency texture + noise so JPEG content is non-degenerate
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for c in range(3):
        img[..., c] += 30 * np.sin(2 * np.pi * (rng.uniform(1, 4) * xx
                                                + rng.uniform(1, 4) * yy))
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_grid_image(rng: np.random.Generator, size: int, noise: float,
                    cell_fill: float, n: int, colors: list[str]):
    """n x n colored-cell image; returns (image, {(r, c): color_name})."""
    img = rng.uniform(90, 150, (size, size, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for c in range(3):
        img[..., c] += 25 * np.sin(2 * np.pi * (rng.uniform(1, 3) * xx
                                                + rng.uniform(1, 3) * yy))
    cells = {}
    cell = size // n
    pad = int(cell * (1 - cell_fill) / 2)
    for r in range(n):
        for c in range(n):
            name = colors[rng.integers(0, len(colors))]
            cells[(r, c)] = name
            col = np.asarray(GRID_COLORS[name], np.float32)
            col = col * rng.uniform(0.85, 1.15)          # brightness jitter
            y0, x0 = r * cell + pad, c * cell + pad
            y1, x1 = (r + 1) * cell - pad, (c + 1) * cell - pad
            img[y0:y1, x0:x1] = col
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), cells


def encode_jpeg(path: str, img: np.ndarray, quality: int, redblue_label: bool):
    """Write ``img`` as a JPEG; with ``redblue_label`` return the decoded
    file's answer ("yes" iff mean(R) > mean(B)), else None."""
    from PIL import Image

    Image.fromarray(img).save(path, quality=quality)
    if not redblue_label:
        return None
    back = np.asarray(Image.open(path))
    return "yes" if back[..., 0].mean() > back[..., 2].mean() else "no"


class JpegWriter:
    """Encodes ``n_images`` images in order of submission, in a pool of
    spawned processes (one per core, at most 8 and at most one an image)."""

    def __init__(self, out_dir: str, quality: int, n_images: int):
        self.dir, self.quality = os.path.join(out_dir, "imgs"), quality
        self.pool = ProcessPoolExecutor(max(1, min(8, os.cpu_count() or 1, n_images)),
                                        mp_context=multiprocessing.get_context("spawn"))
        self.pending = []

    def put(self, name: str, img: np.ndarray, redblue_label: bool = False) -> None:
        self.pending.append(self.pool.submit(encode_jpeg, os.path.join(self.dir, name), img,
                                             self.quality, redblue_label))

    def results(self) -> list:
        """Every image's result, in order of submission; closes the pool."""
        try:
            return [p.result() for p in self.pending]
        finally:
            self.pool.shutdown()


def generate_grid(args, rng, writer: JpegWriter):
    """The K >= 10 grid-color task: per-question answers from one image."""
    n_images = (args.n_train + args.n_val) // args.questions_per_image
    pos_map = GRID_POS_2 if args.grid_n == 2 else GRID_POS_3
    colors = list(GRID_COLORS)[:args.n_colors]
    positions = list(pos_map)
    pairs = []
    for i in range(n_images):
        img, cells = make_grid_image(rng, args.size, args.noise,
                                     args.cell_fill, args.grid_n, colors)
        name = f"synth_{i:06d}.jpg"
        writer.put(name, img)
        # the same image answers differently per question (joint reasoning,
        # not an image prior); positions repeat, with other templates, when
        # there are more questions per image than cells
        ps = [positions[p] for p in
              rng.permutation(len(positions))[:args.questions_per_image]]
        while len(ps) < args.questions_per_image:
            ps.append(positions[rng.integers(0, len(positions))])
        for pos in ps:
            t = GRID_TEMPLATES[rng.integers(0, len(GRID_TEMPLATES))]
            pairs.append((name, t.format(pos=pos_map[pos]), cells[pos]))
    writer.results()
    rng.shuffle(pairs)
    return pairs


def generate_gridpair(args, rng, writer: JpegWriter):
    """Two ordered grid positions a question; the compound answer
    "<color1>-<color2>" gives K = n_colors² classes (144 at the default
    palette), trained into a --num_cls 1000 head."""
    n_images = (args.n_train + args.n_val) // args.questions_per_image
    pos_map = GRID_POS_2 if args.grid_n == 2 else GRID_POS_3
    colors = list(GRID_COLORS)[:args.n_colors]
    positions = list(pos_map)
    pairs = []
    for i in range(n_images):
        img, cells = make_grid_image(rng, args.size, args.noise,
                                     args.cell_fill, args.grid_n, colors)
        name = f"synth_{i:06d}.jpg"
        writer.put(name, img)
        for _ in range(args.questions_per_image):
            a, b = rng.permutation(len(positions))[:2]
            p1, p2 = positions[a], positions[b]
            t = GRIDPAIR_TEMPLATES[rng.integers(0, len(GRIDPAIR_TEMPLATES))]
            pairs.append((name, t.format(p1=pos_map[p1], p2=pos_map[p2]),
                          f"{cells[p1]}-{cells[p2]}"))
    writer.results()
    rng.shuffle(pairs)
    return pairs


def generate_redblue(args, rng, writer: JpegWriter):
    """The K = 2 task: every image drawn, then the questions."""
    n_images = (args.n_train + args.n_val) // args.questions_per_image
    names = []
    for i in range(n_images):
        names.append(f"synth_{i:06d}.jpg")
        writer.put(names[-1], make_image(rng, args.size), redblue_label=True)
    answers = writer.results()
    pairs = []
    for name, ans in zip(names, answers):
        for _ in range(args.questions_per_image):
            pairs.append((name, TEMPLATES[rng.integers(0, len(TEMPLATES))], ans))
    rng.shuffle(pairs)
    return pairs


def write_split(path, pairs):
    with open(path, "w") as f:
        for name, q, a in pairs:
            f.write(f"{name}\t{q}\t{a}\n")


def make_vgg11_bn_state_dict(seed: int = 0):
    """Random-init state dict with torchvision ``vgg11_bn``'s exact keys
    (torchvision's init: kaiming convs, N(0, 0.01) linears)."""
    import torch
    import torch.nn as nn

    torch.manual_seed(seed)
    feats, in_c = [], 3
    for v in VGG11_CFG:
        if v == "M":
            feats.append(nn.MaxPool2d(2, 2))
        else:
            feats += [nn.Conv2d(in_c, v, 3, padding=1), nn.BatchNorm2d(v),
                      nn.ReLU(inplace=True)]
            in_c = v
    m = nn.Module()
    m.features = nn.Sequential(*feats)
    m.avgpool = nn.AdaptiveAvgPool2d((7, 7))
    m.classifier = nn.Sequential(
        nn.Linear(512 * 7 * 7, 4096), nn.ReLU(True), nn.Dropout(),
        nn.Linear(4096, 4096), nn.ReLU(True), nn.Dropout(),
        nn.Linear(4096, 1000))
    for mod in m.modules():
        if isinstance(mod, nn.Conv2d):
            nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                    nonlinearity="relu")
            nn.init.constant_(mod.bias, 0)
        elif isinstance(mod, nn.BatchNorm2d):
            nn.init.constant_(mod.weight, 1)
            nn.init.constant_(mod.bias, 0)
        elif isinstance(mod, nn.Linear):
            nn.init.normal_(mod.weight, 0, 0.01)
            nn.init.constant_(mod.bias, 0)
    return m.state_dict()


def vgg11_bn_keys() -> set[str]:
    """The key set of :func:`make_vgg11_bn_state_dict`, without drawing it."""
    keys, idx = set(), 0
    for v in VGG11_CFG:
        if v == "M":
            idx += 1
            continue
        keys |= {f"features.{idx}.{p}" for p in ("weight", "bias")}
        keys |= {f"features.{idx + 1}.{p}" for p in ("weight", "bias", "running_mean",
                                                     "running_var", "num_batches_tracked")}
        idx += 3
    return keys | {f"classifier.{i}.{p}" for i in (0, 3, 6) for p in ("weight", "bias")}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--n_train", type=int, default=10000)
    ap.add_argument("--n_val", type=int, default=2000)
    ap.add_argument("--questions_per_image", type=int, default=5)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jpeg_quality", type=int, default=88)
    ap.add_argument("--task", choices=["redblue", "grid", "gridpair"],
                    default="redblue")
    ap.add_argument("--noise", type=float, default=25.0,
                    help="grid task: pixel noise sigma (difficulty knob)")
    ap.add_argument("--cell_fill", type=float, default=0.7,
                    help="grid task: colored fraction of each cell side")
    ap.add_argument("--grid_n", type=int, default=3, choices=[2, 3],
                    help="grid task: cells per side (4 or 9 positions)")
    ap.add_argument("--n_colors", type=int, default=12,
                    help="grid task: palette size (answer classes)")
    return ap


def main(argv=None) -> dict:
    """Write the dataset; returns its files, K and sizes."""
    args = build_parser().parse_args(argv)
    from ..vocab import save_vocab

    os.makedirs(os.path.join(args.out_dir, "imgs"), exist_ok=True)
    rng = np.random.default_rng(args.seed)
    n_images = (args.n_train + args.n_val) // args.questions_per_image
    writer = JpegWriter(args.out_dir, args.jpeg_quality, n_images)
    generate, k = {"grid": (generate_grid, args.n_colors),
                   "gridpair": (generate_gridpair, args.n_colors ** 2),
                   "redblue": (generate_redblue, 2)}[args.task]
    pairs = generate(args, rng, writer)
    train, val = pairs[:args.n_train], pairs[args.n_train:args.n_train + args.n_val]
    files = {name: os.path.join(args.out_dir, name)
             for name in ("train.txt", "val.txt", "vocab.pkl", "vgg11_bn_synth.pth")}
    write_split(files["train.txt"], train)
    write_split(files["val.txt"], val)
    save_vocab(files["train.txt"], files["vocab.pkl"], min_word_count=1, K=k)

    import torch
    torch.save(make_vgg11_bn_state_dict(args.seed), files["vgg11_bn_synth.pth"])

    top = Counter(a for _, _, a in train).most_common(3)
    print(f"{args.out_dir}: task={args.task} {len(train)} train / {len(val)} "
          f"val pairs over {n_images} JPEGs; top answers {top}")
    return {"files": files, "imgs": os.path.join(args.out_dir, "imgs"), "K": k,
            "n_train": len(train), "n_val": len(val), "n_images": n_images}


if __name__ == "__main__":
    main()
