"""One-command dress rehearsal of the production sequence, through the CLIs.

Port of tools/dress_rehearsal.py. Each stage runs the port's own command
line in a fresh process, as a user would:

  1. ``vqa_tpu_torch.prepare_data`` on VQA-v2-schema annotation and
     question JSON (``--ann``/``--ques``, or a generated real-schema pair);
  2. JPEG files under the COCO names the ETL wrote (``--img_dir``, or
     synthesized 64x64 JPEGs);
  3. ``vqa_tpu_torch.main --mode train`` on the real decode path
     (``--decode_backend auto``, no synthetic images), one checkpoint an
     epoch;
  4. ``vqa_tpu_torch.main --mode test --test_out_format vqa``: the official
     results JSON (question_id = the line's index);
  5. ``vqa_tpu_torch.datahelper.VQA.loadRes`` on that JSON (and the accuracy
     against the annotations where their question ids follow line order,
     as the generated pair's do);
  6. ``vqa_tpu_torch.serve`` on the trained checkpoint (its int8 scales from
     the run's sidecar).

On the card (``--device cuda``, the default) training, test and serving
run at ``--opt_lvl 1`` (the int8 route, kernels A and B); ``--device cpu``
runs ``--opt_lvl 0``.

    python -m vqa_tpu_torch.tools.dress_rehearsal [--device cpu]
    python -m vqa_tpu_torch.tools.dress_rehearsal --ann <annotations.json> \\
        --ques <questions.json> --img_dir <train2014/> --epochs 12 \\
        --batch_size 160 --image_size 448 --model attention --num_cls 1000
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(f"[rehearsal] {msg}", flush=True)


def run_cli(argv: list[str]) -> float:
    """Run one command from the repository root; returns its seconds."""
    log("$ " + " ".join(argv))
    t0 = time.perf_counter()
    subprocess.run(argv, check=True, cwd=REPO)
    seconds = time.perf_counter() - t0
    log(f"  done in {seconds:.1f}s")
    return seconds


def make_synthetic_vqa_json(work: str, n_images: int = 8,
                            per_image: int = 3) -> tuple[str, str]:
    """A VQA-v2-schema annotation/question pair with question_id = emit
    order, the real files' property that loadRes scoring relies on."""
    templates = [
        ("what is", "What is on the {}?", ["cat", "dog", "book"]),
        ("is the", "Is the {} asleep?", ["yes", "no"]),
        ("what color", "What color is the {}?", ["black", "brown", "white"]),
    ]
    nouns = ["bed", "cat", "table", "dog", "chair", "sofa", "desk", "car"]
    annotations, questions = [], []
    qid = 0
    for img in range(n_images):
        image_id = 1000 + img * 37  # non-contiguous, like real COCO ids
        for k in range(per_image):
            qtype, qtmpl, answers = templates[k % len(templates)]
            ans = answers[(img + k) % len(answers)]
            annotations.append({
                "image_id": image_id, "question_id": qid,
                "question_type": qtype,
                "answer_type": "yes/no" if ans in ("yes", "no") else "other",
                "multiple_choice_answer": ans,
                "answers": [{"answer": ans, "answer_id": 1,
                             "answer_confidence": "yes"}]})
            questions.append({"question_id": qid, "image_id": image_id,
                              "question": qtmpl.format(nouns[img % len(nouns)])})
            qid += 1
    ann = os.path.join(work, "annotations.json")
    ques = os.path.join(work, "questions.json")
    # real VQA-v2 files carry these header keys; loadRes copies them
    header = {"info": {"version": "2.0"}, "task_type": "Open-Ended",
              "data_type": "mscoco", "data_subtype": "train2014",
              "license": {}}
    with open(ann, "w") as f:
        json.dump(dict(header, annotations=annotations), f)
    with open(ques, "w") as f:
        json.dump(dict(header, questions=questions), f)
    return ann, ques


def synthesize_images(img_dir: str, names: set, size: int = 64) -> int:
    import numpy as np
    from PIL import Image

    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    made = 0
    for name in sorted(names):
        p = os.path.join(img_dir, name)
        if not os.path.exists(p):
            Image.fromarray(rng.integers(0, 255, (size, size, 3),
                                         dtype=np.uint8), "RGB").save(p)
            made += 1
    return made


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ann", default=None, help="VQA-v2 annotation JSON "
                   "(default: generate a synthetic real-schema pair)")
    p.add_argument("--ques", default=None, help="VQA-v2 question JSON")
    p.add_argument("--img_dir", default=None,
                   help="dir of COCO-named JPEGs (default: synthesize)")
    p.add_argument("--work_dir", default=os.path.join(REPO, "build", "dress_rehearsal"))
    p.add_argument("--model", default="baseline")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=3)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--num_cls", type=int, default=10)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="the child CLIs' --device: cuda (the default) needs a card")
    return p


def main(argv=None) -> dict:
    """Run the six stages; returns each stage's seconds and the loadRes
    accuracy (None where the question ids are line indices)."""
    from ._run import device_and_card

    args = build_parser().parse_args(argv)
    device_and_card(args.device)
    work = args.work_dir
    os.makedirs(work, exist_ok=True)
    py = sys.executable
    t_start = time.perf_counter()
    seconds = {}

    # -- 1. ETL ------------------------------------------------------------
    ann, ques = (args.ann, args.ques)
    if ann is None or ques is None:
        ann, ques = make_synthetic_vqa_json(work)
        log(f"generated synthetic VQA-v2-schema JSON: {ann}, {ques}")
    train_txt = os.path.join(work, "train.txt")
    vocab_pkl = os.path.join(work, "vocab.pkl")
    seconds["etl"] = run_cli([py, "-m", "vqa_tpu_torch.prepare_data",
                              "--balanced_real_images", "-s", "train", "-a", ann, "-q", ques,
                              "-o", train_txt, "-v", vocab_pkl, "-c", "1",
                              "-K", str(args.num_cls)])
    with open(train_txt) as f:
        lines = f.read().strip().split("\n")
    names = {ln.split("\t")[0] for ln in lines}
    log(f"ETL emitted {len(lines)} QA pairs over {len(names)} images")

    # -- 2. images ----------------------------------------------------------
    img_dir = args.img_dir or os.path.join(work, "imgs")
    if args.img_dir is None:
        made = synthesize_images(img_dir, names)
        log(f"synthesized {made} JPEGs under COCO names in {img_dir}")
    missing = [n for n in names if not os.path.exists(os.path.join(img_dir, n))]
    if missing:
        raise SystemExit(f"{len(missing)} referenced images missing from "
                         f"{img_dir}, e.g. {missing[:3]}")

    # -- 3. train (real decode path) ------------------------------------------
    expt = os.path.join(work, "expt")
    opt_lvl = "0" if args.device == "cpu" else "1"
    common = ["--model", args.model, "--vocab_file", vocab_pkl,
              "--expt_dir", expt, "--expt_name", "rehearsal", "--run_name",
              "r", "--batch_size", str(args.batch_size),
              "--num_cls", str(args.num_cls),
              "--num_workers", str(args.num_workers),
              "--image_size", str(args.image_size), "--opt_lvl", opt_lvl,
              "--decode_backend", "auto", "--device", args.device]
    steps_per_epoch = max(1, len(lines) // args.batch_size)
    run_dir = os.path.join(expt, "rehearsal", "r")
    if os.path.isdir(run_dir):          # a fresh run, not a resume of an old one
        import shutil
        shutil.rmtree(run_dir)
    seconds["train"] = run_cli([py, "-m", "vqa_tpu_torch.main", "--mode", "train",
                                "--train_img", img_dir, "--train_file", train_txt,
                                "--num_epochs", str(args.epochs),
                                "--save_interval", str(steps_per_epoch),
                                "--log_interval", "5"] + common)
    ckpts = sorted((f for f in os.listdir(run_dir) if f.startswith("model_")),
                   key=lambda f: int(f.split("_")[1].split(".")[0]))
    if not ckpts:
        raise SystemExit(f"no checkpoint written under {run_dir}")
    log(f"trained; latest checkpoint {ckpts[-1]}")

    # -- 4. test mode -> official results JSON -------------------------------
    results = os.path.join(work, "results_vqa.json")
    seconds["test"] = run_cli([py, "-m", "vqa_tpu_torch.main", "--mode", "test",
                               "--val_img", img_dir, "--val_file", train_txt,
                               "--model_ckpt", ckpts[-1], "--test_out", results,
                               "--test_out_format", "vqa"] + common)

    # -- 5. loadRes round-trip ------------------------------------------------
    from ..datahelper import VQA

    helper = VQA(ann, ques)
    res = VQA.loadRes(helper, results, ques)
    with open(results) as f:
        recs = json.load(f)
    if len(recs) != len(lines):
        raise SystemExit(f"results hold {len(recs)} records for {len(lines)} questions")
    emitted_qids = [r["question_id"] for r in recs]
    with open(ann) as f:
        annotations = json.load(f)["annotations"]
    acc = None
    if emitted_qids == [a["question_id"] for a in annotations]:
        gt = {a["question_id"]: a["multiple_choice_answer"] for a in annotations}
        acc = 100.0 * sum(res.qa[q]["answer"] == gt[q]
                          for q in emitted_qids) / len(emitted_qids)
        log(f"loadRes round-trip OK; accuracy vs GT: {acc:.2f}% "
            f"({len(emitted_qids)} questions)")
    else:
        log("loadRes round-trip OK (format validated); question_ids are "
            "line indices — remap to annotation ids before official scoring")

    # -- 6. serve smoke ---------------------------------------------------------
    preds = os.path.join(work, "serve_preds.jsonl")
    seconds["serve"] = run_cli([py, "-m", "vqa_tpu_torch.serve", "--model", args.model,
                                "--vocab_file", vocab_pkl,
                                "--model_ckpt", os.path.join(run_dir, ckpts[-1]),
                                "--img_dir", img_dir, "--input", train_txt, "--output", preds,
                                "--batch_size", str(args.batch_size),
                                "--image_size", str(args.image_size), "--opt_lvl", opt_lvl,
                                "--device", args.device])
    with open(preds) as f:
        served = [json.loads(ln) for ln in f]
    if len(served) != len(lines) or not all(
            {"image", "question", "answer", "prob"} <= set(r) for r in served):
        raise SystemExit(f"serve wrote {len(served)} predictions for {len(lines)} "
                         f"questions, or records without image/question/answer/prob")
    log(f"serve smoke OK ({len(served)} predictions)")

    seconds["total"] = time.perf_counter() - t_start
    log(f"DRESS REHEARSAL PASS in {seconds['total']:.1f}s (work dir: {work})")
    return {"seconds": seconds, "accuracy": acc, "pairs": len(lines)}


if __name__ == "__main__":
    main()
