"""Dataset ETL: VQA-v2 JSON -> flat ``img\\tq,tokens\\tans`` text file (+ vocab)
(the port's copy of vqa_tpu/prepare_data.py).

The reference's CLI (prepare_data.py:40-104): flags -s/-a/-q/-o/-v/-c/-K and
--balanced_real_images / --abstract_scene_images. The output is the same
bytes as vqa_tpu's:

- image name = COCO file name from the image id, zero-padded to 12 digits
  (the ``COCO_<split>2014_000000`` prefix + a 6-digit pad; abstract scenes:
  a 5-digit pad, train split only);
- question = the raw question's whitespace tokens joined by commas;
- answer = ``multiple_choice_answer``.

With ``-v`` the vocab pickle is built from the written file
(:func:`vqa_tpu_torch.vocab.save_vocab`).

    python -m vqa_tpu_torch.prepare_data --balanced_real_images -s train \\
        -a v2_mscoco_train2014_annotations.json \\
        -q v2_OpenEnded_mscoco_train2014_questions.json \\
        -o vqa_train2014.txt -v vocab_count_5_K_1000.pkl -c 5 -K 1000
"""

from __future__ import annotations

import argparse

from .datahelper import VQA
from .vocab import save_vocab


def coco_pad(num: int, balanced_real_images: bool) -> str:
    """Zero-pad an image id: 6 digits for COCO, 5 for abstract scenes (the
    prefix carries the other leading zeros)."""
    total_digits = 6 if balanced_real_images else 5
    s = str(num)
    return "0" * (total_digits - len(s)) + s


def image_affixes(split: str, balanced_real_images: bool, abstract_scene_images: bool):
    """(prefix, postfix) of the image file names for a split and source."""
    if balanced_real_images:
        return f"COCO_{split}2014_000000", ".jpg"
    if abstract_scene_images:
        if split != "train":
            raise NotImplementedError()
        return "abstract_v002_train2015_0000000", ".png"
    raise ValueError("exactly one of --balanced_real_images/--abstract_scene_images required")


def write_dataset(helper: VQA, output_file: str, split: str,
                  balanced_real_images: bool, abstract_scene_images: bool) -> int:
    """Write one ``img\\tq,tokens\\tans`` line per annotation; returns the line count."""
    prefix, postfix = image_affixes(split, balanced_real_images, abstract_scene_images)
    annotations = helper.dataset["annotations"]
    with open(output_file, "w") as out:
        for ann in annotations:
            img_name = prefix + coco_pad(ann["image_id"], balanced_real_images) + postfix
            question = ",".join(helper.qqa[ann["question_id"]]["question"].strip().split())
            out.write(f"{img_name}\t{question}\t{ann['multiple_choice_answer']}\n")
    return len(annotations)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Prepare data for balanced real images QA aka COCO")
    parser.add_argument("-s", "--split", type=str, required=True, choices=["train", "val"],
                        help="split set")
    parser.add_argument("-a", "--annot_file", type=str, required=True,
                        help="path to annotations file (.json)")
    parser.add_argument("-q", "--ques_file", type=str, required=True,
                        help="path to questions file (.json)")
    parser.add_argument("-o", "--output_file", type=str, required=True,
                        help="output (img, ques, ans) dataset file .txt")
    parser.add_argument("-v", "--vocab_file", type=str,
                        help="output training set vocabulary file (.pkl)")
    parser.add_argument("-c", "--min_word_count", type=int, default=5,
                        help="min. word frequency for including in vocab")
    parser.add_argument("-K", "--num_cls", type=int, default=1000,
                        help="top-K most frequent answers as labels")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--balanced_real_images", action="store_true",
                       help="image format is COCO_train2014_000000xxxxxx.jpg")
    group.add_argument("--abstract_scene_images", action="store_true",
                       help="image format is abstract_v002_train2015_0000000xxxxx.png")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not (args.balanced_real_images or args.abstract_scene_images):
        parser.error("one of --balanced_real_images/--abstract_scene_images is required")

    helper = VQA(args.annot_file, args.ques_file)
    write_dataset(helper, args.output_file, args.split,
                  args.balanced_real_images, args.abstract_scene_images)
    print(f"Saved dataset file at: {args.output_file}")

    if args.vocab_file:
        save_vocab(args.output_file, args.vocab_file, args.min_word_count, args.num_cls)


if __name__ == "__main__":
    main()
