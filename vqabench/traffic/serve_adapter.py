"""How the serving loop reaches the program: the port's ``VQAPredictor`` and
its per-batch path (``encode_questions``, then ``_probs``).

A later benchmark change can point these five functions elsewhere without
touching the loop.
"""

from __future__ import annotations


def build(cfg: dict, vocab: dict, batch: int, device):
    """The predictor for ``cfg`` over ``vocab`` (the pickle form), in batches of ``batch``."""
    from vqa_tpu_torch.serve import VQAPredictor
    from vqa_tpu_torch.vocab import Vocab

    predictor = VQAPredictor(cfg["model"], Vocab.from_dict(vocab), None,
                             num_cls=cfg["num_classes"] - 1, batch_size=batch,
                             opt_lvl=cfg["opt_lvl"], int8_backbone=cfg["int8_backbone"],
                             image_size=cfg["image_size"], device=str(device))
    return predictor


def load_weights(predictor, state_dict: dict) -> None:
    predictor.model.load_state_dict(state_dict, strict=True)


def calibrate(predictor, images) -> None:
    """Static int8 scales from one image batch, as the engine calibrates its first."""
    predictor._prepare_batch(images)


def encode(predictor, questions: list[str]):
    return predictor.encode_questions(questions)


def probs(predictor, images, ids, lens):
    return predictor._probs(images, ids, lens)
