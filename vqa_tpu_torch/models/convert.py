"""flax pytree -> reference-format state dict (the weight bridge).

:func:`from_jax` takes the JAX package's parameter and batch-stats trees as
numpy arrays and returns the state dict that
``vqa_tpu.models.convert.coattention_to_torch`` emits (vqa_tpu/models/
convert.py:298-331), which is also the reference ``.pth`` layout: the port's
modules load it with ``load_state_dict(strict=True)``. The numpy mapping is
ported here because ``vqa_tpu.models`` imports flax. Both adjustments are
kept: embedding row 0 is zeroed (flax masks it at lookup) and
``co_attention.W_b`` is synthesized as unused zeros. Only ``attention`` is
ported.
"""

from __future__ import annotations

import numpy as np
import torch

# torchvision vgg11_bn features-Sequential indices of the 8 convs; BN is i+1
VGG11_TORCH_CONV_IDX = (0, 4, 8, 11, 15, 18, 22, 25)


def _a(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32)


def _linear(tree, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(_a(tree["kernel"]).T)
    sd[f"{prefix}.bias"] = _a(tree["bias"]).copy()


def _vgg(params, stats, prefix: str, sd: dict) -> None:
    for n, i in enumerate(VGG11_TORCH_CONV_IDX):
        conv, bn, st = params[f"conv{n}"], params[f"bn{n}"], stats[f"bn{n}"]
        sd[f"{prefix}.{i}.weight"] = np.ascontiguousarray(
            _a(conv["kernel"]).transpose(3, 2, 0, 1))           # HWIO -> OIHW
        sd[f"{prefix}.{i}.bias"] = _a(conv["bias"]).copy()
        sd[f"{prefix}.{i + 1}.weight"] = _a(bn["scale"]).copy()
        sd[f"{prefix}.{i + 1}.bias"] = _a(bn["bias"]).copy()
        sd[f"{prefix}.{i + 1}.running_mean"] = _a(st["mean"]).copy()
        sd[f"{prefix}.{i + 1}.running_var"] = _a(st["var"]).copy()
        sd[f"{prefix}.{i + 1}.num_batches_tracked"] = np.asarray(0, np.int64)


def coattention_from_jax(params, batch_stats) -> dict:
    """HierarchicalCoAttentionNet flax trees -> reference-naming numpy dict."""
    q = params["question_encoder"]
    sd: dict = {}
    _vgg(params["image_encoder"]["vgg11_encoder"]["features"],
         batch_stats["image_encoder"]["vgg11_encoder"]["features"],
         "image_encoder.vgg11_encoder", sd)
    emb = _a(q["word_embedding"]["embedding"]).copy()
    emb[0] = 0.0          # flax masks id 0 at lookup; the stored row is random
    sd["question_encoder.word_embedding.weight"] = emb
    pcp = q["phrase_conv_pool"]
    for gram in ("unigram", "bigram", "trigram"):
        key = f"question_encoder.phrase_conv_pool.conv_{gram}.1"
        sd[f"{key}.weight"] = np.ascontiguousarray(
            _a(pcp[f"conv_{gram}_kernel"]).transpose(2, 1, 0))  # [k,in,out] -> [out,in,k]
        sd[f"{key}.bias"] = _a(pcp[f"conv_{gram}_bias"]).copy()
    lstm = q["sentence_lstm"]
    for name, src in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh")):
        sd[f"question_encoder.sentence_lstm.{name}"] = np.ascontiguousarray(_a(lstm[src]).T)
    sd["question_encoder.sentence_lstm.bias_ih_l0"] = _a(lstm["b_ih"]).copy()
    sd["question_encoder.sentence_lstm.bias_hh_l0"] = _a(lstm["b_hh"]).copy()
    co = params["co_attention"]
    d = _a(co["W_v_kernel"]).shape[0]
    sd["co_attention.W_b.weight"] = np.zeros((d, d), np.float32)
    sd["co_attention.W_b.bias"] = np.zeros((d,), np.float32)
    for name in ("W_v", "W_q", "w_v", "w_q"):
        _linear({"kernel": co[f"{name}_kernel"], "bias": co[f"{name}_bias"]},
                f"co_attention.{name}", sd)
    for w in ("W_w", "W_p", "W_s", "W_h"):
        _linear(params["mlp_classify"][w], f"mlp_classify.{w}", sd)
    return sd


def from_jax(model_name: str, params, batch_stats) -> dict:
    """flax trees (numpy leaves) -> state dict of torch tensors."""
    if model_name != "attention":
        raise NotImplementedError(f"the {model_name!r} model is not ported yet")
    return {k: torch.from_numpy(np.array(v))      # owned, writable buffers
            for k, v in coattention_from_jax(params, batch_stats).items()}


def load_pth(path: str) -> dict:
    """A reference-format ``.pth`` state dict, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
