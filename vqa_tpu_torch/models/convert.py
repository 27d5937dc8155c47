"""flax pytree -> ``.pth`` state dict (the weight bridge), and ``.pth`` <->
the port's modules.

:func:`from_jax` takes the JAX package's parameter and batch-stats trees as
numpy arrays and returns what ``vqa_tpu.models.convert.to_torch`` emits for
the model (the numpy mapping is ported here because ``vqa_tpu.models``
imports flax):

- ``attention`` (convert.py:298-331) and ``baseline`` (:277-296): the
  reference state dict, which the port's modules load with
  ``load_state_dict(strict=True)``. The attention export zeroes embedding
  row 0 (flax masks it at lookup) and synthesizes the unused
  ``co_attention.W_b``; the baseline's embedding is not masked and its row 0
  is kept. The VGG head's fc0 takes its input axis in the reference's CHW
  order (vqa_tpu's is HWC);
- ``bert`` (:182-209): vqa_tpu's flat dict of flax paths (``params.*``,
  ``batch_stats.*``) in flax layouts, since bert has no reference format.
  :func:`bert_flat_to_port` and :func:`bert_port_to_flat` map it onto the
  port's module and back.

:func:`load_pth` reads any of these ``.pth`` files into the port's state
dict; :func:`pth_state_dict` gives a model's ``.pth`` body, which vqa_tpu's
``from_torch`` reads.
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


def _vgg_head_fc0(tree, sd: dict, prefix: str) -> None:
    """fc0 kernel [25088 in HWC order, 4096] -> weight [4096, 25088] in CHW."""
    w = _a(tree["kernel"]).T
    w = w.reshape(w.shape[0], 7, 7, 512).transpose(0, 3, 1, 2).reshape(w.shape[0], -1)
    sd[f"{prefix}.weight"] = np.ascontiguousarray(w)
    sd[f"{prefix}.bias"] = _a(tree["bias"]).copy()


def _vgg_with_head(img_params, img_stats, sd: dict) -> None:
    """The baseline/bert image tower: conv stack, head, embedding FC."""
    vgg = img_params["vgg11_encoder"]
    pre = "image_encoder.vgg11_encoder"
    _vgg(vgg["features"], img_stats["vgg11_encoder"]["features"], f"{pre}.conv_layers", sd)
    _vgg_head_fc0(vgg["classifier"]["fc0"], sd, f"{pre}.fc_layers.1")
    _linear(vgg["classifier"]["fc1"], f"{pre}.fc_layers.4", sd)
    _linear(img_params["embedding_fc"], "image_encoder.embedding_layer.0", sd)


def _rnn(tree, prefix: str, sd: dict) -> None:
    for name, src in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh")):
        sd[f"{prefix}.{name}"] = np.ascontiguousarray(_a(tree[src]).T)
    sd[f"{prefix}.bias_ih_l0"] = _a(tree["b_ih"]).copy()
    sd[f"{prefix}.bias_hh_l0"] = _a(tree["b_hh"]).copy()


def baseline_from_jax(params, batch_stats) -> dict:
    """VQABaselineNet flax trees -> reference-naming numpy dict."""
    q = params["question_encoder"]
    sd: dict = {}
    _vgg_with_head(params["image_encoder"], batch_stats["image_encoder"], sd)
    # not masked at lookup in the baseline: row 0 is a live row
    sd["question_encoder.word_embedding.0.weight"] = _a(q["word_embedding"]["embedding"]).copy()
    _rnn(q["gru"], "question_encoder.gru", sd)
    _linear(q["embedding_fc"], "question_encoder.embedding_layer.0", sd)
    _linear(params["mlp_fc"], "mlp.0", sd)
    _linear(params["fc_final"], "fc_final", sd)
    return sd


def _flatten(tree, prefix: str, out: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}.{k}", out)
        else:
            out[f"{prefix}.{k}"] = _a(v).copy()
    return out


def _unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "."):
            continue
        *path, leaf = key[len(prefix) + 1:].split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def bert_from_jax(params, batch_stats) -> dict:
    """VQABertNet flax trees -> vqa_tpu's flat ``bert_to_torch`` dict."""
    return _flatten(batch_stats, "batch_stats", _flatten(params, "params", {}))


def bert_flat_to_port(flat: dict) -> dict:
    """vqa_tpu's flat bert dict -> the port's VQABertNet state dict (numpy)."""
    flat = {k: _a(v) for k, v in flat.items()}
    params, stats = _unflatten(flat, "params"), _unflatten(flat, "batch_stats")
    if not params:
        raise ValueError("not a vqa_tpu bert .pth: no 'params.*' keys")
    sd: dict = {}
    _vgg_with_head(params["image_encoder"], stats["image_encoder"], sd)
    q = params["question_encoder"]
    sd["question_encoder.token_embedding.weight"] = q["token_embedding"]["embedding"].copy()
    sd["question_encoder.position_embedding"] = q["position_embedding"].copy()
    n_blocks = sum(1 for k in q if k.startswith("block"))
    for i in range(n_blocks):
        blk, pre = q[f"block{i}"], f"question_encoder.blocks.{i}"
        for name in ("query", "key", "value", "out"):
            t = blk["attention"][name]
            d = t["kernel"].shape[-1] if name == "out" else t["kernel"].shape[0]
            sd[f"{pre}.attention.{name}.weight"] = np.ascontiguousarray(
                t["kernel"].reshape(d, d).T)      # [D, H, hd] / [H, hd, D] -> [out, in]
            sd[f"{pre}.attention.{name}.bias"] = t["bias"].reshape(d).copy()
        for name in ("mlp_in", "mlp_out"):
            _linear(blk[name], f"{pre}.{name}", sd)
        for name in ("ln_attn", "ln_mlp"):
            _layer_norm(blk[name], f"{pre}.{name}", sd)
    _layer_norm(q["ln_emb"], "question_encoder.ln_emb", sd)
    _linear(q["embedding_fc"], "question_encoder.embedding_fc", sd)
    _linear(params["mlp_fc"], "mlp.0", sd)
    _linear(params["fc_final"], "fc_final", sd)
    return sd


def _layer_norm(tree, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _a(tree["scale"]).copy()
    sd[f"{prefix}.bias"] = _a(tree["bias"]).copy()


def _kernel(sd: dict, prefix: str) -> dict:
    return {"kernel": np.ascontiguousarray(_a(sd[f"{prefix}.weight"]).T),
            "bias": _a(sd[f"{prefix}.bias"]).copy()}


def bert_port_to_flat(sd: dict, num_heads: int) -> dict:
    """The port's VQABertNet state dict -> vqa_tpu's flat bert dict (numpy),
    the inverse of :func:`bert_flat_to_port`; ``num_heads`` splits the
    attention kernels into flax's [D, H, hd] and [H, hd, D]."""
    sd = {k: _a(v) for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    pre = "image_encoder.vgg11_encoder"
    feats, bn_stats = {}, {}
    for n, i in enumerate(VGG11_TORCH_CONV_IDX):
        c = f"{pre}.conv_layers.{i}"
        kernel = sd[f"{c}.weight"].transpose(2, 3, 1, 0)              # OIHW -> HWIO
        feats[f"conv{n}"] = {"kernel": np.ascontiguousarray(kernel),
                             "bias": sd[f"{c}.bias"].copy()}
        b = f"{pre}.conv_layers.{i + 1}"
        feats[f"bn{n}"] = {"scale": sd[f"{b}.weight"].copy(), "bias": sd[f"{b}.bias"].copy()}
        bn_stats[f"bn{n}"] = {"mean": sd[f"{b}.running_mean"].copy(),
                              "var": sd[f"{b}.running_var"].copy()}
    w0 = sd[f"{pre}.fc_layers.1.weight"]                     # [4096, 25088] CHW
    w0 = w0.reshape(w0.shape[0], 512, 7, 7).transpose(0, 2, 3, 1).reshape(w0.shape[0], -1)
    classifier = {"fc0": {"kernel": np.ascontiguousarray(w0.T),
                          "bias": sd[f"{pre}.fc_layers.1.bias"].copy()},
                  "fc1": _kernel(sd, f"{pre}.fc_layers.4")}
    qp = "question_encoder"
    q = {"token_embedding": {"embedding": sd[f"{qp}.token_embedding.weight"].copy()},
         "position_embedding": sd[f"{qp}.position_embedding"].copy(),
         "ln_emb": {"scale": sd[f"{qp}.ln_emb.weight"].copy(),
                    "bias": sd[f"{qp}.ln_emb.bias"].copy()},
         "embedding_fc": _kernel(sd, f"{qp}.embedding_fc")}
    n_blocks = len({k.split(".")[2] for k in sd if k.startswith(f"{qp}.blocks.")})
    for i in range(n_blocks):
        bp = f"{qp}.blocks.{i}"
        attn = {}
        for name in ("query", "key", "value", "out"):
            w, b = sd[f"{bp}.attention.{name}.weight"], sd[f"{bp}.attention.{name}.bias"]
            d = w.shape[0]
            split = (num_heads, d // num_heads)
            kernel = w.T.reshape(split + (d,)) if name == "out" else w.T.reshape((d,) + split)
            attn[name] = {"kernel": np.ascontiguousarray(kernel),
                          "bias": b.copy() if name == "out" else b.reshape(split).copy()}
        q[f"block{i}"] = {"attention": attn,
                          "mlp_in": _kernel(sd, f"{bp}.mlp_in"),
                          "mlp_out": _kernel(sd, f"{bp}.mlp_out"),
                          **{n: {"scale": sd[f"{bp}.{n}.weight"].copy(),
                                 "bias": sd[f"{bp}.{n}.bias"].copy()}
                             for n in ("ln_attn", "ln_mlp")}}
    params = {"image_encoder": {"vgg11_encoder": {"features": feats, "classifier": classifier},
                                "embedding_fc": _kernel(sd, "image_encoder.embedding_layer.0")},
              "question_encoder": q,
              "mlp_fc": _kernel(sd, "mlp.0"), "fc_final": _kernel(sd, "fc_final")}
    stats = {"image_encoder": {"vgg11_encoder": {"features": bn_stats}}}
    return bert_from_jax(params, stats)


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
    _rnn(q["sentence_lstm"], "question_encoder.sentence_lstm", sd)
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


_FROM_JAX = {"attention": coattention_from_jax, "baseline": baseline_from_jax,
             "bert": bert_from_jax}


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}  # owned, writable


def from_jax(model_name: str, params, batch_stats) -> dict:
    """flax trees (numpy leaves) -> the ``.pth`` state dict of torch tensors
    (for bert the flat dict; :func:`load_pth` / :func:`to_port` map it onto
    the module)."""
    if model_name not in _FROM_JAX:
        raise ValueError(f"unknown model {model_name!r}")
    return _tensors(_FROM_JAX[model_name](params, batch_stats))


def to_port(sd: dict) -> dict:
    """A ``.pth`` state dict -> the port's module state dict: vqa_tpu's flat
    bert dict (``params.*`` keys) is mapped, a reference dict is returned as
    it is."""
    if any(k.startswith("params.") for k in sd):
        return _tensors(bert_flat_to_port({k: v.numpy() if isinstance(v, torch.Tensor) else v
                                           for k, v in sd.items()}))
    return sd


def pth_state_dict(model: torch.nn.Module) -> dict:
    """The model's ``.pth`` body on the CPU: the reference state dict, or for
    bert vqa_tpu's flat dict (what vqa_tpu's ``from_torch`` reads)."""
    from .bert import VQABertNet
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if isinstance(model, VQABertNet):
        heads = model.question_encoder.blocks[0].attention.num_heads
        return _tensors(bert_port_to_flat({k: v.numpy() for k, v in sd.items()}, heads))
    return sd


def load_pth(path: str) -> dict:
    """A ``.pth`` file (reference format, or vqa_tpu's flat bert dict) as the
    port's module state dict, on the CPU."""
    return to_port(torch.load(path, map_location="cpu", weights_only=True))
