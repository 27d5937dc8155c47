"""Model-config registry and build routing, as in vqa_tpu/config.py:49-190.

The registry and every routing rule are the JAX package's, so the same flags
build the same stage set, hand-offs and stem in both packages. Two changes:

- the int8 backbone's auto-enable at ``opt_lvl >= 1`` checks for a CUDA
  device where vqa_tpu checks for a TPU (vqa_tpu/config.py:117-118); on the
  CPU it stays off, and an explicit ``int8_backbone=True`` is honoured on
  any device;
- the TPU A/B environment knobs (``VQA_CONV0_FORCE``, ``VQA_STEM_FORCE``,
  ``VQA_STEM_CONV1``, ``VQA_HPACK_VARIANT``, ``VQA_HPACK_WPOOL``,
  ``VQA_CONVP_FORCE``) are not carried over: each op has one CUDA kernel.

All three families are ported: ``attention`` (448²), ``baseline`` and
``bert`` (224²); ``bert``'s position table holds
``max(64, max_seq_length)`` positions, as vqa_tpu sizes it. A trainable VGG
recomputes its conv stack in backward (``remat``) in the attention and
baseline models; ``bert`` gets neither ``remat`` nor ``s2d_first``, as
vqa_tpu's ``build_model`` passes neither to it (config.py:191-200).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


def str2bool(v: str) -> bool:
    """'true' / 'false' flag values, as the reference's CLI takes them."""
    v = v.lower()
    if v not in ("true", "false"):
        raise ValueError(f"expected 'true' or 'false', got {v!r}")
    return v == "true"


def int_min_two(k) -> int:
    k = int(k)
    if k < 2:
        raise ValueError("Ensure k >= 2")
    return k


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device for ``--device``; 'cuda' without a card raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass "
                           "--device cpu to run on the CPU)")
    return dev


@dataclass(frozen=True)
class ModelConfig:
    name: str
    image_size: int
    question_params: dict = field(default_factory=dict)
    mlp_dim: int | None = None


MODEL_CONFIGS = {
    "baseline": ModelConfig(
        name="baseline", image_size=224,
        question_params=dict(word_emb_dim=300, hidden_dim=1024)),
    "attention": ModelConfig(
        name="attention", image_size=448,
        question_params=dict(word_emb_dim=512, hidden_dim=512), mlp_dim=1024),
    "bert": ModelConfig(
        name="bert", image_size=224,
        question_params=dict(hidden_dim=768, num_layers=6, num_heads=12)),
}


def compute_dtype_for_opt_lvl(opt_lvl: int) -> torch.dtype:
    """Apex O0-O3 -> precision policy: O0 fp32, O1+ bf16 compute."""
    return torch.float32 if opt_lvl == 0 else torch.bfloat16


def build_model(model_name: str, vocab_size: int, num_classes: int, *,
                device: str | torch.device = "cuda",
                vgg_trainable: bool = False, opt_lvl: int = 1,
                use_pallas: bool = False, s2d_first: bool = False,
                conv0_pallas: bool | None = None,
                int8_backbone: bool | None = None,
                hpack_pool: bool = True,
                fused_stem: bool = True,
                int8_handoff: bool = True,
                int8_stages_override: tuple | None = None,
                max_seq_length: int | None = None,
                generator: torch.Generator | None = None):
    """Instantiate a model by registry name on ``device``.

    Same arguments and routing as vqa_tpu.config.build_model (including
    ``max_seq_length``, which sizes bert's position table), plus
    ``device`` (the int8 auto-enable reads it) and ``generator`` (weight
    init; a seed-0 generator when None). ``conv0_pallas`` keeps its name: it
    selects the fused conv0 stage, which on the card is kernel A.
    """
    device = torch.device(device)
    cfg = MODEL_CONFIGS[model_name]
    dtype = compute_dtype_for_opt_lvl(opt_lvl)
    remat = vgg_trainable
    if conv0_pallas is None:
        conv0_pallas = not vgg_trainable
    conv0_pallas = conv0_pallas and not s2d_first and not vgg_trainable
    if int8_backbone and vgg_trainable:
        raise ValueError("--int8_backbone requires a frozen VGG "
                         "(--vgg_train false)")
    if int8_backbone is None:
        int8_backbone = opt_lvl >= 1 and not vgg_trainable
        if int8_backbone:
            # auto engages on the card only; explicit int8_backbone=True is
            # honoured on any device
            int8_backbone = device.type == "cuda"
            if int8_backbone:
                print("NOTE: --opt_lvl >= 1 enables the int8-PTQ frozen "
                      "backbone; pass --int8_backbone false for pure bf16")
    int8_stages = () if not int8_backbone else (
        (0, 1, 2, 3, 4, 5, 6, 7) if conv0_pallas else (2, 3, 4, 5, 6, 7))
    if not hpack_pool:
        int8_stages = tuple(i for i in int8_stages if i != 1)
    if int8_stages_override is not None and int8_backbone:
        int8_stages = tuple(sorted(set(int8_stages_override)
                                   - (set() if conv0_pallas else {0})))
    hpack_pool = bool(hpack_pool) and bool(int8_stages)
    fused_stem = bool(fused_stem) and hpack_pool and conv0_pallas
    int8_handoff = bool(int8_handoff) and bool(int8_stages)
    vgg_kwargs = dict(vgg_trainable=vgg_trainable, s2d_first=s2d_first,
                      conv0_pallas=conv0_pallas, int8_stages=int8_stages,
                      hpack_pool=hpack_pool, fused_stem=fused_stem,
                      int8_handoff=int8_handoff, dtype=dtype, generator=generator)
    if model_name == "baseline":
        from .models.baseline import VQABaselineNet
        model = VQABaselineNet(vocab_size=vocab_size, K=num_classes, remat=remat,
                               **vgg_kwargs, **cfg.question_params)
    elif model_name == "attention":
        from .models.coattention import HierarchicalCoAttentionNet
        if use_pallas:
            raise NotImplementedError(
                "the fused co-attention Pallas kernel was retired in the JAX "
                "package (PARITY.md M8 criterion; "
                "tools/retired/coattention_kernel.py), and the model does not "
                "take it here either; its port is "
                "vqa_tpu_torch.ops.coattention_kernel.coattention_fused")
        model = HierarchicalCoAttentionNet(
            vocab_size=vocab_size, K=num_classes, mlp_dim=cfg.mlp_dim, remat=remat,
            **vgg_kwargs, **cfg.question_params)
    elif model_name == "bert":
        from .models.bert import VQABertNet
        model = VQABertNet(vocab_size=vocab_size, K=num_classes,
                           max_len=max(64, max_seq_length or 0),
                           **{**vgg_kwargs, "s2d_first": False}, **cfg.question_params)
    else:
        raise KeyError(model_name)
    return model.to(device), cfg
