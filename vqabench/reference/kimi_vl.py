"""Kimi-VL-A3B's language model as a VQA head, in plain PyTorch float32.

The decoder of Kimi-VL-A3B-Instruct's ``config.json``
(https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct): DeepSeek-V3's
layer (arXiv 2412.19437, section 2.1) with ``q_lora_rank`` null. Shapes:
image features from the 448x448 tower [B, 14, 14, 512] (one token a
region), question ids [B, L] (0 pads) and lengths [B].

- Connector (assumed: the published tower is MoonViT): LayerNorm(512,
  eps 1e-5) -> Linear -> GELU (erf) -> Linear, a token a region.
- Sequence ``[image ; embedding(ids)]`` (T = 196 + L), RoPE positions 0 ..
  T - 1, causal attention; each layer ``h = x + MLA(rms(x))``, ``x = h +
  FFN(rms(h))``; a final RMSNorm (eps 1e-5) and the position ``196 + len -
  1`` into the classifier.
- MLA: ``q = W_q h`` per head [nope 128 ; rope 64]; ``[c_kv ; k_pe] = W_kva
  h``; ``c_kv`` through an RMSNorm of eps 1e-6 (DeepSeek-V3's code; assumed);
  ``[k_nope ; v] = W_kvb c_kv``; RoPE as DeepSeek-V3's code applies it (the
  adjacent pairs of ``q_pe`` and of the one shared ``k_pe`` moved apart,
  then ``x cos + rotate_half(x) sin``); softmax of ``q k^T / sqrt(192)``
  under the causal mask; ``W_o`` over the heads' ``softmax v``.
- FFN: the first ``first_k_dense_replace`` layers a SwiGLU of width
  ``intermediate_size``; then experts: the router's sigmoid scores over
  all ``n_routed_experts`` in float32, top-``num_experts_per_tok`` of
  scores plus the selection bias, weights the chosen scores over their sum
  times ``routed_scaling_factor``; the output is the shared SwiGLU (width
  ``n_shared_experts`` times the expert width) plus, of the chosen
  experts, those held (the first ``experts_held``), each weighted. Every
  position is routed, pads too; the balance loss and the loads count
  valid positions only.

Training (``train_readings`` calls :func:`logits` once a step, with the
trained leaves requiring a gradient): the batch runs in blocks of
``BLOCK`` samples, each recomputed in the backward
(``torch.utils.checkpoint``), so only one block's activations live at a
time; the balance loss (``BALANCE_ALPHA sum_i f_i P_i`` a sequence,
``f_i = E / (k T) #{t: i chosen}``, ``P_i`` the mean over valid ``t`` of
``s_i / sum_j s_j``, averaged over the sequences and summed over the
layers) enters the gradient with weight one, as in the program's
objective, while the returned logits give the cross-entropy alone, the
loss the program reports. The selection bias (a buffer, ``b``) steps by
``BIAS_GAMMA sign(mean load - load_i)`` from the step's valid loads once
the step's forward is done; the blocks route with the values the step
began with, and so does their recomputation. ``b`` enters only the choice
of experts, so this is the program's update after Adam.

The constants below are the configuration's (a test ties them to
``configs/kimi-vl-a3b-448.json``); the sizes come from the weights' shapes.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import F32, Precision

TOWER_PREFIX = "image_encoder.vgg11_encoder."
TOWER_CONSUMER = "connector.fc1.weight"
OUTPUT = "classifier.weight"
BIAS = 0.05
TOP_K = 6
ROUTED_SCALE = 2.446
ROPE_THETA = 800000.0
RMS_EPS = 1e-5
KV_NORM_EPS = 1e-6
LN_EPS = 1e-5
BALANCE_ALPHA = 1e-4
BIAS_GAMMA = 1e-3
SELECTION_BIAS = "mlp.router.e_score_correction_bias"
TOWER_WIDTH = 512
# samples a block of the training forward and its recomputation
BLOCK = 40


def trainable(key: str) -> bool:
    """Everything but the frozen VGG and the routers' selection biases trains."""
    return not key.startswith("image_encoder.") and not key.endswith(SELECTION_BIAS)


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """The state-dict entries besides the tower: (key, shape, init, scale).

    Scaled so that the check is well conditioned: products U(+-sqrt(3 /
    fan_in)) (unit-scale pre-activations from unit-scale inputs), norms'
    weights U(0.9, 1.1), the embedding N(0, 1), the router's logits of unit
    spread (a gap of about a tenth of it between the sixth and seventh
    expert), the selection bias zero."""
    d, v, k = cfg["hidden_size"], cfg["vocab_size"], cfg["num_classes"]
    h, nope, rope_d = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    w, held = cfg["moe_intermediate_size"], cfg["experts_held"]

    def lin(name, o, i, bias=False):
        out = [(f"{name}.weight", (o, i), "uniform", (3.0 / i) ** 0.5)]
        return out + ([(f"{name}.bias", (o,), "uniform", BIAS)] if bias else [])

    def norm(name, n):
        return [(f"{name}.weight", (n,), "uniform", (0.9, 1.1))]

    def swiglu(name, width):
        return lin(f"{name}.gate_up", 2 * width, d) + lin(f"{name}.down", d, width)

    out = (norm("connector.norm", TOWER_WIDTH) + [("connector.norm.bias", (TOWER_WIDTH,),
                                                   "uniform", BIAS)]
           + lin("connector.fc1", d, TOWER_WIDTH, True) + lin("connector.fc2", d, d, True)
           + [("embed.weight", (v, d), "normal", 1.0)])
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += norm(p + "attn_norm", d) + lin(p + "attn.q_proj", h * (nope + rope_d), d)
        out += lin(p + "attn.kv_a_proj", rank + rope_d, d) + norm(p + "attn.kv_norm", rank)
        out += lin(p + "attn.kv_b_proj", h * (nope + vd), rank) + lin(p + "attn.o_proj", d, h * vd)
        out += norm(p + "mlp_norm", d)
        if i < cfg["first_k_dense_replace"]:
            out += swiglu(p + "mlp", cfg["intermediate_size"])
            continue
        out += lin(p + "mlp.router", cfg["n_routed_experts"], d)
        out += [(p + SELECTION_BIAS, (cfg["n_routed_experts"],), "zeros", 0.0),
                (p + "mlp.experts.gate_up", (held, 2 * w, d), "uniform", (3.0 / d) ** 0.5),
                (p + "mlp.experts.down", (held, d, w), "uniform", (3.0 / w) ** 0.5)]
        out += swiglu(p + "mlp.shared", cfg["n_shared_experts"] * w)
    return out + norm("norm", d) + lin("classifier", k, d, True)


def rms(x: torch.Tensor, weight: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def swiglu(w: dict, pre: str, x: torch.Tensor, p: Precision) -> torch.Tensor:
    gate_up = p.linear(x, w[pre + "gate_up.weight"], None)
    g, u = gate_up.chunk(2, dim=-1)
    return p.linear(F.silu(g) * u, w[pre + "down.weight"], None)


def rope_cos_sin(t: int, dim: int, device):
    """DeepSeek-V3's tables: [T, dim], the frequencies repeated twice."""
    inv = 1.0 / ROPE_THETA ** (torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim)
    freqs = torch.arange(t, dtype=torch.float64, device=device)[:, None] * inv
    emb = torch.cat([freqs, freqs], -1)
    return emb.cos().float(), emb.sin().float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's ``apply_rotary_pos_emb`` on [B, H, T, d]."""
    b, h, t, d = x.shape
    x = x.view(b, h, t, d // 2, 2).transpose(4, 3).reshape(b, h, t, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + half * sin


def mla(w: dict, pre: str, x: torch.Tensor, cos, sin, p: Precision) -> torch.Tensor:
    b, t, _ = x.shape
    rank = w[pre + "kv_norm.weight"].shape[0]
    rope_d = w[pre + "kv_a_proj.weight"].shape[0] - rank
    qw = w[pre + "q_proj.weight"].shape[0]            # heads (nope + rope)
    kvbw = w[pre + "kv_b_proj.weight"].shape[0]       # heads (nope + v)
    ow = w[pre + "o_proj.weight"].shape[1]            # heads v
    heads = (qw - kvbw + ow) // rope_d
    nope, vd = (kvbw - ow) // heads, ow // heads
    q = p.linear(x, w[pre + "q_proj.weight"], None).view(b, t, heads, nope + rope_d).transpose(1, 2)
    kva = p.linear(x, w[pre + "kv_a_proj.weight"], None)
    c_kv, k_pe = kva[..., :rank], kva[..., rank:]
    kv = p.linear(rms(c_kv, w[pre + "kv_norm.weight"], KV_NORM_EPS), w[pre + "kv_b_proj.weight"],
                  None).view(b, t, heads, nope + vd).transpose(1, 2)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe = apply_rope(q[..., nope:], cos, sin)
    k_pe = apply_rope(k_pe.view(b, 1, t, rope_d), cos, sin).expand(b, heads, t, rope_d)
    q = torch.cat([q[..., :nope], q_pe], -1)
    k = torch.cat([k_nope, k_pe], -1)
    scores = p.matmul(q, k.transpose(-1, -2)) / (nope + rope_d) ** 0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = p.matmul(probs, v).transpose(1, 2).reshape(b, t, heads * vd)
    return p.linear(o, w[pre + "o_proj.weight"], None)


def moe(w: dict, pre: str, x: torch.Tensor, valid: torch.Tensor, bias: torch.Tensor,
        p: Precision):
    """(output [B, T, D], the balance loss's mean over the sequences, the
    valid positions' loads [E])."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    s = torch.sigmoid(xf @ w[pre + "router.weight"].t())          # float32, no control
    routed = s.shape[1]
    top = torch.topk(s + bias, TOP_K, dim=-1).indices
    weights = s.gather(1, top)
    weights = weights / weights.sum(-1, keepdim=True) * ROUTED_SCALE
    out = swiglu(w, pre + "shared.", xf, p)
    gate_up, down = w[pre + "experts.gate_up"], w[pre + "experts.down"]
    for e in range(gate_up.shape[0]):
        hit = top == e
        tokens = hit.any(1).nonzero().squeeze(1)
        if tokens.numel() == 0:
            continue
        g, u = p.linear(xf[tokens], gate_up[e], None).chunk(2, dim=-1)
        y = p.linear(F.silu(g) * u, down[e], None)
        out = out.index_add(0, tokens, y * (weights * hit).sum(1)[tokens, None])
    v = valid.reshape(b, t, 1).float()
    n = v.sum(1)
    chosen = torch.zeros_like(s).scatter(1, top, 1.0).view(b, t, routed)
    hits = (chosen * v).sum(1)
    f = hits * routed / (TOP_K * n)
    share = ((s / s.sum(-1, keepdim=True)).view(b, t, routed) * v).sum(1) / n
    return out.view(b, t, d), (f * share).sum(-1).mean(), hits.sum(0)


def forward(w: dict, biases: dict, p: Precision, V: torch.Tensor, ids: torch.Tensor,
            lens: torch.Tensor):
    """(logits [B, K], the balance loss (mean over the sequences, summed over
    the layers), the loads [layers with experts, E]) of one block."""
    b, s, _ = V.shape
    img = F.layer_norm(V, (V.shape[-1],), w["connector.norm.weight"], w["connector.norm.bias"],
                       LN_EPS)
    img = p.linear(F.gelu(p.linear(img, w["connector.fc1.weight"], w["connector.fc1.bias"])),
                   w["connector.fc2.weight"], w["connector.fc2.bias"])
    x = torch.cat([img, w["embed.weight"][ids]], 1)
    t = x.shape[1]
    valid = torch.arange(t, device=x.device)[None, :] < (s + lens)[:, None]
    rope_d = (w["layers.0.attn.kv_a_proj.weight"].shape[0]
              - w["layers.0.attn.kv_norm.weight"].shape[0])
    cos, sin = rope_cos_sin(t, rope_d, x.device)
    aux, loads, i = x.new_zeros(()), [], 0
    while f"layers.{i}.attn_norm.weight" in w:
        pre = f"layers.{i}."
        h = x + mla(w, pre + "attn.", rms(x, w[pre + "attn_norm.weight"]), cos, sin, p)
        n = rms(h, w[pre + "mlp_norm.weight"])
        if pre + "mlp.router.weight" in w:
            y, a, load = moe(w, pre + "mlp.", n, valid, biases[pre + SELECTION_BIAS], p)
            aux, x = aux + a, h + y
            loads.append(load)
        else:
            x = h + swiglu(w, pre + "mlp.", n, p)
        i += 1
    last = x[torch.arange(b, device=x.device), s + lens - 1]
    logits = p.linear(rms(last, w["norm.weight"]), w["classifier.weight"], w["classifier.bias"])
    return logits, BALANCE_ALPHA * aux, torch.stack(loads)


class _WithBalance(torch.autograd.Function):
    """The logits as they are; in the backward the balance loss gets the
    gradient one, as a term of the objective."""

    @staticmethod
    def forward(ctx, logits, balance):
        return logits.view_as(logits)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_ones(())


def logits(w: dict, tower_out: torch.Tensor, ids: torch.Tensor, lens: torch.Tensor,
           p: Precision = F32, masks=()) -> torch.Tensor:
    """[B, K] from the tower's [B, 14, 14, 512] (``masks``: no dropout).
    With trained leaves that require a gradient this is a training step's
    forward (see the module's doc): blocks recomputed in the backward, the
    balance loss in the gradient, the selection biases stepped after."""
    b = tower_out.shape[0]
    V = tower_out.reshape(b, -1, tower_out.shape[-1])
    keys = [k for k in w if k.endswith(SELECTION_BIAS)]
    training = torch.is_grad_enabled() and any(t.requires_grad for t in w.values())
    step = functools.partial(forward, w, {k: w[k].detach().clone() for k in keys}, p)
    outs, balance, loads = [], 0.0, 0
    for s in range(0, b, BLOCK):
        block = (V[s:s + BLOCK], ids[s:s + BLOCK], lens[s:s + BLOCK])
        if training:
            lg, aux, load = checkpoint(step, *block, use_reentrant=False)
        else:
            with torch.no_grad():
                lg, aux, load = step(*block)
        outs.append(lg)
        balance = balance + aux * (lg.shape[0] / b)
        loads = loads + load
    out = torch.cat(outs)
    if not training:
        return out
    with torch.no_grad():
        for key, load in zip(keys, loads):
            w[key] += BIAS_GAMMA * torch.sign(load.mean() - load)
    return _WithBalance.apply(out, balance)


def balance_loss(w: dict, tower_out: torch.Tensor, ids: torch.Tensor, lens: torch.Tensor,
                 p: Precision = F32) -> torch.Tensor:
    """The balance loss of one forward over the whole batch (for tests)."""
    b = tower_out.shape[0]
    biases = {k: w[k] for k in w if k.endswith(SELECTION_BIAS)}
    return forward(w, biases, p, tower_out.reshape(b, -1, tower_out.shape[-1]), ids, lens)[1]


def head_flops(cfg: dict, batch: int) -> tuple[float, float]:
    """(frozen, trained) forward operations of the matrix products after the
    tower at the full question length (T = 196 + max_seq_length): nothing
    frozen; the connector, MLA's projections and its causal scores and
    values, the dense SwiGLU, each expert layer's router, shared experts and
    held experts at their expected rows (N k held / routed), the classifier."""
    s = (cfg["image_size"] // 32) ** 2
    t = s + cfg["max_seq_length"]
    n = batch * t
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope_d, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, w = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    routed, held, k = cfg["n_routed_experts"], cfg["experts_held"], cfg["num_experts_per_tok"]
    dense_layers = cfg["first_k_dense_replace"]
    moe_layers = cfg["num_hidden_layers"] - dense_layers
    connector = 2.0 * batch * s * (TOWER_WIDTH * d + d * d)
    mla_ = (2.0 * n * (d * h * (nope + rope_d) + d * (rank + rope_d) + rank * h * (nope + vd)
                       + h * vd * d)
            + 2.0 * batch * h * (t * (t + 1) / 2) * (nope + rope_d + vd))
    dense = 2.0 * n * 3 * d * cfg["intermediate_size"]
    moe_ = (2.0 * n * d * routed + 2.0 * n * 3 * d * cfg["n_shared_experts"] * w
            + 2.0 * n * k * held / routed * 3 * d * w)
    classifier = 2.0 * batch * d * cfg["num_classes"]
    return 0.0, (connector + cfg["num_hidden_layers"] * mla_ + dense_layers * dense
                 + moe_layers * moe_ + classifier)


def dropout_shapes(cfg: dict, batch: int) -> list[tuple]:
    """The dropout masks a training forward draws, in order: none."""
    return []
