"""Kimi-VL-A3B's language model as a VQA head over the int8 448² tower.

The decoder is the DeepSeek-V3 design that Kimi-VL-A3B-Instruct's
``config.json`` sets out (arXiv 2412.19437; keyword names below are that
file's): RMSNorm (eps ``rms_norm_eps``), multi-head latent attention with
``q_lora_rank`` null, RoPE, a dense SwiGLU first layer
(``first_k_dense_replace``) and then mixture-of-experts layers with a
sigmoid router, a selection bias (``noaux_tc``), normalized top-k weights
scaled by ``routed_scaling_factor``, and shared experts.

Forward (:meth:`KimiVLNet.head`):

1. image tokens: the frozen tower's [B, 196, 512] (the attention model's
   encoder, :class:`.coattention.ImageCoAttentionEncoder`), one token a
   region through a connector LayerNorm(512) -> Linear -> GELU -> Linear;
2. question tokens: an embedding of the question ids, pad id 0, no
   position table;
3. the sequence ``[image ; question]`` (T = 196 + L), RoPE positions
   0 .. T - 1, causal attention; pads come after every valid position, so
   no valid position sees them;
4. layers: ``h = x + MLA(norm(x))``, ``x = h + FFN(norm(h))``;
5. a final RMSNorm, then the hidden state at ``196 + length - 1`` into the
   classifier (last-token classification).

MLA (:class:`LatentAttention`): ``q = W_q h`` split per head into a nope
and a rope part; ``[c_kv ; k_pe] = W_kva h``; ``c_kv`` through an RMSNorm
(eps 1e-6, DeepSeek-V3's code); ``[k_nope ; v] = W_kvb c_kv``; RoPE on
``q_pe`` and the one ``k_pe`` shared by the heads, rotating adjacent pairs
(the pairs of DeepSeek-V3's code; it lays the rotated halves out apart,
which changes no score); scale ``1/sqrt(nope + rope)``; keys up-projected
(the training form).

Expert layers (:class:`MoE`) hold ``experts_held`` experts (the model's
are experts 0 .. ``experts_held`` - 1; a layer takes its ``first``): the
router scores all ``n_routed_experts`` (``s = sigmoid(x W_r^T)`` in
float32, top-k of ``s + b``, weights ``s`` there over their sum times
``routed_scaling_factor``), and the layer
returns the shared experts plus its own experts' weighted part; what the
others would add is left out (one rank of expert parallelism, run without
its exchange). Every position, pads included, is dispatched and no token
is dropped; only the pairs routed to held experts are gathered and
multiplied. The grouped products are :mod:`..ops.moe_gmm`'s, one launch a
product a layer.

Training extras, which ``train.steps`` calls where a model has them:
:meth:`KimiVLNet.balance_loss` (DeepSeek-V3's sequence-wise balance loss,
``alpha sum_i f_i P_i`` a sequence over valid positions, averaged over the
sequences, summed over the layers) and :meth:`KimiVLNet.update_router_bias`
(after the optimizer: ``b_i += gamma sign(mean load - load_i)`` from the
valid positions' loads of the step's forwards; ``b`` is a buffer).

Precision: under the bf16 policy the products run in bf16 (autocast and
the grouped products' explicit casts); the residual stream, every norm,
the router and its weights stay in float32. Under the float32 policy the
grouped products are IEEE float32 (:mod:`..ops.moe_gmm`'s plain version).

Spans: ``vqa.model.mla``, ``vqa.model.moe`` and inside it
``vqa.model.route`` (router, top-k, balance statistics, the plan and the
gather) and ``vqa.model.experts`` (around each grouped product). Counter
``vqa.model.expert_rows.<layer>``: the pairs routed to each held expert,
then those routed to experts not held, summed on the card.

Construction: the head is built without an initialization on the
``meta`` device and then initialized on ``device`` from a generator there
(seeded from ``generator``), so 1.3 B parameters never pass through the
host.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import moe_gmm
from ..train.profiling import count, span
from .base import VQANet
from .coattention import ImageCoAttentionEncoder
from .vgg import VGGFeatures

TOWER_WIDTH = 512
KV_NORM_EPS = 1e-6
BALANCE_ALPHA = 1e-4
BIAS_GAMMA = 1e-3


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


def rope_tables(positions: int, dim: int, theta: float, device) -> tuple:
    """cos, sin [T, dim / 2] (float32) of RoPE's adjacent pairs."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim)
    angles = torch.arange(positions, dtype=torch.float64, device=device)[:, None] * inv
    return angles.cos().float(), angles.sin().float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs of ``x`` [B, T, H, d] by position (in float32)."""
    pairs = x.float().unflatten(-1, (-1, 2))
    x0, x1 = pairs[..., 0], pairs[..., 1]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).flatten(-2).to(x.dtype)


class LatentAttention(nn.Module):
    def __init__(self, d: int, heads: int, nope: int, rope_dim: int, v_dim: int, rank: int):
        super().__init__()
        self.heads, self.nope, self.rope_dim = heads, nope, rope_dim
        self.v_dim, self.rank = v_dim, rank
        self.q_proj = nn.Linear(d, heads * (nope + rope_dim), bias=False)
        self.kv_a_proj = nn.Linear(d, rank + rope_dim, bias=False)
        self.kv_norm = RMSNorm(rank, KV_NORM_EPS)
        self.kv_b_proj = nn.Linear(rank, heads * (nope + v_dim), bias=False)
        self.o_proj = nn.Linear(heads * v_dim, d, bias=False)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h = self.heads
        q_nope, q_pe = self.q_proj(x).view(b, t, h, -1).split([self.nope, self.rope_dim], -1)
        c_kv, k_pe = self.kv_a_proj(x).split([self.rank, self.rope_dim], -1)
        kv = self.kv_b_proj(self.kv_norm(c_kv)).view(b, t, h, -1)
        k_nope, v = kv.split([self.nope, self.v_dim], -1)
        dtype = v.dtype
        q = torch.cat([q_nope, rope(q_pe, cos, sin).to(dtype)], -1)
        k_pe = rope(k_pe.unsqueeze(2), cos, sin).to(dtype).expand(b, t, h, self.rope_dim)
        k = torch.cat([k_nope, k_pe], -1)
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                           is_causal=True,
                                           scale=(self.nope + self.rope_dim) ** -0.5)
        return self.o_proj(o.transpose(1, 2).reshape(b, t, h * self.v_dim))


class SwiGLU(nn.Module):
    """``down(silu(gate x) * up x)``, gate and up as one product."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.width = width
        self.gate_up = nn.Linear(d, 2 * width, bias=False)
        self.down = nn.Linear(width, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, u = self.gate_up(x).split(self.width, -1)
        return self.down(F.silu(g) * u)


class Router(nn.Module):
    """Sigmoid scores over every routed expert, in float32, and the
    selection bias ``e_score_correction_bias`` (a buffer: no gradient)."""

    def __init__(self, d: int, experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, d))
        self.register_buffer("e_score_correction_bias", torch.empty(experts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return torch.sigmoid(F.linear(x.float(), self.weight.float()))


class Experts(nn.Module):
    """The held experts' SwiGLU weights, stacked: ``gate_up`` [E, 2 w, d],
    ``down`` [E, d, w]."""

    def __init__(self, held: int, d: int, width: int):
        super().__init__()
        self.width = width
        self.gate_up = nn.Parameter(torch.empty(held, 2 * width, d))
        self.down = nn.Parameter(torch.empty(held, d, width))

    def forward(self, x: torch.Tensor, p: moe_gmm.Plan) -> torch.Tensor:
        with span("vqa.model.experts"):
            h = moe_gmm.grouped_mm(x, self.gate_up, p)
        g, u = h.split(self.width, -1)
        a = F.silu(g) * u
        with span("vqa.model.experts"):
            return moe_gmm.grouped_mm(a, self.down, p)


class MoE(nn.Module):
    def __init__(self, index: int, d: int, width: int, routed: int, held: int, first: int,
                 shared: int, top_k: int, scale: float):
        super().__init__()
        if not 0 <= first <= routed - held:
            raise ValueError(f"experts {first} .. {first + held - 1} not among {routed}")
        self.index, self.routed, self.held, self.first = index, routed, held, first
        self.top_k, self.scale = top_k, scale
        self.router = Router(d, routed)
        self.experts = Experts(held, d, width)
        self.shared = SwiGLU(d, shared * width)
        self.register_buffer("load", torch.zeros(routed), persistent=False)
        self.aux = None

    def forward(self, x: torch.Tensor, valid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, t, d = x.shape
        with span("vqa.model.route"):
            flat = x.reshape(b * t, d)
            s = self.router(flat)
            chosen = torch.topk(s + self.router.e_score_correction_bias, self.top_k, -1).indices
            w = s.gather(1, chosen)
            w = w / w.sum(-1, keepdim=True) * self.scale
            self._statistics(s, chosen, valid)
            p = moe_gmm.plan(chosen, self.first, self.held)
            count(f"vqa.model.expert_rows.{self.index}", p.counts)
            xc = flat.to(dtype)
            rows = moe_gmm.gather_rows(xc, p)
        shared = self.shared(xc)
        if p.rows == 0:                 # no pair routed to an expert held here
            return shared.view(b, t, d)
        return (moe_gmm.combine(self.experts(rows, p), w, p) + shared).view(b, t, d)

    def _statistics(self, s, chosen, valid) -> None:
        """The balance loss of this forward (``self.aux``) and, in training,
        the valid positions' loads for the bias update."""
        b, t = valid.shape
        v = valid.reshape(b, t, 1).float()
        n = v.sum(1)                                             # [B, 1]
        picked = torch.zeros_like(s).scatter_(1, chosen, 1.0).view(b, t, -1)
        hits = (picked * v).sum(1)                               # [B, E]
        share = ((s / s.sum(-1, keepdim=True)).view(b, t, -1) * v).sum(1) / n
        f = hits * (self.routed / self.top_k) / n
        self.aux = BALANCE_ALPHA * (f * share).sum(-1).mean()
        if self.training:
            self.load += hits.sum(0)

    @torch.no_grad()
    def update_bias(self) -> None:
        self.router.e_score_correction_bias += BIAS_GAMMA * torch.sign(self.load.mean() - self.load)
        self.load.zero_()


class DecoderLayer(nn.Module):
    def __init__(self, d: int, eps: float, attn: LatentAttention, mlp: nn.Module):
        super().__init__()
        self.attn_norm = RMSNorm(d, eps)
        self.attn = attn
        self.mlp_norm = RMSNorm(d, eps)
        self.mlp = mlp

    def forward(self, x, cos, sin, valid, dtype):
        with span("vqa.model.mla"):
            h = x + self.attn(self.attn_norm(x), cos, sin)
        n = self.mlp_norm(h)
        if isinstance(self.mlp, MoE):
            with span("vqa.model.moe"):
                return h + self.mlp(n, valid, dtype)
        return h + self.mlp(n)


class Connector(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.norm = nn.LayerNorm(TOWER_WIDTH)
        self.fc1 = nn.Linear(TOWER_WIDTH, d)
        self.fc2 = nn.Linear(d, d)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(v))))


class KimiVLNet(VQANet):
    """The VQA model: logits [B, K]. Keyword names of the decoder's sizes
    are the published config's."""

    def __init__(self, vocab_size: int, K: int, *, hidden_size: int = 2048,
                 num_hidden_layers: int = 5, first_k_dense_replace: int = 1,
                 intermediate_size: int = 11264, moe_intermediate_size: int = 1408,
                 num_attention_heads: int = 16, qk_nope_head_dim: int = 128,
                 qk_rope_head_dim: int = 64, v_head_dim: int = 128, kv_lora_rank: int = 512,
                 n_routed_experts: int = 64, experts_held: int = 32,
                 n_shared_experts: int = 2, num_experts_per_tok: int = 6,
                 routed_scaling_factor: float = 2.446, rope_theta: float = 800000.0,
                 rms_norm_eps: float = 1e-5,
                 vgg_trainable: bool = False, remat: bool = False,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None,
                 device: str | torch.device = "cpu", **vgg_kwargs):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        device = torch.device(device)
        d = hidden_size
        self.dtype = dtype
        self.vgg_trainable = vgg_trainable
        self.remat = remat
        self.rope_dim, self.rope_theta = qk_rope_head_dim, rope_theta
        self.image_encoder = ImageCoAttentionEncoder(generator=generator, dtype=dtype,
                                                     **vgg_kwargs).to(device)
        self.image_encoder.requires_grad_(vgg_trainable)
        with torch.device("meta"):
            self.connector = Connector(d)
            self.embed = nn.Embedding(vocab_size, d, padding_idx=0)
            layers = []
            for i in range(num_hidden_layers):
                attn = LatentAttention(d, num_attention_heads, qk_nope_head_dim,
                                       qk_rope_head_dim, v_head_dim, kv_lora_rank)
                mlp = (SwiGLU(d, intermediate_size) if i < first_k_dense_replace else
                       MoE(i, d, moe_intermediate_size, n_routed_experts, experts_held, 0,
                           n_shared_experts, num_experts_per_tok, routed_scaling_factor))
                layers.append(DecoderLayer(d, rms_norm_eps, attn, mlp))
            self.layers = nn.ModuleList(layers)
            self.norm = RMSNorm(d, rms_norm_eps)
            self.classifier = nn.Linear(d, K)
        head = (self.connector, self.embed, self.layers, self.norm, self.classifier)
        for m in head:
            m.to_empty(device=device)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        self._init_head(head, torch.Generator(device=device).manual_seed(seed))

    @staticmethod
    @torch.no_grad()
    def _init_head(modules, g: torch.Generator) -> None:
        """Torch's default initializations (U(+-1/sqrt(fan_in)) products,
        N(0, 1) embedding, unit norms), a zero selection bias, drawn from
        ``g`` on the parameters' device."""
        for root in modules:
            for m in root.modules():
                if isinstance(m, (RMSNorm, nn.LayerNorm)):
                    m.weight.fill_(1.0)
                    if getattr(m, "bias", None) is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.Embedding):
                    m.weight.normal_(0.0, 1.0, generator=g)
                    m.weight[m.padding_idx].zero_()
                elif isinstance(m, nn.Linear):
                    bound = 1.0 / math.sqrt(m.in_features)
                    m.weight.uniform_(-bound, bound, generator=g)
                    if m.bias is not None:
                        m.bias.uniform_(-bound, bound, generator=g)
                elif isinstance(m, Router):
                    m.weight.uniform_(-1.0 / math.sqrt(m.weight.shape[1]),
                                      1.0 / math.sqrt(m.weight.shape[1]), generator=g)
                    m.e_score_correction_bias.zero_()
                elif isinstance(m, Experts):
                    for w in (m.gate_up, m.down):
                        bound = 1.0 / math.sqrt(w.shape[2])
                        w.uniform_(-bound, bound, generator=g)
                elif isinstance(m, MoE):
                    m.load.zero_()

    @property
    def vgg(self) -> VGGFeatures:
        return self.image_encoder.vgg11_encoder

    def moe_layers(self) -> list[MoE]:
        return [layer.mlp for layer in self.layers if isinstance(layer.mlp, MoE)]

    def frozen_features(self, x_img: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(x_img)

    def cache_features(self, x_img: torch.Tensor) -> torch.Tensor:
        """The image encoder's [B, 196, 512]: all of the frozen tower (the
        attention model's cache boundary)."""
        return self.frozen_features(x_img)

    def features_from_cache(self, cached: torch.Tensor) -> torch.Tensor:
        return cached.to(self.dtype)

    def tower(self, x_img: torch.Tensor, batch_stats: bool) -> torch.Tensor:
        x = self.vgg.train_forward(x_img, batch_stats=batch_stats, remat=self.remat)
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)

    def head(self, feats, x_ques, x_ques_lens):
        b, s = feats.shape[:2]
        t = s + x_ques.shape[1]
        dev = feats.device
        cos, sin = rope_tables(t, self.rope_dim, self.rope_theta, dev)
        valid = torch.arange(t, device=dev)[None, :] < (s + x_ques_lens)[:, None]
        with self._autocast(dev):
            x = torch.cat([self.connector(feats).float(), self.embed(x_ques).float()], 1)
            for layer in self.layers:
                x = layer(x, cos, sin, valid, self.dtype)
            last = x[torch.arange(b, device=dev), s + x_ques_lens - 1]
            return self.classifier(self.norm(last))

    def balance_loss(self) -> torch.Tensor | None:
        """The balance loss of the last forward, summed over the expert layers."""
        terms = [m.aux for m in self.moe_layers() if m.aux is not None]
        return torch.stack(terms).sum() if terms else None

    def update_router_bias(self) -> None:
        """Each expert layer's selection-bias step from the loads of the
        forwards since the last one (training forwards only)."""
        for m in self.moe_layers():
            m.update_bias()
