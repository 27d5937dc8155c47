"""Hierarchical co-attention (Lu et al. 2016, arXiv 1606.00061) as the
reference repository implements it, in plain PyTorch.

Shapes: image features V [B, 196, 512] from the 448x448 tower (position
s = 14 h + w), question ids [B, L] (0 pads) and lengths [B]. The three
quirks of the reference's ``model.py`` are kept:

1. the phrase max-pool groups adjacent channels of the concatenated
   uni/bi/tri-gram outputs (channel e = max of concat[3e : 3e + 3]);
2. ``co_attention.W_b`` exists and is never applied;
3. the question softmax has no padding mask.

Word embeddings are zero at pads; phrase features are zeroed past each
length; the sentence LSTM freezes its state past each length and outputs
zero there (what packing gives).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import F32, Precision

TOWER_PREFIX = "image_encoder.vgg11_encoder."
BIAS = 0.05
# the trained weight that takes the tower's output first
TOWER_CONSUMER = "co_attention.W_v.weight"
# the trained weight that gives the logits
OUTPUT = "mlp_classify.W_h.weight"


def trainable(key: str) -> bool:
    """Everything but the frozen VGG trains."""
    return not key.startswith("image_encoder.")


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """The state-dict entries besides the tower: (key, shape, init, scale);
    init "normal" (std = scale), "uniform" (+-scale) or "zeros".

    Scaled so that the head is neither saturated nor flat: word vectors
    N(0, 0.1), weights variance-preserving, U(+-sqrt(3 / fan_in)), but W_v
    at 0.3 of that (its output is summed over 196 positions) and W_h at 4
    times (logits spread about 0.7), biases U(+-0.05)."""
    v, e, h, m, k = (cfg["vocab_size"], cfg["word_emb_dim"], cfg["hidden_dim"],
                     cfg["mlp_dim"], cfg["num_classes"])

    def lin(name, o, i, taps=None, gain=1.0):
        shape = (o, i) if taps is None else (o, i, taps)
        return [(f"{name}.weight", shape, "uniform", gain * (3.0 / (i * (taps or 1))) ** 0.5),
                (f"{name}.bias", (o,), "uniform", BIAS)]
    out = [("question_encoder.word_embedding.weight", (v, e), "normal", 0.1)]
    for name, taps in (("unigram", 1), ("bigram", 2), ("trigram", 3)):
        out += lin(f"question_encoder.phrase_conv_pool.conv_{name}.1", e, e, taps)
    p = "question_encoder.sentence_lstm."
    out += [(p + "weight_ih_l0", (4 * h, e), "uniform", (3.0 / e) ** 0.5),
            (p + "weight_hh_l0", (4 * h, h), "uniform", (3.0 / h) ** 0.5),
            (p + "bias_ih_l0", (4 * h,), "uniform", BIAS),
            (p + "bias_hh_l0", (4 * h,), "uniform", BIAS)]
    out += [("co_attention.W_b.weight", (h, h), "zeros", 0.0),
            ("co_attention.W_b.bias", (h,), "zeros", 0.0)]
    for name, o, i, gain in (("co_attention.W_v", h, h, 0.3), ("co_attention.W_q", h, h, 1.0),
                             ("co_attention.w_v", 1, h, 1.0), ("co_attention.w_q", 1, h, 1.0),
                             ("mlp_classify.W_w", h, h, 1.0), ("mlp_classify.W_p", h, 2 * h, 1.0),
                             ("mlp_classify.W_s", m, 2 * h, 1.0), ("mlp_classify.W_h", k, m, 4.0)):
        out += lin(name, o, i, gain=gain)
    return out


def lstm(w: dict, x: torch.Tensor, lens: torch.Tensor, p: Precision) -> torch.Tensor:
    pre = "question_encoder.sentence_lstm."
    b, seq, _ = x.shape
    hdim = w[pre + "weight_hh_l0"].shape[1]
    x_proj = p.linear(x, w[pre + "weight_ih_l0"], w[pre + "bias_ih_l0"])
    h = x.new_zeros((b, hdim))
    c = x.new_zeros((b, hdim))
    valid = (torch.arange(seq, device=x.device)[None, :] < lens[:, None]).float()
    outs = []
    for t in range(seq):
        gates = x_proj[:, t] + p.linear(h, w[pre + "weight_hh_l0"], w[pre + "bias_hh_l0"])
        g_i, g_f, g_g, g_o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(g_f) * c + torch.sigmoid(g_i) * torch.tanh(g_g)
        h_new = torch.sigmoid(g_o) * torch.tanh(c_new)
        v = valid[:, t:t + 1]
        h = v * h_new + (1 - v) * h
        c = v * c_new + (1 - v) * c
        outs.append(v * h_new)
    return torch.stack(outs, dim=1)


def question(w: dict, ids: torch.Tensor, lens: torch.Tensor, p: Precision):
    """(word, phrase, sentence) features, each [B, L, H]."""
    seq = ids.shape[1]
    word = w["question_encoder.word_embedding.weight"][ids] * (ids != 0)[..., None].float()
    xc = word.transpose(1, 2)                                        # [B, E, L]
    grams = []
    for name, pad in (("unigram", (0, 0)), ("bigram", (1, 0)), ("trigram", (1, 1))):
        pre = f"question_encoder.phrase_conv_pool.conv_{name}.1."
        grams.append(torch.tanh(p.conv1d(F.pad(xc, pad), w[pre + "weight"], w[pre + "bias"])))
    cat = torch.cat(grams, dim=1)                                    # [B, 3E, L]
    b, e3, _ = cat.shape
    phrase = cat.transpose(1, 2).reshape(b, seq, e3 // 3, 3).amax(dim=-1)   # quirk 1
    valid = (torch.arange(seq, device=ids.device)[None, :] < lens[:, None]).float()
    phrase = phrase * valid[..., None]
    return word, phrase, lstm(w, phrase, lens, p)


def co_attention(w: dict, V: torch.Tensor, levels, p: Precision):
    """Pooled (image, question) vectors of each level; W_b is not applied (quirk 2)."""
    wv = p.linear(V, w["co_attention.W_v.weight"], w["co_attention.W_v.bias"])
    imgs, ques = [], []
    for Q in levels:
        C = torch.tanh(p.matmul(Q, V.transpose(1, 2)))              # [B, L, S]
        wq = p.linear(Q, w["co_attention.W_q.weight"], w["co_attention.W_q.bias"])
        h_v = torch.tanh(wv + p.matmul(C.transpose(1, 2), wq))
        h_q = torch.tanh(wq + p.matmul(C, wv))
        a_v = torch.softmax(p.linear(h_v, w["co_attention.w_v.weight"],
                                     w["co_attention.w_v.bias"]), dim=1)
        a_q = torch.softmax(p.linear(h_q, w["co_attention.w_q.weight"],
                                     w["co_attention.w_q.bias"]), dim=1)    # quirk 3
        imgs.append((a_v * V).sum(dim=1))
        ques.append((a_q * Q).sum(dim=1))
    return imgs, ques


def logits(w: dict, tower_out: torch.Tensor, ids: torch.Tensor, lens: torch.Tensor,
           p: Precision = F32, masks=()) -> torch.Tensor:
    """[B, K] from the tower's [B, 14, 14, 512] (``masks``: the model has no dropout)."""
    b, h, wd, c = tower_out.shape
    V = tower_out.reshape(b, h * wd, c)
    levels = question(w, ids, lens, p)
    (v_w, v_p, v_s), (q_w, q_p, q_s) = co_attention(w, V, levels, p)

    def lin(name, x):
        return p.linear(x, w[f"mlp_classify.{name}.weight"], w[f"mlp_classify.{name}.bias"])
    h_w = torch.tanh(lin("W_w", q_w + v_w))
    h_p = torch.tanh(lin("W_p", torch.cat([q_p + v_p, h_w], dim=1)))
    h_s = torch.tanh(lin("W_s", torch.cat([q_s + v_s, h_p], dim=1)))
    return lin("W_h", h_s)


def head_flops(cfg: dict, batch: int) -> tuple[float, float]:
    """(frozen, trained) forward operations of the matrix products after the
    tower, at the full question length: nothing frozen; the phrase convs,
    the LSTM, the co-attention's three levels and the MLP train."""
    b, seq = batch, cfg["max_seq_length"]
    e, h, k = cfg["word_emb_dim"], cfg["hidden_dim"], cfg["num_classes"]
    s = (cfg["image_size"] // 32) ** 2
    m = cfg["mlp_dim"]
    phrase = 2.0 * b * seq * e * e * (1 + 2 + 3)
    lstm_ = 2.0 * b * seq * (e * 4 * h + h * 4 * h)
    level = 2.0 * b * (seq * s * h + seq * h * h + s * seq * h + seq * s * h
                       + s * h + seq * h + s * h + seq * h)
    coatt = 2.0 * b * s * h * h + 3 * level
    mlp = 2.0 * b * (h * h + 2 * h * h + 2 * h * m + m * k)
    return 0.0, phrase + lstm_ + coatt + mlp


def dropout_shapes(cfg: dict, batch: int) -> list[tuple]:
    """The dropout masks a training forward draws, in order: none."""
    return []
