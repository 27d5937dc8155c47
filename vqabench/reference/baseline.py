"""The VQA baseline (VGG-11-bn x GRU, Antol et al., arXiv 1505.00468) as the
reference repository implements it, in plain PyTorch.

Image: the tower's [B, S/32, S/32, 512], adaptive average pool to 7x7,
flattened in (C, H, W) order, then the frozen VGG classifier without its
last layer (25,088 -> 4,096, ReLU, dropout, 4,096 -> 4,096, ReLU, dropout);
an L2 normalize (floor 1e-12), FC-1024 and tanh. Question: embedding (300,
pads not masked), tanh, a GRU (1,024) whose hidden state at each
sequence's last valid step is kept (zero for an empty one), FC-1024 and
tanh. Fusion: the element-wise product, FC-1000, dropout, tanh, FC-K.

Dropout keeps each value with probability 1/2 and doubles it; its masks
are given by the caller (none in eval mode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import F32, Precision

TOWER_PREFIX = "image_encoder.vgg11_encoder.conv_layers."
DROPOUT = 0.5
BIAS = 0.05
# the trained weight that takes the tower's output first
TOWER_CONSUMER = "image_encoder.embedding_layer.0.weight"
# the trained weight that gives the logits
OUTPUT = "fc_final.weight"


def trainable(key: str) -> bool:
    """Everything but the frozen VGG and its classifier trains."""
    return not key.startswith("image_encoder.vgg11_encoder.")


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """The state-dict entries besides the tower: (key, shape, init, scale).

    Scaled so that both the image and the question move the logits: the
    VGG classifier as torchvision draws it (N(0, 0.01)); word vectors
    N(0, 1); the other weights variance-preserving, U(+-sqrt(3 / fan_in)),
    but the image embedding at 64 times that (its input has unit norm, so
    its pre-activations come out N(0, 1)) and fc_final at 4 times (logits
    spread about 0.7); biases U(+-0.05), the classifier's U(+-0.01)."""
    v, e, h, k = cfg["vocab_size"], cfg["word_emb_dim"], cfg["hidden_dim"], cfg["num_classes"]
    fc = "image_encoder.vgg11_encoder.fc_layers."
    out = [(fc + "1.weight", (4096, 512 * 7 * 7), "normal", 0.01),
           (fc + "1.bias", (4096,), "uniform", 0.01),
           (fc + "4.weight", (4096, 4096), "normal", 0.01),
           (fc + "4.bias", (4096,), "uniform", 0.01),
           ("question_encoder.word_embedding.0.weight", (v, e), "normal", 1.0)]
    g = "question_encoder.gru."
    out += [(g + "weight_ih_l0", (3 * h, e), "uniform", (3.0 / e) ** 0.5),
            (g + "weight_hh_l0", (3 * h, h), "uniform", (3.0 / h) ** 0.5),
            (g + "bias_ih_l0", (3 * h,), "uniform", BIAS),
            (g + "bias_hh_l0", (3 * h,), "uniform", BIAS)]
    for name, o, i, gain in (("image_encoder.embedding_layer.0", 1024, 4096, 64.0),
                             ("question_encoder.embedding_layer.0", 1024, h, 1.0),
                             ("mlp.0", 1000, 1024, 1.0), ("fc_final", k, 1000, 4.0)):
        out += [(f"{name}.weight", (o, i), "uniform", gain * (3.0 / i) ** 0.5),
                (f"{name}.bias", (o,), "uniform", BIAS)]
    return out


def head_flops(cfg: dict, batch: int) -> tuple[float, float]:
    """(frozen, trained) forward operations of the matrix products after the
    conv stack, at the full question length: the frozen VGG classifier, and
    the image embedding, the GRU and the MLP that train."""
    b, seq = batch, cfg["max_seq_length"]
    e, h, k = cfg["word_emb_dim"], cfg["hidden_dim"], cfg["num_classes"]
    classifier = 2.0 * b * (512 * 7 * 7 * 4096 + 4096 * 4096)
    trained = 2.0 * b * (4096 * 1024 + seq * (3 * h * e + 3 * h * h) + h * 1024
                         + 1024 * 1000 + 1000 * k)
    return classifier, trained


def dropout_shapes(cfg: dict, batch: int) -> list[tuple]:
    """The dropout masks a training forward draws, in order."""
    return [(batch, 4096), (batch, 4096), (batch, 1000)]


def _drop(x: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask, x / (1.0 - DROPOUT), torch.zeros_like(x))


def gru_last(w: dict, x: torch.Tensor, lens: torch.Tensor, p: Precision) -> torch.Tensor:
    """GRU (gates r, z, n) over [B, L, E] -> the hidden state after step ``len - 1``."""
    g = "question_encoder.gru."
    b, seq, _ = x.shape
    hdim = w[g + "weight_hh_l0"].shape[1]
    gi = p.linear(x, w[g + "weight_ih_l0"], w[g + "bias_ih_l0"])        # [B, L, 3H]
    h = x.new_zeros((b, hdim))
    last = x.new_zeros((b, hdim))
    for t in range(seq):
        gh = p.linear(h, w[g + "weight_hh_l0"], w[g + "bias_hh_l0"])
        i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1 - z) * n + z * h
        last = torch.where((lens == t + 1)[:, None], h, last)
    return last


def logits(w: dict, tower_out: torch.Tensor, ids: torch.Tensor, lens: torch.Tensor,
           p: Precision = F32, masks=(None, None, None)) -> torch.Tensor:
    fc = "image_encoder.vgg11_encoder.fc_layers."
    x = F.adaptive_avg_pool2d(tower_out.permute(0, 3, 1, 2), (7, 7)).flatten(1)
    x = _drop(torch.relu(p.linear(x, w[fc + "1.weight"], w[fc + "1.bias"])), masks[0])
    x = _drop(torch.relu(p.linear(x, w[fc + "4.weight"], w[fc + "4.bias"])), masks[1])
    x = x / torch.clamp_min(x.norm(dim=-1, keepdim=True), 1e-12)
    img = torch.tanh(p.linear(x, w["image_encoder.embedding_layer.0.weight"],
                              w["image_encoder.embedding_layer.0.bias"]))
    q = torch.tanh(w["question_encoder.word_embedding.0.weight"][ids])
    q = torch.tanh(p.linear(gru_last(w, q, lens, p), w["question_encoder.embedding_layer.0.weight"],
                            w["question_encoder.embedding_layer.0.bias"]))
    x = _drop(p.linear(img * q, w["mlp.0.weight"], w["mlp.0.bias"]), masks[2])
    return p.linear(torch.tanh(x), w["fc_final.weight"], w["fc_final.bias"])
