"""Plain float32 forward of the dense decoder family (Phi-4-mini's block):
RMS norm, grouped-query attention with partial rotary embeddings, a
SwiGLU MLP, a tied or separate vocabulary head.

Written from the published block (arXiv:2412.08905, §2: a decoder-only
transformer, GQA with 24 query and 8 KV heads, RoPE on a fraction 0.75 of
each head, SwiGLU, tied input and output embeddings). Departures, the
serving program's as well: no LongRoPE rescaling of the rotary
frequencies (plain RoPE at ``rope_theta``), no biases. One sequence at a
time, the attention one KV head's group at a time, so that the float32
scores of a 4,160-token sequence stay under 0.3 GB.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.common import PLAIN, Leaf, rms

__all__ = ["layout", "logits", "matmul_params", "token_flops"]


def layout(m: dict) -> list[Leaf]:
    """The program's parameter tree (layers stacked on a leading axis).
    Projections N(0, 1/fan_in) over their true input width, embedding and
    head N(0, 0.02²), norm gains U(0.5, 1.5)."""
    L, D, F = m["num_layers"], m["d_model"], m["d_ff"]
    H, KV, hd, V = (m["num_heads"], m["num_kv_heads"], m["head_dim"],
                    m["vocab_size"])
    gain = ("uniform", 0.5, 1.5)
    leaves = [
        Leaf(("embed", "table"), (V, D), "normal", 0.02),
        Leaf(("final_norm",), (D,), *gain),
        Leaf(("layers", "norm1"), (L, D), *gain),
        Leaf(("layers", "norm2"), (L, D), *gain),
        Leaf(("layers", "attn", "wq"), (L, D, H, hd), "normal", D ** -0.5),
        Leaf(("layers", "attn", "wk"), (L, D, KV, hd), "normal", D ** -0.5),
        Leaf(("layers", "attn", "wv"), (L, D, KV, hd), "normal", D ** -0.5),
        Leaf(("layers", "attn", "wo"), (L, H, hd, D), "normal",
             (H * hd) ** -0.5),
        Leaf(("layers", "mlp", "wg"), (L, D, F), "normal", D ** -0.5),
        Leaf(("layers", "mlp", "wu"), (L, D, F), "normal", D ** -0.5),
        Leaf(("layers", "mlp", "wd"), (L, F, D), "normal", F ** -0.5),
    ]
    if not m["tie_embeddings"]:
        leaves.append(Leaf(("embed", "head"), (V, D), "normal", 0.02))
    return leaves


def matmul_params(m: dict) -> int:
    """Weights a token multiplies in the layers (embedding and head out)."""
    L, D, F = m["num_layers"], m["d_model"], m["d_ff"]
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    return L * (2 * D * H * hd + 2 * D * KV * hd + 3 * D * F)


def token_flops(m: dict, ctx):
    """FLOPs one token needs at context ``ctx`` (the keys it attends to,
    its own included; a number or an array), the head left out: 2 per
    weight it multiplies, and QKᵀ and PV over its keys in every layer."""
    return (2.0 * matmul_params(m)
            + m["num_layers"] * 4.0 * m["head_dim"] * m["num_heads"] * ctx)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, rot: int):
    """Rotate the first ``rot`` channels of x (S, heads, hd) as two halves."""
    half = rot // 2
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, x[..., rot:]],
                     dim=-1)


def logits(params: dict, m: dict, tokens: torch.Tensor, start: int,
           prec=PLAIN) -> torch.Tensor:
    """Float32 logits (len(tokens) - start, V) of the sequence ``tokens``
    (S,) at positions ``start`` .. S - 1; ``prec`` reads the operands of
    the weight products (``common.Precision``)."""
    W, X = prec.w, prec.x
    L, H, KV, hd = (m["num_layers"], m["num_heads"], m["num_kv_heads"],
                    m["head_dim"])
    eps, G = m["norm_eps"], H // KV
    S = tokens.shape[0]
    dev = tokens.device
    lay = params["layers"]
    x = params["embed"]["table"][tokens].float()
    rot = int(hd * m["rope_fraction"])
    rot -= rot % 2
    half = rot // 2
    freqs = m["rope_theta"] ** (-torch.arange(half, dtype=torch.float64,
                                              device=dev) / half)
    ang = torch.arange(S, dtype=torch.float64, device=dev)[:, None] * freqs
    cos, sin = (f(ang).float()[:, None] for f in (torch.cos, torch.sin))
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    for i in range(L):
        a = lay["attn"]
        h = rms(x, lay["norm1"][i].float(), eps)
        hx = X(h)
        q = torch.einsum("sd,dhk->shk", hx, W(a["wq"][i]))
        k = torch.einsum("sd,dhk->shk", hx, W(a["wk"][i]))
        v = torch.einsum("sd,dhk->shk", hx, W(a["wv"][i]))
        q, k = _rope(q, cos, sin, rot), _rope(k, cos, sin, rot)
        out = torch.empty_like(q)
        for j in range(KV):  # the query heads j*G .. j*G+G-1 read KV head j
            qs = q[:, j * G:(j + 1) * G]
            s = torch.einsum("sgd,td->gst", qs, k[:, j]) / math.sqrt(hd)
            p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            out[:, j * G:(j + 1) * G] = torch.einsum("gst,td->sgd", p,
                                                      v[:, j])
        x = x + torch.einsum("shk,hkd->sd", X(out.reshape(S, -1)).reshape(
            out.shape), W(a["wo"][i]))
        h2 = rms(x, lay["norm2"][i].float(), eps)
        mlp = lay["mlp"]
        h2 = X(h2)
        g = torch.nn.functional.silu(h2 @ W(mlp["wg"][i]))
        x = x + X(g * (h2 @ W(mlp["wu"][i]))) @ W(mlp["wd"][i])
    x = rms(x[start:], params["final_norm"].float(), eps)
    head = params["embed"].get("head", params["embed"]["table"])
    return X(x) @ W(head).T
