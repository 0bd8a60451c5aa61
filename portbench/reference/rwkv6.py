"""Plain float32 forward of RWKV-6 "Finch" (arXiv:2404.05892, §4):
token shift by data-dependent linear interpolation (ddlerp) with its
low-rank mixes, data-dependent per-channel decay, the wkv recurrence with
its bonus ``u``, a per-head normalisation of the wkv output, the SiLU
gate, and the squared-ReLU channel mix.

    out_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t   = diag(w_t) S_{t-1} + k_tᵀ v_t,     w_t = exp(-exp(w0 + lora(x_t)))

Departures, the serving program's as well: RMS norms for the LayerNorms,
an RMS norm of each head's wkv output (eps 64e-5) for the GroupNorm. The
recurrence runs in chunks of 64 positions (:func:`wkv`): within a chunk
every pair (t, s < t) is weighed by the decay between them, written as
the exponential of a difference of the chunk's running log decays that is
never positive, so nothing overflows; the state is carried from chunk to
chunk. One sequence at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import PLAIN, Leaf, rms

__all__ = ["layout", "logits", "wkv", "matmul_params", "token_flops"]

N_MIX = 5  # the ddlerp mixes, in the order w, k, v, r, g
CHUNK = 64


def layout(m: dict) -> list[Leaf]:
    """The program's parameter tree (layers stacked on a leading axis).
    Projections N(0, 1/fan_in), the low-rank mixes N(0, 0.01²), embedding
    and head N(0, 0.02²), gains U(0.5, 1.5), interpolation weights U(0, 1),
    the decay base ``w0`` U(-6, -1) (per-step decays 0.69 to 0.9975, the
    range of Finch's initialisation) and the bonus ``u`` U(-1, 1)."""
    L, D, F_, V = m["num_layers"], m["d_model"], m["d_ff"], m["vocab_size"]
    H, K = m["num_heads"], m["head_dim"]
    R, Rd = m["rwkv_lora_dim"], m["rwkv_decay_lora_dim"]
    gain, mix = ("uniform", 0.5, 1.5), ("uniform", 0.0, 1.0)

    def proj(name, din, dout):
        return Leaf(("layers", name), (L, din, dout), "normal", din ** -0.5)

    return [
        Leaf(("embed", "table"), (V, D), "normal", 0.02),
        Leaf(("embed", "head"), (V, D), "normal", 0.02),
        Leaf(("final_norm",), (D,), *gain),
        Leaf(("layers", "norm_tm"), (L, D), *gain),
        Leaf(("layers", "norm_cm"), (L, D), *gain),
        Leaf(("layers", "ln_x"), (L, D), *gain),
        Leaf(("layers", "mu_x"), (L, D), *mix),
        Leaf(("layers", "mu5"), (L, N_MIX, D), *mix),
        Leaf(("layers", "mu_k"), (L, D), *mix),
        Leaf(("layers", "mu_r"), (L, D), *mix),
        Leaf(("layers", "tm_w1"), (L, D, N_MIX * R), "normal", 0.01),
        Leaf(("layers", "tm_w2"), (L, N_MIX, R, D), "normal", 0.01),
        Leaf(("layers", "w0"), (L, D), "uniform", -6.0, -1.0),
        Leaf(("layers", "td_w1"), (L, D, Rd), "normal", 0.01),
        Leaf(("layers", "td_w2"), (L, Rd, D), "normal", 0.01),
        Leaf(("layers", "u"), (L, H, K), "uniform", -1.0, 1.0),
        proj("wr", D, D), proj("wk", D, D), proj("wv", D, D),
        proj("wg", D, D), proj("wo", D, D),
        proj("cm_k", D, F_), proj("cm_v", F_, D), proj("cm_r", D, D),
    ]


def wkv(r, k, v, logw, u):
    """The recurrence from a zero state. r, k, v, logw: (S, H, K) float32,
    logw ≤ 0 the log of each position's per-channel decay; u: (H, K).
    Returns out (S, H, K)."""
    S, H, K = r.shape
    state = r.new_zeros(H, K, K)
    outs = []
    for c0 in range(0, S, CHUNK):
        rc, kc, vc, lw = (t[c0:c0 + CHUNK] for t in (r, k, v, logw))
        T = rc.shape[0]
        A = torch.cumsum(lw, dim=0)  # decay through position t
        Ap = A - lw  # ... through t - 1
        out = torch.einsum("thj,hjv->thv", rc * torch.exp(Ap), state)
        before = torch.ones(T, T, dtype=torch.bool, device=r.device).tril(-1)
        d = (Ap[:, None] - A[None, :]).masked_fill(
            ~before[:, :, None, None], float("-inf"))  # (t, s, H, K), ≤ 0
        a = torch.einsum("thj,tshj,shj->hts", rc, torch.exp(d), kc)
        out = out + torch.einsum("hts,shv->thv", a, vc)
        out = out + (rc * u * kc).sum(-1, keepdim=True) * vc
        state = (torch.exp(A[-1])[:, :, None] * state
                 + torch.einsum("shj,shv->hjv", torch.exp(A[-1] - A) * kc,
                                vc))
        outs.append(out)
    return torch.cat(outs)


def matmul_params(m: dict) -> int:
    """Weights a token multiplies in the layers (embedding and head out):
    the time mix's five projections and output, the channel mix's three,
    the ddlerp and decay low-rank pairs."""
    L, D, F = m["num_layers"], m["d_model"], m["d_ff"]
    R, Rd = m["rwkv_lora_dim"], m["rwkv_decay_lora_dim"]
    return L * (6 * D * D + 2 * D * F + 2 * 5 * R * D + 2 * D * Rd)


def token_flops(m: dict, ctx):
    """FLOPs one token needs (the head left out): 2 per weight it
    multiplies and the wkv state update of every head (5 K² + 6 K, as
    ``harness.work.wkv_work`` counts it); the same at any context."""
    K = m["head_dim"]
    return (2.0 * matmul_params(m)
            + m["num_layers"] * m["num_heads"] * (5.0 * K * K + 6.0 * K)
            + 0 * ctx)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1}, zeros before the first position."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def logits(params: dict, m: dict, tokens: torch.Tensor, start: int,
           prec=PLAIN) -> torch.Tensor:
    """Float32 logits (len(tokens) - start, V) of the sequence ``tokens``
    (S,) at positions ``start`` .. S - 1; ``prec`` reads the operands of
    the weight products (``common.Precision``)."""
    W, X = prec.w, prec.x

    def mm(a, name):
        return X(a) @ W(p[name])

    L, H, K = m["num_layers"], m["num_heads"], m["head_dim"]
    eps = m["norm_eps"]
    S = tokens.shape[0]
    lay = params["layers"]
    x = params["embed"]["table"][tokens].float()
    for i in range(L):
        p = {name: leaf[i] for name, leaf in lay.items()}
        vec = {n: p[n].float() for n in ("norm_tm", "norm_cm", "ln_x", "mu_x",
                                          "mu5", "mu_k", "mu_r", "w0", "u")}
        h = rms(x, vec["norm_tm"], eps)
        xx = _shift(h) - h
        lora = torch.tanh(mm(h + xx * vec["mu_x"], "tm_w1"))
        deltas = torch.einsum("smr,mrd->smd", X(lora).reshape(S, N_MIX, -1),
                              W(p["tm_w2"]))
        xw, xk, xv, xr, xg = (h[:, None] + xx[:, None] * (vec["mu5"] + deltas)
                              ).unbind(1)
        r, k, v = (mm(xi, n).reshape(S, H, K)
                   for xi, n in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
        g = F.silu(mm(xg, "wg"))
        ww = vec["w0"] + mm(mm(xw, "td_w1"), "td_w2")
        logw = -torch.exp(ww.clamp(-20.0, 20.0)).reshape(S, H, K)
        y = wkv(r, k, v, logw, vec["u"])
        y = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True)
                            + m["head_norm_eps"])
        x = x + mm(y.reshape(S, H * K) * vec["ln_x"] * g, "wo")
        h2 = rms(x, vec["norm_cm"], eps)
        xx = _shift(h2) - h2
        kk = torch.relu(mm(h2 + xx * vec["mu_k"], "cm_k")).square()
        rr = torch.sigmoid(mm(h2 + xx * vec["mu_r"], "cm_r"))
        x = x + rr * mm(kk, "cm_v")
    x = rms(x[start:], params["final_norm"].float(), eps)
    return X(x) @ W(params["embed"]["head"]).T
