"""Shared transformer building blocks, a copy of ``repro.models.layers``.

Everything is functional: ``*_defs(cfg)`` returns a ParamDef tree, the
corresponding ``*_apply`` consumes the materialized subtree. Attention is
computed in the reference's blocked, online-softmax form (float32, the
reference's chunk order) in plain PyTorch, so a long prefill never
materializes an S×S score matrix; a Hopper attention kernel is later
speed work. The dense family's whole path is here: RMS norm (with gemma's
``1 + w``), partial RoPE, blocked attention (MHA, and GQA/MQA on the
grouped path), the decode step's attention against a bf16 or int8 KV
cache written in place, the four MLPs, the embedding (tied table,
``sqrt(d_model)`` scale), the head and the chunked cross-entropy; and the
vlm and audio families' cross-attention (non-causal, no RoPE, over a fixed
K/V set, scaled by ``tanh(gate)`` where the block has a gate).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shd
from repro_torch.models.params import UNWRITTEN, ParamDef

__all__ = [
    "NEG_INF",
    "f32",
    "rms_norm",
    "apply_rope",
    "blocked_attention",
    "attn_defs",
    "attn_project_q",
    "attn_project_kv",
    "attn_out",
    "self_attention",
    "cross_attention",
    "quantize_kv",
    "decode_self_attention",
    "write_kv_pos",
    "mlp_defs",
    "mlp_apply",
    "embed_defs",
    "embed_apply",
    "logits_apply",
    "softmax_xent_chunked",
]

NEG_INF = -1.0e30


# --------------------------------------------------------------------------
# norms / rope
# --------------------------------------------------------------------------
def f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` at one of the model's float32 points: float32, except that a
    float64 tensor stays float64 (a float64 run is the arbiter of float32
    rounding, ``tools/train_cpu_gap.py``)."""
    return t if t.dtype == torch.float64 else t.float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = f32(x)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    w = f32(w)
    if plus_one:
        w = w + 1.0
    return (x * w).to(dt)


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: (B, S, H, D); positions: broadcastable to (B, S). The first
    ``int(D * fraction)`` (made even) channels rotate, in float32."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = torch.as_tensor(positions, device=x.device).float()
    angles = pos[..., None] * freqs  # (B?, S, half)
    while angles.dim() < x.dim():  # -> (B, S, 1, half)
        angles = angles.unsqueeze(0 if angles.dim() < 2 else -2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., :half].float()
    x2 = x[..., half:rot].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


# --------------------------------------------------------------------------
# blocked (flash-style) attention
# --------------------------------------------------------------------------
def blocked_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                      window: int = 0, chunk: int = 1024):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D); q_pos: (B, Sq); kv_pos: (B, Skv).
    Never materializes (Sq, Skv); peak extra memory is O(Sq · chunk). The
    chunks are visited in order with the reference's running max, sum and
    accumulator in float32; a key count that is not a multiple of the
    chunk is padded with keys at position ``UNWRITTEN`` (masked out).
    With ``H > KV`` (GQA, MQA) the queries are grouped as (KV, G) and the
    keys are not broadcast: the reference's path on one device. Under a
    mesh whose ``model`` axis divides H, the keys are broadcast to all H
    heads so that the heads can be sharded over it (the reference's
    ``expand_kv``).
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D**-0.5
    mesh = shd.current_mesh()
    tp = shd.axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    expand_kv = G > 1 and tp > 1 and H % tp == 0
    chunk = min(chunk, Skv)
    if Skv % chunk:  # pad KV to a chunk multiple with masked-out slots
        pad = chunk - Skv % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=UNWRITTEN)
        Skv += pad
    n_chunks = Skv // chunk

    q32 = q.float()
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        kj, vj, pj = k[:, sl].float(), v[:, sl].float(), kv_pos[:, sl]
        if expand_kv:  # broadcast grouped KV to all H heads
            kj = kj.repeat_interleave(G, dim=2)
            vj = vj.repeat_interleave(G, dim=2)
            kj = shd.constrain(kj, "batch", "", "heads", "")
        if expand_kv or G == 1:
            s = torch.einsum("bqhd,bchd->bhqc", q32, kj) * scale
            s = shd.constrain(s, "batch", "heads", "seq", "")
        else:  # grouped path: no KV broadcast
            qg = q32.reshape(B, Sq, KV, G, D)
            s = torch.einsum("bqkgd,bckd->bkgqc", qg, kj) * scale
            s = s.reshape(B, H, Sq, -1)
        if causal:
            valid = pj[:, None, :] <= q_pos[:, :, None]
        else:
            valid = (pj[:, None, :] < UNWRITTEN).expand(B, Sq, chunk)
        if window:
            valid = valid & (q_pos[:, :, None] - pj[:, None, :] < window)
        valid = valid[:, None]  # (B,1,Sq,c)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        if expand_kv or G == 1:
            pv = torch.einsum("bhqc,bchd->bqhd", p, vj)
        else:
            pg = p.reshape(B, KV, G, Sq, -1)
            pv = torch.einsum("bkgqc,bckd->bqkgd", pg, vj).reshape(
                B, Sq, H, D)
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    denom = torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return (acc / denom).reshape(B, Sq, H, D).to(q.dtype)


# --------------------------------------------------------------------------
# attention block
# --------------------------------------------------------------------------
def attn_defs(cfg, *, cross: bool = False) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d = {
        "wq": ParamDef((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((D, KV, hd), ("embed", "heads", "head_dim")),
        "wv": ParamDef((D, KV, hd), ("embed", "heads", "head_dim")),
        "wo": ParamDef((H, hd, D), ("heads", "head_dim", "embed")),
    }
    if cross:  # a float32 scalar; tanh(0) = 0 shuts the block at init
        d["gate"] = ParamDef((), (), init="zeros", dtype=torch.float32)
    return d


def attn_project_q(p, cfg, x, positions, *, rope: bool = True):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    # TP over heads when divisible; context-parallel fallback over seq otherwise
    if q.shape[1] > 1:
        q = shd.constrain(q, "batch", "seq", "heads", "head_dim")
    return q


def attn_project_kv(p, cfg, x, positions, *, rope: bool = True):
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if rope:
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return k, v


def attn_out(p, cfg, ctx):
    out = torch.einsum("bshk,hkd->bsd", ctx, p["wo"].to(ctx.dtype))
    return shd.constrain(out, "batch", "seq", "embed")


def self_attention(p, cfg, x, positions, *, window: int = 0):
    """Full-sequence self attention (train / prefill). Returns (out, (k, v))."""
    q = attn_project_q(p, cfg, x, positions)
    k, v = attn_project_kv(p, cfg, x, positions)
    pos = torch.as_tensor(positions, device=x.device).expand(x.shape[0],
                                                             x.shape[1])
    ctx = blocked_attention(q, k, v, pos, pos, causal=True, window=window,
                            chunk=cfg.attn_chunk)
    return attn_out(p, cfg, ctx), (k, v)


def cross_attention(p, cfg, x, kv_cached):
    """Non-causal attention over a fixed (precomputed) K/V set, in chunks
    of ``min(attn_chunk, n)`` keys; a ``gate`` in ``p`` scales the output
    by ``tanh(gate)``. x: (B, S, D); kv_cached: ((B, n, KV, hd) × 2)."""
    B, S = x.shape[:2]
    q = attn_project_q(p, cfg, x, None, rope=False)
    k, v = kv_cached
    n = k.shape[1]
    zeros_q = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    zeros_kv = torch.zeros((B, n), dtype=torch.int32, device=x.device)
    ctx = blocked_attention(q, k, v, zeros_q, zeros_kv, causal=False,
                            chunk=min(cfg.attn_chunk, n))
    out = attn_out(p, cfg, ctx)
    if "gate" in p:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return out


def quantize_kv(x, axis: int = -1):
    """Symmetric int8 per-(token, kv-head) quantization. Returns (q, scale).

    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    x = x.float()
    scale = torch.amax(torch.abs(x), dim=axis) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(
        torch.int8)
    return q, scale


def _slot(pos, W: int, window: int):
    """The cache slot of position ``pos`` (B,): rolling (``pos % W``) under
    a window, else clamped to the last slot."""
    return (pos % W if window else torch.clamp(pos, max=W - 1)).long()


def decode_self_attention(p, cfg, x1, k_cache, v_cache, kv_pos, pos, *,
                          window=0, k_scale=None, v_scale=None):
    """One-token decode against a (possibly rolling) KV cache.

    Attention is a direct softmax over the whole cache (no chunk scan), in
    float32. ``k_scale``/``v_scale`` (B, W, KV) select the int8-quantized
    cache path (per-token-per-head symmetric scales).

    x1: (B, 1, D); caches: (B, W, KV, hd); kv_pos: (B, W) absolute positions
    of cache slots (``UNWRITTEN`` marks free slots; the caller writes this
    step's positions first, :func:`write_kv_pos`); pos: (B,) current
    position. The new token's K/V (and scales) are written into the cache
    tensors in place, at slot ``pos % W`` under a window and ``min(pos,
    W - 1)`` without. Returns (out, k_cache, v_cache, k_scale, v_scale):
    the caches are the tensors passed in.
    """
    q = attn_project_q(p, cfg, x1, pos[:, None])
    k_new, v_new = attn_project_kv(p, cfg, x1, pos[:, None])
    B = q.shape[0]
    W = k_cache.shape[1]
    rows, slot = torch.arange(B, device=pos.device), _slot(pos, W, window)
    if k_scale is not None:
        kq, ks = quantize_kv(k_new[:, 0])
        vq, vs = quantize_kv(v_new[:, 0])
        shd.index_write(k_cache, (rows, slot), kq)
        shd.index_write(v_cache, (rows, slot), vq)
        shd.index_write(k_scale, (rows, slot), ks.to(k_scale.dtype))
        shd.index_write(v_scale, (rows, slot), vs.to(v_scale.dtype))
        kf = k_cache.float() * k_scale[..., None]
        vf = v_cache.float() * v_scale[..., None]
    else:
        shd.index_write(k_cache, (rows, slot), k_new[:, 0].to(k_cache.dtype))
        shd.index_write(v_cache, (rows, slot), v_new[:, 0].to(v_cache.dtype))
        kf = k_cache.float()
        vf = v_cache.float()

    _, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, hd).float()
    valid = kv_pos <= pos[:, None]  # (B, W); free slots are UNWRITTEN
    if window:
        valid = valid & (pos[:, None] - kv_pos < window)

    def attend(qr, kf, vf, valid):
        s = torch.einsum("bkgd,bwkd->bkgw", qr, kf)
        s = s * hd**-0.5
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        probs = torch.softmax(s, dim=-1)
        return (torch.einsum("bkgw,bwkd->bkgd", probs, vf),)

    # per (batch row, KV head): on the local shards under a mesh
    ctx, = shd.local_call(attend, (qr, kf, vf, valid), _DECODE_IN,
                          (_DECODE_Q,))
    ctx = ctx.reshape(B, 1, H, hd).to(x1.dtype)
    return attn_out(p, cfg, ctx), k_cache, v_cache, k_scale, v_scale


# decode attention's logical axes on the local shards: whole caches, per
# batch row and KV head
_DECODE_Q = ("batch", "heads", "", "")
_DECODE_IN = (_DECODE_Q, ("batch", "", "heads", ""),
              ("batch", "", "heads", ""), ("batch", ""))


def write_kv_pos(kv_pos, pos, *, window: int = 0):
    """Record this decode step's positions in the shared slot book-keeping
    (B, W), in place. Returns ``kv_pos``."""
    B, W = kv_pos.shape
    shd.index_write(kv_pos, (torch.arange(B, device=pos.device),
                             _slot(pos, W, window)), pos.to(kv_pos.dtype))
    return kv_pos


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def mlp_defs(cfg, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "wg": ParamDef((D, F_), ("embed", "mlp")),
            "wu": ParamDef((D, F_), ("embed", "mlp")),
            "wd": ParamDef((F_, D), ("mlp", "embed")),
        }
    return {  # relu2 / gelu: single up-projection
        "wu": ParamDef((D, F_), ("embed", "mlp")),
        "wd": ParamDef((F_, D), ("mlp", "embed")),
    }


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the exact erf form, up to 4.7e-4 away on [-4, 4])."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, cfg, x):
    dt = x.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(dt))
        u = torch.einsum("bsd,df->bsf", x, p["wu"].to(dt))
        act = F.silu(g) if cfg.mlp_type == "swiglu" else _gelu(g)
        h = act * u
    else:
        u = torch.einsum("bsd,df->bsf", x, p["wu"].to(dt))
        h = torch.square(torch.relu(u)) if cfg.mlp_type == "relu2" else \
            _gelu(u)
    h = shd.constrain(h, "batch", "seq", "mlp")
    out = torch.einsum("bsf,fd->bsd", h, p["wd"].to(dt))
    return shd.constrain(out, "batch", "seq", "embed")


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------
def embed_defs(cfg) -> dict:
    d = {"table": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="small")}
    if not cfg.tie_embeddings:
        d["head"] = ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                             init="small")
    return d


def embed_apply(p, cfg, tokens):
    x = p["table"][tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # the reference multiplies by a weakly typed Python float, which
        # JAX first rounds to the array's dtype (45.25 for 2048 in bf16);
        # torch would keep it at full precision inside the multiply
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype))
    return shd.constrain(x, "batch", "seq", "embed")


def logits_apply(p, cfg, x):
    table = p.get("head", p["table"]).to(x.dtype)
    logits = torch.einsum("bsd,vd->bsv", x, table)
    return shd.constrain(logits, "batch", "seq", "vocab")


def softmax_xent_chunked(p, cfg, x, labels, mask=None):
    """Cross-entropy over the vocab head, over sequence chunks of
    ``cfg.loss_chunk`` so the (B, S, V) logits are never all held at once
    (each chunk's logits are recomputed in the backward)."""
    B, S, D = x.shape
    C = min(cfg.loss_chunk, S)
    if S % C:
        C = S  # fall back for odd smoke shapes
    if mask is None:
        mask = torch.ones((B, S), dtype=x.dtype, device=x.device)

    def chunk_nll(xi, li, mi):
        logits = f32(logits_apply(p, cfg, xi))
        # the port's own: under a mesh, whole rows of the vocab for the
        # gather (DTensor's masked gather of a vocab-sharded row fails)
        logits = shd.constrain(logits, "batch", "seq", "")
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
        return ((lse - gold) * mi).sum(), mi.sum()

    acc = torch.promote_types(x.dtype, torch.float32)
    tot = torch.zeros((), dtype=acc, device=x.device)
    cnt = torch.zeros((), dtype=acc, device=x.device)
    for j in range(S // C):
        sl = slice(j * C, (j + 1) * C)
        args = (x[:, sl], labels[:, sl], mask[:, sl])
        if torch.is_grad_enabled():
            nll, n = checkpoint(chunk_nll, *args, use_reentrant=False)
        else:
            nll, n = chunk_nll(*args)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
