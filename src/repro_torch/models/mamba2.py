"""Mamba2 mixer (SSD, state-space duality, chunked scan), a copy of
``repro.models.mamba2``.

The sequence is split into chunks of 64 (one chunk of S when 64 does not
divide S, the reference's fallback: a (B, S, S, H) decay tensor). Each
chunk's quadratic intra-chunk term, its decays and its state increment
depend on the chunk alone, so they are computed for every chunk at once;
the carried float32 (B, H, P, N) state then walks the chunks in a Python
loop (the reference's ``lax.scan``), and the inter-chunk term projects
each chunk's incoming state onto its positions. Each chunk's arithmetic is
the reference's. Decode is the O(1) recurrent update. Plain PyTorch: no
TPU kernel lies on this path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.models.params import ParamDef

__all__ = ["mamba2_defs", "mamba2_apply", "mamba2_decode", "mamba2_state_defs"]


def mamba2_defs(cfg) -> dict:
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    W = cfg.ssm_conv
    return {
        "norm": ParamDef((D,), ("embed",), init="ones"),
        "wz": ParamDef((D, DI), ("embed", "tp")),
        "wx": ParamDef((D, DI), ("embed", "tp")),
        "wB": ParamDef((D, N), ("embed", "")),
        "wC": ParamDef((D, N), ("embed", "")),
        "wdt": ParamDef((D, H), ("embed", "tp")),
        "conv_x": ParamDef((W, DI), ("", "tp"), scale=0.5),
        "conv_B": ParamDef((W, N), ("", ""), scale=0.5),
        "conv_C": ParamDef((W, N), ("", ""), scale=0.5),
        "A_log": ParamDef((H,), ("tp",), init="zeros"),
        "dt_bias": ParamDef((H,), ("tp",), init="zeros"),
        "D_skip": ParamDef((H,), ("tp",), init="ones"),
        "gnorm": ParamDef((DI,), ("tp",), init="ones"),
        "wo": ParamDef((DI, D), ("tp", "embed")),
    }


def mamba2_state_defs(cfg, batch: int) -> dict:
    """Decode-state layout for one layer: the conv tails in bf16 (the
    ParamDef default, as in the reference) and the SSM state in float32."""
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    W = cfg.ssm_conv
    return {
        "conv_x": ParamDef((batch, W - 1, DI), ("batch", "", "tp"), init="zeros"),
        "conv_B": ParamDef((batch, W - 1, N), ("batch", "", ""), init="zeros"),
        "conv_C": ParamDef((batch, W - 1, N), ("batch", "", ""), init="zeros"),
        "ssm": ParamDef((batch, H, P, N), ("batch", "tp", "", ""),
                        dtype=torch.float32, init="zeros"),
    }


def _causal_conv(x, w):
    """Depthwise causal conv. x: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, i:i + S, :] * w[i] for i in range(W))


def _project(p, cfg, x):
    dt_ = x.dtype
    # the gate's gradient laid out as z (the features over 'model')
    z = shd.grad_as_is(torch.einsum("bsd,de->bse", x, p["wz"].to(dt_)))
    xs = torch.einsum("bsd,de->bse", x, p["wx"].to(dt_))
    Bp = torch.einsum("bsd,dn->bsn", x, p["wB"].to(dt_))
    Cp = torch.einsum("bsd,dn->bsn", x, p["wC"].to(dt_))
    dt = torch.einsum("bsd,dh->bsh", x, p["wdt"].to(dt_))
    return z, xs, Bp, Cp, dt


def mamba2_apply(p, cfg, x, *, chunk: int = 64, return_state: bool = False):
    """Full-sequence SSD. x: (B, S, D) -> (out, final_state | None)."""
    B, S, D = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xr, Br, Cr, dt = _project(p, cfg, shd.seq_whole(x))
    xs = F.silu(_causal_conv(xr, p["conv_x"].to(xr.dtype)))
    Bp = F.silu(_causal_conv(Br, p["conv_B"].to(Br.dtype)))
    Cp = F.silu(_causal_conv(Cr, p["conv_C"].to(Cr.dtype)))
    xs = shd.constrain(xs, "batch", "seq", "tp")

    Q = min(chunk, S)
    if S % Q:
        Q = S
    NC = S // Q
    A = -torch.exp(p["A_log"].float())  # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    xh = xs.reshape(B, NC, Q, H, P).float()
    Bc = Bp.reshape(B, NC, Q, N).float()
    Cc = Cp.reshape(B, NC, Q, N).float()
    dtc = dt.reshape(B, NC, Q, H)
    # per batch row, on the local shards under a mesh, the heads whole
    # (the reference's layout of xh): DTensor would merge the batch with
    # the chunks and heads in the chunk einsums (the sharding module doc)
    y, st = shd.local_call(_ssd, (xh, Bc, Cc, dtc, A), _SSD_IN, _SSD_OUT)

    y = y.reshape(B, S, H, P)
    y = y + xs.reshape(B, S, H, P).float() * p["D_skip"].float()[
        None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner)

    out = _gate_norm_out(p, cfg, y, z)
    if return_state:
        return out, {
            "conv_x": xs_tail(xr, cfg.ssm_conv),
            "conv_B": xs_tail(Br, cfg.ssm_conv),
            "conv_C": xs_tail(Cr, cfg.ssm_conv),
            "ssm": st,
        }
    return out, None


# the SSD's logical axes on the local shards: per batch row, all heads
_SSD_IN = (("batch", "", "", "", ""), ("batch", "", "", ""),
           ("batch", "", "", ""), ("batch", "", "", ""), ("",))
_SSD_OUT = (("batch", "", "", "", ""), ("batch", "", "", ""))


def _ssd(xh, Bc, Cc, dtc, A):
    """The chunked scan: xh (B, NC, Q, H, P), Bc/Cc (B, NC, Q, N) float32,
    dtc (B, NC, Q, H), A (H,). Returns (y (B, NC, Q, H, P), the final
    state (B, H, P, N))."""
    B, NC, Q, H, P = xh.shape
    N = Bc.shape[-1]
    Lmask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))

    # every chunk's own terms at once: (B, NC, ...)
    cum = torch.cumsum(dtc * A, dim=2)  # (B,NC,Q,H)
    xdt = xh * dtc[..., None]
    # intra-chunk quadratic term (clamped before exp: valid (t >= s)
    # entries are <= 0 in log space)
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,NC,t,s,H)
    decay = torch.exp(torch.clamp(ldiff, max=0.0))
    decay = torch.where(Lmask[None, None, :, :, None], decay, 0.0)
    att = torch.einsum("bctn,bcsn->bcts", Cc, Bc)[..., None] * decay
    y = torch.einsum("bctsh,bcshp->bcthp", att, xdt)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,NC,Q,H)
    inc = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bc, decay_end, xdt)
    chunk_decay = torch.exp(cum[:, :, -1])[..., None, None]  # (B,NC,H,1,1)

    # the carried state walks the chunks in order
    st = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    states = []
    for c in range(NC):
        states.append(st)
        st = st * chunk_decay[:, c] + inc[:, c]
    st_in = torch.stack(states, dim=1)  # (B,NC,H,P,N): each chunk's input
    # inter-chunk term from the carried state
    y = y + torch.einsum("bctn,bcth,bchpn->bcthp", Cc, torch.exp(cum), st_in)
    return y, st


def xs_tail(x, width):
    """Last (width-1) raw inputs, as the decode conv state."""
    return x[:, -(width - 1):, :]


def _gate_norm_out(p, cfg, y, z):
    y = y * F.silu(z.float())
    # gated RMSNorm over d_inner
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + cfg.norm_eps)
    y = y * p["gnorm"].float()
    y = y.to(z.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["wo"].to(z.dtype))
    return shd.constrain(out, "batch", "seq", "embed")


def mamba2_decode(p, cfg, x1, state):
    """One-token recurrent step. x1: (B, 1, D); state: see
    :func:`mamba2_state_defs`. Returns (out, new_state): new tensors, in
    the dtypes the step computes them in (the conv tails in the compute
    dtype, the SSM state in float32)."""
    B = x1.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, Bp, Cp, dt = _project(p, cfg, x1)

    def step_conv(buf, new, w):
        # buf: (B, W-1, C); new: (B, 1, C) -> (out (B,C), new_buf)
        full = torch.cat([buf, new], dim=1)  # (B, W, C)
        return torch.einsum("bwc,wc->bc", full, w), full[:, 1:, :]

    cx, ncx = step_conv(state["conv_x"].to(xs.dtype), xs,
                        p["conv_x"].to(xs.dtype))
    cB, ncB = step_conv(state["conv_B"].to(Bp.dtype), Bp,
                        p["conv_B"].to(Bp.dtype))
    cC, ncC = step_conv(state["conv_C"].to(Cp.dtype), Cp,
                        p["conv_C"].to(Cp.dtype))
    cx, cB, cC = F.silu(cx), F.silu(cB), F.silu(cC)

    A = -torch.exp(p["A_log"].float())
    dts = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B,H)
    dA = torch.exp(dts * A)  # (B,H)
    xh = cx.reshape(B, H, P).float()

    def recur(ssm, dA, dts, xh, cB, cC, skip):
        ssm = ssm * dA[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dts, xh, cB)
        y = torch.einsum("bhpn,bn->bhp", ssm, cC)
        return ssm, y + xh * skip[None, :, None]

    # per batch row and head: on the local shards under a mesh, the state
    # in its own layout (heads over 'model'). Left to DTensor, a batch of
    # one leaves 'data' free, the update's heads took it, and the state
    # was gathered whole twice a layer
    ssm, y = shd.local_call(
        recur, (state["ssm"], dA, dts, xh, cB.float(), cC.float(),
                p["D_skip"].float()), _RECUR_IN, (_RECUR_IN[0], _RECUR_IN[3]))
    y = y.reshape(B, 1, cfg.d_inner)
    out = _gate_norm_out(p, cfg, y, z)
    return out, {"conv_x": ncx, "conv_B": ncB, "conv_C": ncC, "ssm": ssm}


# the decode recurrence's logical axes on the local shards: the state, dA,
# dt, x, B, C and the skip weights (the outputs: the state's and x's)
_RECUR_IN = (("batch", "tp", "", ""), ("batch", "tp"), ("batch", "tp"),
             ("batch", "tp", ""), ("batch", ""), ("batch", ""), ("tp",))
