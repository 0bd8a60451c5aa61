"""RWKV6 (Finch) — attention-free time-mix with data-dependent decay.

A PyTorch copy of ``repro.models.rwkv6``. The Finch recurrence

    out_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t   = diag(w_t) S_{t-1} + k_tᵀ v_t          (w_t per key channel)

comes in three forms sharing one parameter set:

* :func:`wkv_sequential` — the O(S) per-step oracle (tests only);
* the chunked prefill form, :func:`repro_torch.kernels.ops.wkv_chunk`: on a
  CUDA tensor the hand-written kernel (``kernels/csrc/wkv_chunk.cu``), on
  the CPU or with ``impl="ref"`` its plain version, the reference's
  ``wkv_chunked`` transcribed; under autograd on the card the wrapper
  goes through :class:`~repro_torch.kernels.ops.WkvChunk` (the kernel
  forward, the plain chunked form's gradient);
* :func:`wkv_decode` — the O(1) recurrent decode update, plain torch.

Token-shift ("ddlerp") and the decay LoRA follow the published Finch
formulation; LayerNorms are RMSNorm, as in the reference.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models.layers import f32, rms_norm
from repro_torch.models.params import ParamDef

__all__ = [
    "rwkv_defs",
    "rwkv_state_defs",
    "rwkv_block",
    "rwkv_block_decode",
    "wkv_sequential",
    "wkv_decode",
]

N_MIX = 5  # w, k, v, r, g token-shift mixes
# the wkv's logical axes on the local shards: whole sequences, per head
_BSHK = ("batch", "", "heads", "")
_STATE = ("batch", "heads", "", "")
_WKV_IN = (_BSHK, _BSHK, _BSHK, _BSHK, ("heads", ""), _STATE)
_WKV_OUT = (_BSHK, _STATE)
_DEC_X = ("batch", "heads", "")
_DEC_IN = (_DEC_X, _DEC_X, _DEC_X, _DEC_X, ("heads", ""), _STATE)
# the token-shift and decay loras': per token, whole weights
_LORA_IN = (("batch", "", ""), ("", ""), ("", "", ""))
_DECAY_IN = (("batch", "", ""), ("",), ("", ""), ("", ""))


# --------------------------------------------------------------------------
# parameter / state definitions
# --------------------------------------------------------------------------
def rwkv_defs(cfg) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    H, K = cfg.num_heads, cfg.head_dim
    R, Rd = cfg.rwkv_lora_dim, cfg.rwkv_decay_lora_dim
    return {
        "norm_tm": ParamDef((D,), ("embed",), init="ones"),
        "norm_cm": ParamDef((D,), ("embed",), init="ones"),
        # time-mix token shift (ddlerp)
        "mu_x": ParamDef((D,), ("embed",), init="zeros"),
        "mu5": ParamDef((N_MIX, D), ("", "embed"), init="zeros"),
        "tm_w1": ParamDef((D, N_MIX * R), ("embed", ""), scale=0.01),
        "tm_w2": ParamDef((N_MIX, R, D), ("", "", "embed"), scale=0.01),
        # data-dependent decay
        "w0": ParamDef((D,), ("embed",), init="zeros"),
        "td_w1": ParamDef((D, Rd), ("embed", ""), scale=0.01),
        "td_w2": ParamDef((Rd, D), ("", "embed"), scale=0.01),
        "u": ParamDef((H, K), ("heads", ""), init="zeros"),
        # projections
        "wr": ParamDef((D, D), ("embed", "tp")),
        "wk": ParamDef((D, D), ("embed", "tp")),
        "wv": ParamDef((D, D), ("embed", "tp")),
        "wg": ParamDef((D, D), ("embed", "tp")),
        "wo": ParamDef((D, D), ("tp", "embed")),
        "ln_x": ParamDef((D,), ("embed",), init="ones"),
        # channel-mix
        "mu_k": ParamDef((D,), ("embed",), init="zeros"),
        "mu_r": ParamDef((D,), ("embed",), init="zeros"),
        "cm_k": ParamDef((D, F_), ("embed", "mlp")),
        "cm_v": ParamDef((F_, D), ("mlp", "embed")),
        "cm_r": ParamDef((D, D), ("embed", "tp")),
    }


def rwkv_state_defs(cfg, batch: int) -> dict:
    """Decode-state layout for one layer (the token shifts are stored in
    bf16, as the reference stores them)."""
    D, H, K = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "wkv": ParamDef((batch, H, K, K), ("batch", "heads", "", ""),
                        dtype=torch.float32, init="zeros"),
        "shift_tm": ParamDef((batch, D), ("batch", "embed"), init="zeros"),
        "shift_cm": ParamDef((batch, D), ("batch", "embed"), init="zeros"),
    }


# --------------------------------------------------------------------------
# wkv cores (the chunked form is kernels.ops.wkv_chunk)
# --------------------------------------------------------------------------
def wkv_sequential(r, k, v, logw, u, state):
    """Oracle: explicit per-step recurrence.

    r/k/v/logw: (B, S, H, K) fp32; u: (H, K); state: (B, H, K, K).
    Returns (out (B, S, H, K), final_state).
    """
    outs = []
    for t in range(r.shape[1]):
        out, state = wkv_decode(r[:, t], k[:, t], v[:, t], logw[:, t], u,
                                state)
        outs.append(out)
    return torch.stack(outs, dim=1), state


def wkv_decode(r1, k1, v1, logw1, u, state):
    """One-token update. r1/k1/v1/logw1: (B, H, K); state: (B, H, K, V)."""
    kv = k1[..., :, None] * v1[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", r1, state + u[None, :, :, None] * kv)
    state = torch.exp(logw1)[..., None] * state + kv
    return out, state


# --------------------------------------------------------------------------
# full block (time-mix + channel-mix)
# --------------------------------------------------------------------------
def _ddlerp(p, x, xprev):
    """Finch data-dependent token-shift. Returns the 5 mixed inputs."""
    dt = x.dtype
    xx = xprev - x
    xxx = x + xx * p["mu_x"].to(dt)
    # per token, on the local shards under a mesh: DTensor would contract
    # the lora's rank over 'model' and hand the mixes on as partial sums,
    # each projection then run whole on every rank
    deltas, = shd.local_call(_lora_deltas, (xxx, p["tm_w1"], p["tm_w2"]),
                             _LORA_IN, (("batch", "", "", ""),))
    mixed = x[:, :, None] + xx[:, :, None] * (p["mu5"].to(dt)[None, None]
                                              + deltas)
    return [mixed[:, :, i] for i in range(N_MIX)]


def _lora_deltas(xxx, w1, w2):
    B, S, _ = xxx.shape
    dt = xxx.dtype
    lora = torch.tanh(torch.einsum("bsd,dr->bsr", xxx, w1.to(dt)))
    lora = lora.reshape(B, S, N_MIX, -1)
    return (torch.einsum("bsmr,mrd->bsmd", lora, w2.to(dt)),)


def _decay(p, xw):
    # per token, on the local shards under a mesh: DTensor would lay the
    # product's rows out over 'model' and merge them back with the batch
    # in the backward (the sharding module doc)
    ww, = shd.local_call(_decay_rows, (xw, p["w0"], p["td_w1"], p["td_w2"]),
                         _DECAY_IN, (_DECAY_IN[0],))
    return ww


def _decay_rows(xw, w0, w1, w2):
    ww = f32(w0) + torch.einsum("bsd,dr->bsr", f32(xw), f32(w1)) @ f32(w2)
    return (-torch.exp(torch.clamp(ww, -20.0, 20.0)),)  # log w (< 0)


def _head_norm(p, cfg, y):
    """Per-head RMS norm of the wkv output (stands in for Finch's GroupNorm)."""
    B, S, H, K = y.shape
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 64e-5)
    return y.reshape(B, S, H * K) * p["ln_x"].to(y.dtype)


def _time_mix(p, cfg, x, xprev, wkv_state, *, decode: bool,
              impl: str = "auto"):
    B, S, D = x.shape
    H, K = cfg.num_heads, cfg.head_dim
    xw, xk, xv, xr, xg = _ddlerp(p, x, xprev)
    dt = x.dtype
    r = torch.einsum("bsd,de->bse", xr, p["wr"].to(dt)).reshape(B, S, H, K)
    k = torch.einsum("bsd,de->bse", xk, p["wk"].to(dt)).reshape(B, S, H, K)
    v = torch.einsum("bsd,de->bse", xv, p["wv"].to(dt)).reshape(B, S, H, K)
    g = F.silu(torch.einsum("bsd,de->bse", xg, p["wg"].to(dt)))
    logw = _decay(p, xw).reshape(B, S, H, K)
    r32, k32, v32 = (f32(t).contiguous() for t in (r, k, v))
    u = f32(p["u"]).contiguous()
    if decode:
        # per (batch row, head): on the local shards under a mesh
        y, wkv_state = shd.local_call(
            wkv_decode, (r32[:, 0], k32[:, 0], v32[:, 0], logw[:, 0], u,
                         wkv_state), _DEC_IN, (_DEC_X, _STATE))
        y = y[:, None]
    else:
        r32 = shd.constrain(r32, "batch", "seq", "heads", "head_dim")
        args = (r32, k32, v32, logw.contiguous(), u, wkv_state.contiguous())
        wkv = impl if callable(impl) else partial(ops.wkv_chunk, impl=impl)
        # per (batch, head): run on the local shards under a mesh
        y, wkv_state = shd.local_call(wkv, args, _WKV_IN, _WKV_OUT)
    y = _head_norm(p, cfg, y).to(dt) * g
    out = torch.einsum("bse,ed->bsd", y, p["wo"].to(dt))
    return shd.constrain(out, "batch", "seq", "embed"), wkv_state


def _channel_mix(p, cfg, x, xprev):
    dt = x.dtype
    xx = xprev - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    # laid out before the activation: a batch of one leaves 'data' to the
    # features, the contraction hands on partial sums over it, and DTensor
    # resolved them inside the relu by a gather and a reduce-scatter
    kk = shd.constrain(torch.einsum("bsd,df->bsf", xk, p["cm_k"].to(dt)),
                       "batch", "seq", "mlp")
    kk = torch.square(torch.relu(kk))
    kv = torch.einsum("bsf,fd->bsd", kk, p["cm_v"].to(dt))
    rr = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["cm_r"].to(dt)))
    return shd.constrain(rr * kv, "batch", "seq", "embed")


def _shifted(x, first):
    """x_{t-1} with ``first`` (B, D) in slot 0."""
    return torch.cat([first[:, None], x[:, :-1]], dim=1)


def rwkv_block(p, cfg, x, state=None, *, impl: str = "auto"):
    """Full-sequence block. x: (B, S, D). state: rwkv_state_defs layout or None.

    Returns (x_out, new_state). ``impl`` (``"auto"`` or ``"ref"``) goes to
    ``ops.wkv_chunk``; a function of ``(r, k, v, logw, u, state)`` that
    returns ``(out, final_state)`` takes its place (an instrumented wkv).
    """
    B, S, D = x.shape
    H, K = cfg.num_heads, cfg.head_dim
    if state is None:
        wkv0 = torch.zeros((B, H, K, K), device=x.device,
                           dtype=torch.promote_types(x.dtype, torch.float32))
        sh_tm = torch.zeros((B, D), dtype=x.dtype, device=x.device)
        sh_cm = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    else:
        wkv0 = state["wkv"]
        sh_tm = state["shift_tm"].to(x.dtype)
        sh_cm = state["shift_cm"].to(x.dtype)
    h = shd.seq_whole(rms_norm(x, p["norm_tm"], cfg.norm_eps))
    tm_out, wkv = _time_mix(p, cfg, h, _shifted(h, sh_tm), wkv0,
                            decode=False, impl=impl)
    x = x + tm_out
    h2 = shd.seq_whole(rms_norm(x, p["norm_cm"], cfg.norm_eps))
    x = x + _channel_mix(p, cfg, h2, _shifted(h2, sh_cm))
    return x, {"wkv": wkv, "shift_tm": h[:, -1], "shift_cm": h2[:, -1]}


def rwkv_block_decode(p, cfg, x1, state):
    """One-token block. x1: (B, 1, D); state per rwkv_state_defs."""
    h = rms_norm(x1, p["norm_tm"], cfg.norm_eps)
    tm_out, wkv = _time_mix(
        p, cfg, h, state["shift_tm"].to(h.dtype)[:, None], state["wkv"],
        decode=True,
    )
    x1 = x1 + tm_out
    h2 = rms_norm(x1, p["norm_cm"], cfg.norm_eps)
    cm_out = _channel_mix(p, cfg, h2, state["shift_cm"].to(h2.dtype)[:, None])
    x1 = x1 + cm_out
    return x1, {"wkv": wkv, "shift_tm": h[:, 0], "shift_cm": h2[:, 0]}
