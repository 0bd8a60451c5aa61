"""Where a float32 train step of ``rwkv6-3b`` on the card parts from the
CPU's, and which side is nearer the float64 gradients (ROADMAP F14).

At 2 layers of the full width (chip_smoke's 13b cut; float32 compute, the
bf16 weights drawn on the card held in float32 leaves), for one microbatch
of each of ``BATCHES``, on the same inputs:

1. ``forward``: the loss, step by step as ``M.lm_loss`` computes it (the
   token shift and ``_ddlerp``'s five mixes, r, k, v, g and logw, the wkv
   output, the time mix, the channel mix and the residuals of each layer,
   then the final norm), run on the card (the wkv kernel) and on the CPU
   (the plain wkv): each activation's max|Δ| / max|CPU| (``card_vs_cpu``)
   and each side's against the float64 run's (``*_vs_f64``);
2. ``ops``: each op of that chain alone (``time_mix_in``: norm, token
   shift and projections; ``wkv``; ``time_mix_out``: head norm, gate and
   ``wo``; ``channel_mix``; ``head``: final norm and loss) fed the CPU
   run's inputs and its upstream gradient on every side: the CPU, the
   card with the kernel, the card with the plain wkv and the card in
   float64 with the plain wkv; each output and input gradient as above;
3. ``grads``: every parameter's gradient of the whole step, each float32
   side (the CPU; the card with the kernel, and with the plain wkv)
   against the float64 gradients computed on the card with the plain
   wkv, and the card's against the CPU's (max|Δ| / max|float64 leaf|);
   and the card's run again with one op of ``OPS`` at a time (in every
   layer, its forward and backward) on the CPU
   (``card_<op>_on_cpu_vs_f64``): the op whose move takes the card to
   the CPU's distance is where the two part; and each side with every
   parameter changed in its last bit, × (1 + 2^-24·N(0, 1))
   (``*_perturbed_vs_f64``): how far a rounding of the inputs moves it;
4. ``attribution`` (:func:`attribute`, at (1, 512)): the step with its
   GEMMs, its pointwise ops and reductions, or both correctly rounded,
   on each side; every op of the CPU's step run again on its inputs on
   the card, each side against float64 at positions 0 and 1; planted
   faults;
5. ``gemm_paths`` (:func:`gemm_paths`): the step's float32 GEMM shapes by
   each call path on the card and on the CPU against float64;
6. ``bound_readings`` (:func:`bound_readings`): per seed of five, the
   readings that set chip_smoke's (1, 512) bounds.

Needs one CUDA card (~15 min); run from the root of a checkout:

    python3 tools/train_cpu_gap.py [--out artifacts/train_cpu_gap.json]

Writes the whole record to ``--out`` and prints a summary JSON object and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCHES = ((1, 512), (2, 512))
LAYERS = 2


def _rel(got, want) -> float:
    """max|got − want| / max|want| (0 where both are 0)."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


def _on_cpu(fn):
    """``fn(ins, params, *rest)`` run on the CPU: its tensors moved there
    and its outputs moved back to the device of ``ins`` (autograd follows
    both moves, so the op's backward runs on the CPU too)."""
    import torch

    from repro_torch.models.params import tree_map

    def run(ins, params, *rest):
        back = next(iter(ins.values())).device

        def mv(t):
            return t.to("cpu") if isinstance(t, torch.Tensor) else t
        out = fn({k: mv(t) for k, t in ins.items()}, tree_map(mv, params),
                 *(mv(r) for r in rest))
        return {k: t.to(back) for k, t in out.items()}
    return run


def _trace(params, cfg, batch, impl, swap=()):
    """``M.lm_loss`` of the ssm family written out op by op: ``(loss,
    acts)``, every activation kept (its gradient retained) under a name
    ``<layer>/<what>``. The same ops in the same order as
    ``rwkv6.rwkv_block`` (no state) and ``M.lm_loss``. The ops named in
    ``swap`` (of ``OPS``) run on the CPU, the rest where ``params`` lie."""
    from repro_torch.models import layers as lyr
    from repro_torch.models.params import tree_map

    ops = {name: _on_cpu(fn) if name in swap else fn
           for name, fn in OPS.items()}

    acts = {}

    def keep(name, t):
        if t.requires_grad:
            t.retain_grad()
        acts[name] = t
        return t

    x = keep("embed", lyr.embed_apply(params["embed"], cfg,
                                      batch["tokens"]))
    for i in range(cfg.num_layers):
        p = tree_map(lambda a: a[i], params["layers"])
        ins = dict(x=x)
        outs = ops["mix"](ins, p, cfg)
        outs.update(ops["proj"](outs, p, cfg), **ops["decay"](outs, p, cfg))
        for k, t in outs.items():
            keep(f"{i}/{k}", t)
        y = keep(f"{i}/wkv", ops["wkv"](outs, p, cfg, impl)["wkv"])
        tm = keep(f"{i}/time_mix", ops["time_mix_out"](
            dict(wkv=y, g=outs["g"]), p, cfg)["time_mix"])
        x = keep(f"{i}/residual_tm", x + tm)
        cm = keep(f"{i}/channel_mix", ops["channel_mix"](
            dict(x=x), p, cfg)["channel_mix"])
        x = keep(f"{i}/residual", x + cm)
    loss = ops["head"](dict(x=x), params, cfg, batch["labels"])["loss"]
    return loss, acts


def _mix(ins, p, cfg):
    """``rwkv_block`` up to the mixes: the norm, the token shift and
    ``_ddlerp``'s five mixes."""
    import torch

    from repro_torch.models import rwkv6 as rwkv
    from repro_torch.models.layers import rms_norm

    x = ins["x"]
    B, S, D = x.shape
    h = rms_norm(x, p["norm_tm"], cfg.norm_eps)
    xprev = rwkv._shifted(h, torch.zeros((B, D), dtype=x.dtype,
                                         device=x.device))
    xw, xk, xv, xr, xg = rwkv._ddlerp(p, h, xprev)
    return dict(norm_tm=h, token_shift=xprev, mix_w=xw, mix_k=xk, mix_v=xv,
                mix_r=xr, mix_g=xg)


def _proj(ins, p, cfg):
    """r, k, v and the gate g from the mixes."""
    import torch
    import torch.nn.functional as F

    xr = ins["mix_r"]
    B, S, D = xr.shape
    H, K = cfg.num_heads, cfg.head_dim
    dt = xr.dtype
    r = torch.einsum("bsd,de->bse", xr, p["wr"].to(dt)).reshape(B, S, H, K)
    k = torch.einsum("bsd,de->bse", ins["mix_k"],
                     p["wk"].to(dt)).reshape(B, S, H, K)
    v = torch.einsum("bsd,de->bse", ins["mix_v"],
                     p["wv"].to(dt)).reshape(B, S, H, K)
    g = F.silu(torch.einsum("bsd,de->bse", ins["mix_g"], p["wg"].to(dt)))
    return dict(r=r, k=k, v=v, g=g)


def _decay(ins, p, cfg):
    """logw from the decay's mix (``rwkv6._decay``)."""
    from repro_torch.models import rwkv6 as rwkv

    xw = ins["mix_w"]
    B, S, _ = xw.shape
    return dict(logw=rwkv._decay(p, xw).reshape(B, S, cfg.num_heads,
                                                cfg.head_dim))


def _time_mix_in(ins, p, cfg):
    """``rwkv_block`` up to the wkv: :func:`_mix`, :func:`_proj` and
    :func:`_decay`."""
    mixes = _mix(ins, p, cfg)
    return {**mixes, **_proj(mixes, p, cfg), **_decay(mixes, p, cfg)}


def _wkv(ins, p, cfg, impl):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.layers import f32

    r, k, v = (f32(ins[n]).contiguous() for n in "rkv")
    B, S, H, K = r.shape
    u = f32(p["u"]).contiguous()
    state = torch.zeros((B, H, K, K), dtype=r.dtype, device=r.device)
    wkv = impl if callable(impl) else (
        lambda *a: ops.wkv_chunk(*a, impl=impl))
    y, _ = wkv(r, k, v, ins["logw"].contiguous(), u, state)
    return dict(wkv=y)


def _time_mix_out(ins, p, cfg):
    import torch

    from repro_torch.models import rwkv6 as rwkv

    g = ins["g"]
    y = rwkv._head_norm(p, cfg, ins["wkv"]).to(g.dtype) * g
    return dict(time_mix=torch.einsum("bse,ed->bsd", y,
                                      p["wo"].to(g.dtype)))


def _channel_mix(ins, p, cfg):
    import torch

    from repro_torch.models import rwkv6 as rwkv
    from repro_torch.models.layers import rms_norm

    x = ins["x"]
    h2 = rms_norm(x, p["norm_cm"], cfg.norm_eps)
    first = torch.zeros(h2.shape[::2], dtype=h2.dtype, device=h2.device)
    return dict(channel_mix=rwkv._channel_mix(p, cfg, h2,
                                              rwkv._shifted(h2, first)))


def _head(ins, params, cfg, labels):
    from repro_torch.models import layers as lyr

    x = lyr.rms_norm(ins["x"], params["final_norm"], cfg.norm_eps)
    return dict(loss=lyr.softmax_xent_chunked(params["embed"], cfg, x,
                                              labels))


#: the chain's ops, in the order a layer runs them
OPS = {"mix": _mix, "proj": _proj, "decay": _decay, "wkv": _wkv,
       "time_mix_out": _time_mix_out, "channel_mix": _channel_mix,
       "head": _head}


def _grads(params, cfg, batch, device, dtype, impl, trace: bool = False,
           swap=(), mode=None):
    """Every parameter's gradient of the loss (``_trace``), and with
    ``trace`` the activations and their gradients; forward and backward
    under the dispatch mode ``mode`` where one is given."""
    import contextlib

    import torch

    from repro_torch.models.params import tree_defs
    from repro_torch.train.step import _unflatten

    paths, leaves = zip(*((p, t.detach().to(device, dtype)
                           .requires_grad_()) for p, t in tree_defs(params)))
    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    with torch.enable_grad(), mode or contextlib.nullcontext():
        loss, acts = _trace(_unflatten(paths, leaves), cfg, b, impl, swap)
        loss.backward()
    out = dict(loss=float(loss.detach()),
               grads={"/".join(p): t.grad for p, t in zip(paths, leaves)})
    if trace:
        out["acts"] = {k: t.detach() for k, t in acts.items()}
        out["act_grads"] = {k: t.grad for k, t in acts.items()
                            if t.grad is not None}
    return out


def _op_vjp(fn, ins: dict, ps: dict, ups: dict, device, dtype):
    """``fn(ins, ps)``'s outputs and the gradients of its inputs and
    parameters for the upstream gradients ``ups`` (by output name), all
    cast to ``dtype`` on ``device``."""
    import torch

    def put(t):
        t = t.detach().to(device, dtype if t.is_floating_point() else None)
        return t.requires_grad_() if t.is_floating_point() else t

    ins = {k: put(t) for k, t in ins.items()}
    ps = {k: put(t) for k, t in ps.items()}
    with torch.enable_grad():
        outs = fn(ins, ps)
        leaves = {**{"in/" + k: t for k, t in ins.items()
                     if t.requires_grad},
                  **{"param/" + k: t for k, t in ps.items()}}
        names = list(ups)
        grads = torch.autograd.grad(
            [outs[k] for k in names], list(leaves.values()),
            [ups[k].to(device, outs[k].dtype) for k in names],
            allow_unused=True)
    res = {"out/" + k: outs[k].detach() for k in names}
    res.update({k: g for k, g in zip(leaves, grads) if g is not None})
    return res


def _ops(cpu, params, cfg, labels, card_dev) -> dict:
    """Each op of the chain alone on the CPU run's inputs and upstream
    gradients (module doc, 2.)."""
    import torch

    from repro_torch.models.params import tree_map

    acts, ups = cpu["acts"], cpu["act_grads"]
    cpu_dev = torch.device("cpu")
    out = {}
    for i in range(cfg.num_layers):
        p = tree_map(lambda a: a[i], params["layers"])
        x_in = acts["embed"] if i == 0 else acts[f"{i - 1}/residual"]
        mix_names = ("r", "k", "v", "g", "logw")
        cases = {
            "time_mix_in": (lambda ins, ps: _time_mix_in(ins, ps, cfg),
                            dict(x=x_in), mix_names),
            "time_mix_out": (lambda ins, ps: _time_mix_out(ins, ps, cfg),
                             dict(wkv=acts[f"{i}/wkv"],
                                  g=acts[f"{i}/g"]), ("time_mix",)),
            "channel_mix": (lambda ins, ps: _channel_mix(ins, ps, cfg),
                            dict(x=acts[f"{i}/residual_tm"]),
                            ("channel_mix",)),
        }
        for name, (fn, ins, outs) in cases.items():
            u = {k: ups[f"{i}/{k}"] for k in outs}
            out[f"{i}/{name}"] = _sides(fn, ins, p, u, cpu_dev, card_dev)
        wkv_in = {k: acts[f"{i}/{k}"] for k in ("r", "k", "v", "logw")}
        out[f"{i}/wkv"] = _sides(
            None, wkv_in, p, {"wkv": ups[f"{i}/wkv"]}, cpu_dev, card_dev,
            wkv=cfg)
    last = acts[f"{cfg.num_layers - 1}/residual"]
    head_ps = {"final_norm": params["final_norm"], **{
        f"embed/{k}": t for k, t in params["embed"].items()}}

    def head(ins, ps):
        pp = {"final_norm": ps["final_norm"],
              "embed": {k[6:]: t for k, t in ps.items()
                        if k.startswith("embed/")}}
        return _head(ins, pp, cfg, labels.to(ins["x"].device))

    out["head"] = _sides(head, dict(x=last), head_ps,
                         {"loss": torch.ones(())}, cpu_dev, card_dev)
    return out


def _sides(fn, ins, ps, ups, cpu_dev, card_dev, wkv=None) -> dict:
    """One op on the CPU (float32), the card (float32, the kernel and the
    plain wkv) and the card in float64 (the plain wkv): each tensor's
    distances."""
    import torch

    def run(dev, dtype, impl):
        f = fn if wkv is None else (
            lambda i, p: _wkv(i, p, wkv, impl))
        return _op_vjp(f, ins, ps if wkv is None else {"u": ps["u"]},
                       ups, dev, dtype)

    cpu = run(cpu_dev, torch.float32, "auto")
    card = run(card_dev, torch.float32, "auto")
    plain = run(card_dev, torch.float32, "ref")
    f64 = run(card_dev, torch.float64, "ref")
    return {k: dict(card_vs_cpu=_rel(card[k], cpu[k]),
                    card_vs_f64=_rel(card[k], f64[k]),
                    card_plain_vs_f64=_rel(plain[k], f64[k]),
                    cpu_vs_f64=_rel(cpu[k], f64[k]),
                    **({"where": _where(card[k], cpu[k], f64[k], top=3)}
                       if f64[k].dim() >= 3 else {})) for k in f64}


def _where(card, cpu, f64, top: int = 8) -> list:
    """The positions (b, s) of an activation (B, S, ...) where the card's
    float32 value lies farthest from the float64 one: for each, the card's
    and the CPU's largest |Δ| there over the other dims, each divided by
    the float64 value's largest |·| over the whole tensor, and the float64
    value's largest |·| there over that same scale."""
    card, cpu, f64 = (t.double().cpu() for t in (card, cpu, f64))
    B, S = f64.shape[:2]
    scale = float(f64.abs().max())
    e_card = (card - f64).abs().reshape(B, S, -1).amax(-1) / scale
    e_cpu = (cpu - f64).abs().reshape(B, S, -1).amax(-1) / scale
    mag = f64.abs().reshape(B, S, -1).amax(-1) / scale
    idx = e_card.flatten().argsort(descending=True)[:top]
    return [dict(b=int(i) // S, s=int(i) % S,
                 card=float(e_card.flatten()[i]),
                 cpu=float(e_cpu.flatten()[i]),
                 magnitude=float(mag.flatten()[i])) for i in idx]


def train_cpu_gap(seed: int = 0, device: str = "cuda", cfg=None,
                  batches=BATCHES) -> dict:
    """The record for each batch of ``batches`` (module doc). ``cfg``
    (default: ``rwkv6-3b`` cut to ``LAYERS`` layers in float32) and
    ``device="cpu"`` rehearse it without a card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map

    if cfg is None:
        full = get_config("rwkv6-3b")
        cfg = dataclasses.replace(full, num_layers=LAYERS,
                                  dtype=torch.float32)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    dev, cpu_dev = torch.device(device), torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    params = tree_map(lambda t: t.float().cpu(), M.init_params(cfg, gen, dev))
    out = {}
    for B, S in batches:
        b = TokenDataset(cfg.vocab_size, S, seed=seed).shard_batch(0, B)
        cpu = _grads(params, cfg, b, cpu_dev, torch.float32, "auto", True)
        card = _grads(params, cfg, b, dev, torch.float32, "auto", True)
        plain = _grads(params, cfg, b, dev, torch.float32, "ref")
        f64 = _grads(params, cfg64, b, dev, torch.float64, "ref", True)
        ref_loss = float(M.lm_loss(params, cfg, {
            k: torch.as_tensor(v) for k, v in b.items()}))
        if ref_loss != cpu["loss"]:
            raise AssertionError(f"the op-by-op trace's loss {cpu['loss']} "
                                 f"is not lm_loss's {ref_loss}")

        def dist(side):
            return {k: _rel(side["grads"][k], w)
                    for k, w in f64["grads"].items()}

        swapped = {f"card_{name}_on_cpu_vs_f64": dist(_grads(
            params, cfg, b, dev, torch.float32, "auto", swap={name}))
            for name in OPS}
        noise = torch.Generator().manual_seed(seed + 99)
        pert = tree_map(lambda t: t * (1 + 2.0 ** -24 * torch.randn(
            t.shape, generator=noise)), params)
        perturbed = {f"{side}_perturbed_vs_f64": dist(_grads(
            pert, cfg, b, d, torch.float32, "auto"))
            for side, d in (("cpu", cpu_dev), ("card", dev))}
        grads = dict(cpu_vs_f64=dist(cpu), card_vs_f64=dist(card),
                     card_plain_vs_f64=dist(plain),
                     **swapped, **perturbed,
                     card_vs_cpu={k: _rel(card["grads"][k], w)
                                  for k, w in cpu["grads"].items()})
        forward = {k: dict(card_vs_cpu=_rel(card["acts"][k], a),
                           card_vs_f64=_rel(card["acts"][k],
                                            f64["acts"][k]),
                           cpu_vs_f64=_rel(a, f64["acts"][k]))
                   for k, a in cpu["acts"].items()}
        ops_ = _ops(cpu, params, cfg, torch.as_tensor(b["labels"]), dev)
        where = {f"{kind}:{k}": _where(card[kind][k], cpu[kind][k],
                                       f64[kind][k], top=3)
                 for kind in ("acts", "act_grads") for k in card[kind]
                 if card[kind][k].dim() >= 2}
        out[f"{B}x{S}"] = dict(
            loss=dict(cpu=cpu["loss"], card=card["loss"], f64=f64["loss"]),
            grad_norm=float(sum((g.double() ** 2).sum()
                                for g in f64["grads"].values()) ** 0.5),
            grads=grads, forward=forward, ops=ops_, where=where,
            worst={k: max(v.values()) for k, v in grads.items()})
        del cpu, card, plain, f64
    return out


#: the GEMMs, whose float32 sums the ``exact`` runs take out
GEMMS = ("mm", "bmm", "addmm", "baddbmm")
#: the reductions, counted with the pointwise ops as ``other``
REDUCTIONS = ("sum", "mean", "cumsum", "amax", "_softmax", "_log_softmax",
              "_softmax_backward_data", "_log_softmax_backward_data",
              "logsumexp", "linalg_vector_norm")
#: the planted faults of the float32 card run (``attribute``): the wkv's
#: backward on r, k, v and logw rounded to bf16 (a stray cast), and the
#: gradient to logw scaled by 1 + 1e-3
FAULTS = ("wkv_bwd_bf16", "wkv_dlogw_1e-3")


def _kind(func) -> str | None:
    """``"gemm"``, ``"other"`` (pointwise or a reduction) or None (views,
    copies, indexing, factories: exact in any precision)."""
    import torch

    name = func.overloadpacket.__name__
    if name in GEMMS:
        return "gemm"
    if torch.Tag.pointwise in func.tags or name in REDUCTIONS:
        return "other"
    return None


def _is_f32(t) -> bool:
    import torch
    return isinstance(t, torch.Tensor) and t.dtype == torch.float32


def _moved(t, device, dtype=None):
    """``t`` on ``device`` (cast to ``dtype``) with its strides and storage
    offset: its whole storage moved, so an op sees the layout it saw."""
    import torch

    n = t.untyped_storage().nbytes() // t.element_size()
    base = torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage(), 0, (n,), (1,))
    return base.to(device, dtype or t.dtype).as_strided(
        t.shape, t.stride(), t.storage_offset())


def exact_mode(kinds):
    """A dispatch mode under which every out-of-place op of ``kinds`` on
    float32 tensors runs in float64 on the same device and rounds once
    to float32: a correctly rounded float32 op in place of the device's
    own (``calls`` counts them by op)."""
    from collections import Counter

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    class Exact(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if (_kind(func) not in kinds or name.endswith("_")
                    or "out" in kwargs or "dtype" in kwargs
                    or not any(map(_is_f32, args))):
                return func(*args, **kwargs)
            self.calls[name] += 1
            up = tree_map(lambda t: t.double() if _is_f32(t) else t,
                          (args, kwargs))
            out = func(*up[0], **up[1])
            return tree_map(lambda t: t.float() if isinstance(
                t, torch.Tensor) and t.dtype == torch.float64 else t, out)

    return Exact()


def _local(got, want, S: int) -> dict:
    """``got``'s distance from ``want``: over the whole tensor (``all``,
    max|Δ| / max|want|), and where a dim has size ``S`` (the positions),
    at positions 0 and 1 and the largest over the others (``s0``, ``s1``,
    ``rest``), each over that position's slice and divided by that
    slice's max|want| (the tensor's where it is 0)."""
    import torch

    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max()) or 1.0
    diff = (got - want).abs()
    out = {"all": float(diff.max()) / scale if diff.numel() else 0.0}
    if S in want.shape and want.dim() > 1:
        d = list(want.shape).index(S)
        w = want.movedim(d, 0).reshape(S, -1).abs().amax(1)
        e = diff.movedim(d, 0).reshape(S, -1).amax(1)
        loc = e / torch.where(w > 0, w, torch.full_like(w, scale))
        out.update(s0=float(loc[0]), s1=float(loc[1]),
                   rest=float(loc[2:].max()))
    return out


def _shadow_mode(card_dev, S: int):
    """A dispatch mode for a float32 run on the CPU: each op of ``_kind``
    is run again on the same inputs (same layout) on the card in float32
    and in float64, and each float32 output of the CPU and of the card is
    measured against the float64 one (:func:`_local`), as ``rows``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves, tree_map

    def floats(out):
        return [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                and t.is_floating_point()]

    class Shadow(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            mine = floats(out)
            if (_kind(func) is None or name.endswith("_") or "out" in kwargs
                    or not mine or not all(map(_is_f32, mine))):
                return out

            def on(dtype):
                return tree_map(lambda t: _moved(
                    t, card_dev, dtype if t.is_floating_point() else None)
                    if isinstance(t, torch.Tensor) else t, (args, kwargs))
            a32, a64 = on(None), on(torch.float64)
            card = floats(func(*a32[0], **a32[1]))
            f64 = floats(func(*a64[0], **a64[1]))
            for i, (c, g, w) in enumerate(zip(mine, card, f64)):
                self.rows.append(dict(
                    op=name, call=len(self.rows), out=i,
                    shape=list(c.shape), cpu=_local(c, w, S),
                    card=_local(g, w, S),
                    bits_equal=bool(torch.equal(c, g.cpu()))))
            return out

    return Shadow()


def _fault_wkv(fault: str):
    """A wkv whose forward is ``ops.wkv_chunk`` (the kernel on the card)
    and whose backward is ``WkvChunk``'s with the planted ``fault`` of
    :data:`FAULTS`."""
    import torch

    from repro_torch.kernels import ops, ref

    class Faulty(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, logw, u, state):
            ctx.save_for_backward(r, k, v, logw, u, state)
            return ops.wkv_chunk(r, k, v, logw, u, state)

        @staticmethod
        def backward(ctx, g_out, g_state):
            ins = [t.detach() for t in ctx.saved_tensors]
            if fault == "wkv_bwd_bf16":
                ins[:4] = [t.bfloat16().float() for t in ins[:4]]
            ins = [t.requires_grad_() for t in ins]
            with torch.enable_grad():
                out, final = ref.wkv_chunked_ref(*ins)
                grads = list(torch.autograd.grad((out, final), ins,
                                                 (g_out, g_state)))
            if fault == "wkv_dlogw_1e-3":
                grads[3] = grads[3] * (1 + 1e-3)
            return tuple(grads)

    return Faulty.apply


#: the step's float32 GEMM shapes (M, K, N) at (1, 512): the r/k/v/g and
#: ``wo`` projections, the channel mix's two, the loss head's logits
GEMM_SHAPES = ((512, 2560, 2560), (512, 2560, 8960), (512, 8960, 2560),
               (512, 2560, 65536))


def _bmm_as_mm_mode():
    """A dispatch mode under which a ``bmm`` of one batch runs as ``mm``
    (``einsum("bsd,de->bse")`` lowers to ``bmm`` of batch 1)."""
    from collections import Counter

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class AsMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if (func is torch.ops.aten.bmm.default and not kwargs
                    and args[0].shape[0] == 1):
                self.calls["bmm"] += 1
                return torch.mm(args[0][0], args[1][0])[None]
            return func(*args, **kwargs)

    return AsMM()


def gemm_paths(seed: int = 0, device: str = "cuda",
               shapes=GEMM_SHAPES) -> dict:
    """Each float32 GEMM of :data:`GEMM_SHAPES` on seeded inputs (x of
    N(0, 1), w of N(0, 1/K)) by each call path on the card and on the
    CPU, against the product in float64 on the card: max|Δ| / max|ref|
    (``max``) and mean|Δ| / mean|ref| (``mean``). Paths: ``einsum`` (the
    port's ``"bsd,de->bse"``, a ``bmm`` of batch 1), ``mm`` and
    ``linear`` (``F.linear`` on the transposed weight)."""
    import torch
    import torch.nn.functional as F

    dev, cpu = torch.device(device), torch.device("cpu")
    gen = torch.Generator().manual_seed(seed + 23)
    out = {}
    for M, K, N in shapes:
        x = torch.randn(M, K, generator=gen)
        w = torch.randn(K, N, generator=gen) / K ** 0.5
        ref = (x.to(dev, torch.float64) @ w.to(dev, torch.float64)).cpu()
        paths = {
            "einsum": lambda a, b: torch.einsum("bsd,de->bse", a[None],
                                                b)[0],
            "mm": torch.mm,
            "linear": lambda a, b: F.linear(a, b.t().contiguous()),
        }
        row = {}
        for side, d in (("card", dev), ("cpu", cpu)):
            for name, fn in paths.items():
                got = fn(x.to(d), w.to(d)).double().cpu()
                diff = (got - ref).abs()
                row[f"{side}_{name}"] = dict(
                    max=float(diff.max() / ref.abs().max()),
                    mean=float(diff.mean() / ref.abs().mean()))
        out[f"{M}x{K}x{N}"] = row
    return out


def bound_readings(seeds=(0, 1, 2, 3, 4), device: str = "cuda", cfg=None,
                   batch=(1, 512)) -> dict:
    """The readings that set chip_smoke's (1, 512) bounds (phase 13b), per
    seed (the weights and the batch drawn from it), each the worst leaf's
    max|Δ| / max|float64 leaf| against the float64 gradients (the plain
    wkv on the card): the CPU's step (``cpu``) and with every parameter
    changed in its last bit (``cpu_perturbed``); the card's (the kernel;
    ``card``, ``card_perturbed``); the card's with every GEMM correctly
    rounded (:func:`exact_mode`, ``card_exact_gemm``); and the planted
    faults of :data:`FAULTS` on the card, as it runs and with its GEMMs
    correctly rounded (``<fault>``, ``<fault>_exact_gemm``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map

    if cfg is None:
        full = get_config("rwkv6-3b")
        cfg = dataclasses.replace(full, num_layers=LAYERS,
                                  dtype=torch.float32)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    dev, cpu_dev = torch.device(device), torch.device("cpu")
    B, S = batch
    out = {}
    for seed in seeds:
        gen = torch.Generator(device=dev).manual_seed(seed + 14)
        params = tree_map(lambda t: t.float().cpu(),
                          M.init_params(cfg, gen, dev))
        b = TokenDataset(cfg.vocab_size, S, seed=seed).shard_batch(0, B)
        f64 = _grads(params, cfg64, b, dev, torch.float64, "ref")

        def worst(p, d, impl="auto", mode=None):
            g = _grads(p, cfg, b, d, torch.float32, impl, mode=mode)
            return max(_rel(g["grads"][k], w)
                       for k, w in f64["grads"].items())

        noise = torch.Generator().manual_seed(seed + 99)
        pert = tree_map(lambda t: t * (1 + 2.0 ** -24 * torch.randn(
            t.shape, generator=noise)), params)
        row = dict(cpu=worst(params, cpu_dev),
                   cpu_perturbed=worst(pert, cpu_dev),
                   card=worst(params, dev),
                   card_perturbed=worst(pert, dev),
                   card_exact_gemm=worst(params, dev,
                                         mode=exact_mode({"gemm"})))
        for f in FAULTS:
            row[f] = worst(params, dev, _fault_wkv(f))
            row[f + "_exact_gemm"] = worst(params, dev, _fault_wkv(f),
                                           exact_mode({"gemm"}))
        out[str(seed)] = row
    return out


def attribute(seed: int = 0, device: str = "cuda", cfg=None,
              batch=(1, 512)) -> dict:
    """Where the card's float32 gradients at ``batch`` part from float64
    more than the CPU's (ROADMAP F14), by three readings, each leaf's
    distance max|Δ| / max|float64 leaf| (the plain wkv on the card in
    float64 the arbiter, as in :func:`train_cpu_gap`):

    - ``exact``: the step with every GEMM (``gemm``), every pointwise op
      and reduction (``other``) or both (``all``) computed in float64 and
      rounded once to float32, on each side, beside each side's own
      (``native``; the plain wkv, so every op is an aten op): ``all`` is
      a correctly rounded float32 step, the model's own conditioning;
      and the card's with every ``bmm`` of one batch run as ``mm``
      (``card_bmm_as_mm``);
    - ``ops``: every op of the CPU's float32 step (forward and backward)
      run again on the same inputs on the card in float32 and in float64:
      each side's output against float64 over the tensor and at
      positions 0 and 1 (:func:`_local`), in ``by_op`` gathered by op;
    - ``chain``: each activation and its gradient along the step, each
      side against float64 at positions 0 and 1;
    - ``faults``: the card's float32 step (the kernel) with each planted
      fault of :data:`FAULTS`.
    """
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map

    if cfg is None:
        full = get_config("rwkv6-3b")
        cfg = dataclasses.replace(full, num_layers=LAYERS,
                                  dtype=torch.float32)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    dev, cpu_dev = torch.device(device), torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    params = tree_map(lambda t: t.float().cpu(), M.init_params(cfg, gen, dev))
    B, S = batch
    b = TokenDataset(cfg.vocab_size, S, seed=seed).shard_batch(0, B)
    f64 = _grads(params, cfg64, b, dev, torch.float64, "ref", True)

    def dist(side):
        return {k: _rel(side["grads"][k], w) for k, w in f64["grads"].items()}

    exact, calls = {}, {}
    for side, d in (("card", dev), ("cpu", cpu_dev)):
        exact[f"{side}_native"] = dist(_grads(params, cfg, b, d,
                                              torch.float32, "ref"))
        for kinds in (("gemm",), ("other",), ("gemm", "other")):
            tag = "all" if len(kinds) == 2 else kinds[0]
            mode = exact_mode(set(kinds))
            exact[f"{side}_exact_{tag}"] = dist(_grads(
                params, cfg, b, d, torch.float32, "ref", mode=mode))
            calls[f"{side}_exact_{tag}"] = dict(mode.calls)
    as_mm = _bmm_as_mm_mode()
    exact["card_bmm_as_mm"] = dist(_grads(params, cfg, b, dev,
                                          torch.float32, "ref", mode=as_mm))
    calls["card_bmm_as_mm"] = dict(as_mm.calls)
    faults = {f: dist(_grads(params, cfg, b, dev, torch.float32,
                             _fault_wkv(f))) for f in FAULTS}
    shadow = _shadow_mode(dev, S)
    cpu = _grads(params, cfg, b, cpu_dev, torch.float32, "ref", True,
                 mode=shadow)
    card = _grads(params, cfg, b, dev, torch.float32, "ref", True)
    chain = {f"{kind}:{k}": dict(card=_local(card[kind][k], w, S),
                                 cpu=_local(cpu[kind][k], w, S))
             for kind in ("acts", "act_grads")
             for k, w in f64[kind].items() if k in card[kind]}
    by_op = {}
    for row in shadow.rows:
        by_op.setdefault(row["op"], []).append(row)

    def ratio(row, key):
        c, h = row["card"].get(key), row["cpu"].get(key)
        return None if c is None or not h else c / h

    by_op = {op: dict(
        calls=len(rows), bits_equal=sum(r["bits_equal"] for r in rows),
        card_all_max=max(r["card"]["all"] for r in rows),
        cpu_all_max=max(r["cpu"]["all"] for r in rows),
        card_over_cpu_all_median=statistics.median(
            [x for x in (ratio(r, "all") for r in rows) if x is not None]
            or [float("nan")]),
        card_s01_max=max((max(r["card"].get("s0", 0), r["card"].get("s1", 0))
                          for r in rows), default=0.0),
        cpu_s01_max=max((max(r["cpu"].get("s0", 0), r["cpu"].get("s1", 0))
                         for r in rows), default=0.0))
        for op, rows in by_op.items()}

    def s01(side):
        return max(side.get("s0", 0.0), side.get("s1", 0.0))

    top = sorted((r for r in shadow.rows if s01(r["card"]) > 1e-6),
                 key=lambda r: s01(r["card"]) / max(s01(r["cpu"]), 1e-12),
                 reverse=True)[:40]
    return dict(batch=list(batch), exact=exact, exact_calls=calls,
                worst={k: max(v.values()) for k, v in
                       {**exact, **faults}.items()},
                faults=faults, chain=chain, by_op=by_op, top_ops=top,
                rows=shadow.rows)


def summary(rec: dict) -> dict:
    """Per batch: the worst leaf of each gradient distance; per op the
    largest of each distance over its tensors."""
    out = {}
    for key, r in rec.items():
        if key in ("gemm_paths", "bound_readings"):
            out[key] = r
            continue
        if key == "attribution":
            out[key] = dict(worst=r["worst"], by_op=r["by_op"],
                            top_ops=r["top_ops"][:12])
            continue
        ops_ = {name: {d: max(t[d] for t in v.values())
                       for d in next(iter(v.values())) if d != "where"}
                for name, v in r["ops"].items()}
        fwd = {name: v for name, v in r["forward"].items()}
        out[key] = dict(loss=r["loss"], grad_norm=r["grad_norm"],
                        worst=r["worst"], ops=ops_, forward=fwd)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "train_cpu_gap.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_cpu_gap: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.kernels import _build
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = train_cpu_gap()
    rec["attribution"] = attribute()
    rec["gemm_paths"] = gemm_paths()
    rec["bound_readings"] = bound_readings()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(summary(rec)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
