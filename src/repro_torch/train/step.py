"""The train step: loss → grads (microbatched) → AdamW, a copy of
``repro.train.step``.

``make_train_step(cfg, tc)`` returns ``step(state, batch) -> (state,
metrics)``, which runs eagerly and updates the state's parameters and
moments in place (``train.optim``). The gradient of each microbatch comes
from ``torch.autograd.grad`` and is summed into float32 buffers, then
scaled by ``1/k``, as the reference's ``lax.scan`` sums it (letting
``.grad`` accumulate would sum in bf16). ``int8_ef`` compression sits
between the gradient and the update.

``abstract_train_state`` builds the state as meta tensors, and
``state_shardings`` / ``batch_shardings`` give the policy's DTensor
placements (``repro_torch.sharding``): the dry run (``launch.dryrun``)
counts the step on them, and under a mesh of ranks (``sharding.set_mesh``
over ``launch.mesh.make_local_mesh``) :func:`init_train_state` lays the
state out by them and the step runs on DTensors, its collectives issued
by DTensor.
"""
from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch.comms.compress import ef_compress, ef_init
from repro_torch.models import model as M
from repro_torch.models.params import (ParamDef, abstractify, tree_defs,
                                       tree_map)
from repro_torch.train.optim import (TrainConfig, adamw_update, init_opt,
                                     opt_defs)

__all__ = [
    "train_state_defs",
    "init_train_state",
    "abstract_train_state",
    "make_train_step",
    "batch_defs",
    "loss_and_grads",
    "state_shardings",
    "batch_shardings",
]


def train_state_defs(cfg, tc: TrainConfig) -> dict:
    pdefs = M.model_defs(cfg)
    d = {"params": pdefs, "opt": opt_defs(pdefs)}
    if tc.compress == "int8_ef":
        d["ef"] = tree_map(
            lambda x: ParamDef(x.shape, x.logical, torch.float32, "zeros"),
            pdefs)
    return d


def init_train_state(cfg, tc: TrainConfig, generator: torch.Generator,
                     device="cuda") -> dict:
    """Parameters drawn from ``generator`` (on ``device``), zero moments
    and, with ``int8_ef``, a zero residual. Under a mesh of more than one
    device (``sharding.set_mesh``) every leaf is a DTensor laid out by
    :func:`state_shardings`, its values those of the one-device draw
    (``params.materialize``)."""
    params = M.init_params(cfg, generator, device)
    state = {"params": params, "opt": init_opt(params)}
    if tc.compress == "int8_ef":
        state["ef"] = ef_init(params)
    mesh = shd.current_mesh()
    if mesh is not None and mesh.size() > 1:
        state = shd.lay_out_tree(state, state_shardings(cfg, tc, mesh), mesh)
    return state


def abstract_train_state(cfg, tc: TrainConfig) -> dict:
    """The train state as meta tensors (``params.abstractify``)."""
    return abstractify(train_state_defs(cfg, tc))


def batch_defs(cfg, global_batch: int, seq_len: int) -> dict:
    d = {
        "tokens": ParamDef((global_batch, seq_len), ("batch", "seq"),
                           dtype=torch.int32),
        "labels": ParamDef((global_batch, seq_len), ("batch", "seq"),
                           dtype=torch.int32),
    }
    if cfg.family in ("vlm", "audio"):
        d["cond"] = ParamDef(
            (global_batch, cfg.n_cross_tokens, cfg.d_model),
            ("batch", "", "embed"), dtype=cfg.dtype)
    return d


def loss_and_grads(params, cfg, batch):
    """``(loss, grads)`` of ``M.lm_loss`` at ``params``: the gradients in
    each parameter's dtype, a tree like ``params``; the loss detached.
    Differentiates detached aliases of the parameters, so their own
    ``requires_grad`` stays as it is."""
    paths, leaves = zip(*((path, p.detach().requires_grad_())
                          for path, p in tree_defs(params)))
    with torch.enable_grad():
        loss = M.lm_loss(_unflatten(paths, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _unflatten(paths, grads)


def _unflatten(paths, leaves) -> dict:
    """Nested dicts from ``tree_defs``' paths and their leaves."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def _accumulate(a, b) -> None:
    """``a += b`` in float32, in place; a DTensor gradient that comes back
    in other placements than its buffer is first redistributed to them."""
    a.add_(shd.placed_like(b.float(), a))


def make_train_step(cfg, tc: TrainConfig):
    """Returns ``step(state, batch) -> (state, metrics)``: ``state`` as
    :func:`init_train_state` builds it (updated in place and returned in a
    new dict), ``batch`` as :func:`batch_defs` lays it out, on the
    state's device."""

    def grads_of(params, batch):
        k = tc.microbatches
        if k <= 1:
            return loss_and_grads(params, cfg, batch)
        B = next(iter(batch.values())).shape[0]
        if B % k:
            raise ValueError(f"a batch of {B} does not split into {k} "
                             "microbatches")
        n = B // k
        loss_acc = 0.0
        # float32 buffers on each parameter's device (and placements)
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        for j in range(k):
            mb = {key: shd.constrain(x[j * n:(j + 1) * n], "batch",
                                     *("",) * (x.ndim - 1))
                  for key, x in batch.items()}
            loss, g = loss_and_grads(params, cfg, mb)
            tree_map(_accumulate, acc, g)
            loss_acc = loss_acc + loss
            del g
        inv = 1.0 / k
        tree_map(lambda a: a.mul_(inv), acc)
        return loss_acc * inv, acc

    def step(state, batch):
        loss, grads = grads_of(state["params"], batch)
        new_state = dict(state)
        if tc.compress == "int8_ef":
            grads, new_state["ef"] = ef_compress(grads, state["ef"])
        params, opt, metrics = adamw_update(tc, state["params"], grads,
                                            state["opt"])
        new_state["params"], new_state["opt"] = params, opt
        metrics["loss"] = loss
        return new_state, metrics

    return step


def state_shardings(cfg, tc: TrainConfig, mesh):
    return shd.param_specs(train_state_defs(cfg, tc), mesh)


def batch_shardings(cfg, global_batch: int, seq_len: int, mesh):
    return shd.param_specs(batch_defs(cfg, global_batch, seq_len), mesh)
