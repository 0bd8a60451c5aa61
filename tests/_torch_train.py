"""Shared pieces of the port's training tests (``test_torch_train*.py``):
one parameter tree for both packages, drawn by the port's init rules from a
seeded ``torch.Generator`` and carried into ``repro`` as numpy (bf16 →
float32 → bf16 is exact), batches from the port's ``TokenDataset``, and
the bounds the step tests state.

Bounds, measured on the six families' reduced configs (float32 compute,
bf16 parameters; the reference under ``jax.jit`` on the CPU):
- the loss within ``LOSS_REL`` (1e-6) of the reference's, relative (the
  worst measured 1.7e-7);
- each gradient element (bf16, the parameter's dtype) within one bf16
  step of the reference's, ``|Δ| ≤ 2^-7·|ref| + atol·max|ref leaf|``:
  both sum in float32 in other orders, and a last-bit difference can
  round a bf16 gradient one step apart; ``atol`` is ``GRAD_ATOL`` (2e-5;
  measured 6.3e-6: an element that cancels to a small share of its leaf)
  and ``SUMMED_GRAD_ATOL`` (2e-3; measured 1.15e-3) for the leaves whose
  gradient both packages sum in bf16 over many uses, in other orders:
  the embedding table (every token) and zamba2's shared block (every
  group);
- each updated parameter (bf16) within one bf16 step, ``|Δ| ≤ 2^-7·|ref|
  + PARAM_ATOL·max|ref leaf|`` (1e-6: an element near 0; measured
  9.5e-8), and at most ``PARAM_DIFF_SHARE`` (1e-3) of the elements apart
  at all (measured: at most 14 of 254,784).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.models.params import ParamDef as JParamDef
from repro_torch.configs import get_config
from repro_torch.data import TokenDataset
from repro_torch.models import model as M
from repro_torch.models.params import tree_defs, tree_map
from repro_torch.models.weights import params_from_numpy

FAMILY_ARCHS = {"dense": "gemma-2b", "moe": "mixtral-8x7b",
                "ssm": "rwkv6-3b", "hybrid": "zamba2-1.2b",
                "vlm": "llama-3.2-vision-11b", "audio": "musicgen-large"}
LOSS_REL = 1e-6
BF16_REL = 2.0 ** -7
GRAD_ATOL = 2e-5
SUMMED_GRAD_ATOL = 2e-3
SUMMED = ("embed/", "shared/")
PARAM_ATOL = 1e-6
PARAM_DIFF_SHARE = 1e-3


def carried(arch: str, seed: int = 0, **changes):
    """(repro's config, params; the port's config, params) on one tree."""
    name = arch + "-smoke"
    jcfg = dataclasses.replace(jax_get_config(name), **changes)
    cfg = dataclasses.replace(get_config(name), **changes)
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    tree = tree_map(lambda t: t.float().numpy(), params)
    if "cross" in tree:  # the vlm's gates start at 0: draw them nonzero
        gate = tree["cross"]["xattn"]["gate"]
        tree["cross"]["xattn"]["gate"] = np.random.default_rng(
            seed).normal(size=gate.shape).astype(np.float32)
        params = params_from_numpy(tree, cfg, "cpu")
    jparams = jax.tree_util.tree_map(
        lambda d, a: jnp.asarray(a, d.dtype), JM.model_defs(jcfg), tree,
        is_leaf=lambda x: isinstance(x, JParamDef))
    return jcfg, jparams, cfg, params


def batch(cfg, B: int = 4, S: int = 32, seed: int = 1) -> dict:
    """numpy tokens and labels (and a random ``cond`` for vlm/audio)."""
    b = TokenDataset(cfg.vocab_size, S, seed=seed).shard_batch(0, B)
    if cfg.family in ("vlm", "audio"):
        b["cond"] = np.random.default_rng(seed).normal(
            size=(B, cfg.n_cross_tokens, cfg.d_model)).astype(np.float32)
    return b


def to_torch(b: dict, device="cpu") -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def leaves(tree) -> dict:
    """``{"a/b": float64 numpy}`` of a torch tree (sorted key paths)."""
    return {"/".join(p): t.detach().double().numpy()
            for p, t in tree_defs(tree)}


def jax_leaves(tree) -> dict:
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[key] = np.asarray(jnp.asarray(a, jnp.float32), np.float64)
    return out


def assert_bf16_close(got: dict, want: dict, atol: float,
                      summed_atol: float | None = None,
                      what: str = "") -> int:
    """Each element within one bf16 step (+ ``atol``·max|leaf|, or
    ``summed_atol`` on the :data:`SUMMED` leaves) of the reference's;
    returns how many elements differ at all."""
    assert set(got) == set(want), what
    apart = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        a = summed_atol if (summed_atol is not None
                            and k.startswith(SUMMED)) else atol
        lim = BF16_REL * np.abs(w) + a * np.abs(w).max()
        assert (d <= lim).all(), (what, k, float((d - lim).max()))
        apart += int((d > 0).sum())
    return apart


def check_step(arch: str, microbatches: int = 1) -> None:
    """One train step from one carried state in both packages: the loss,
    every gradient (``microbatches`` 1 only: the reference's accumulated
    gradients are not returned) and every updated parameter within the
    bounds above."""
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import make_train_step as jax_make_train_step
    from repro.train.optim import init_opt as jax_init_opt
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.optim import init_opt
    from repro_torch.train.step import loss_and_grads

    jcfg, jparams, cfg, params = carried(arch)
    b = batch(cfg)
    jb, tb = to_jax(b), to_torch(b)
    tc = dict(lr=1e-3, warmup_steps=2, total_steps=10,
              microbatches=microbatches)
    jstep = jax_make_train_step(jcfg, JTrainConfig(**tc))

    def ref(state, bb):
        vg = jax.value_and_grad(lambda p: JM.lm_loss(p, jcfg, bb))
        return vg(state["params"]), jstep(state, bb)

    (jloss, jgrads), (jnew, jm) = jax.jit(ref)(
        {"params": jparams, "opt": jax_init_opt(jparams)}, jb)
    if microbatches == 1:
        loss, grads = loss_and_grads(params, cfg, tb)
        assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(
            float(jloss))
        assert_bf16_close(leaves(grads), jax_leaves(jgrads), GRAD_ATOL,
                          SUMMED_GRAD_ATOL, "grads")
    new, m = make_train_step(cfg, TrainConfig(**tc))(
        {"params": params, "opt": init_opt(params)}, tb)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_REL * abs(
        float(jm["loss"]))
    want = jax_leaves(jnew["params"])
    apart = assert_bf16_close(leaves(new["params"]), want, PARAM_ATOL,
                              what="params")
    assert apart <= PARAM_DIFF_SHARE * sum(w.size for w in want.values())
    assert int(new["opt"]["count"]) == int(jnew["opt"]["count"]) == 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Reduced configs run faster on one intra-op thread, and the tier-1
    run's xdist workers share the machine's cores: each module of the
    training tests runs torch on one thread and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
