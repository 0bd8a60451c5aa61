"""The port's top-k expert FFN (``repro_torch.models.moe``) against
``repro.models.moe``, on the CPU.

The same seeded float32 inputs and parameters go to both packages.
Tolerance for ``out`` and ``aux``: ``max|Δ| / (max|reference| + 1)`` <
``MOE_BOUND`` = 1e-6 (float32 matmuls summed in other orders; measured
≤ 3.9e-7). The dispatch itself (which slot each assignment takes, which are
dropped) is integer work and must be equal: the tests hold it through
inputs whose dispatch drops assignments, through exact ties in the router
(lower expert index first, ``jax.lax.top_k``'s order) and through
``capacity_factor`` values whose C rounds half to even.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as JMoE
from repro_torch.configs import get_config
from repro_torch.models import moe as MoE
from repro_torch.models.params import materialize

MOE_BOUND = 1e-6


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1.0))


def _configs(**kw):
    return (dataclasses.replace(jax_get_config("mixtral-8x7b-smoke"), **kw),
            dataclasses.replace(get_config("mixtral-8x7b-smoke"), **kw))


def _params(cfg, seed):
    return materialize(MoE.moe_defs(cfg), torch.Generator().manual_seed(seed),
                       "cpu", dtype_override=torch.float32)


def _both(p, jcfg, cfg, x):
    want = JMoE.moe_apply({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                          jcfg, jnp.asarray(x))
    got = MoE.moe_apply(p, cfg, torch.from_numpy(x))
    return got, want


def _dropped(cfg, p, x) -> int:
    """How many top-k assignments overflow their expert's C slots."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = max(1, int(round(cfg.capacity_factor * S * K / E)))
    _, top_e = MoE.top_k(torch.softmax(MoE.router_logits(
        p, torch.from_numpy(x)), -1), K)
    counts = torch.nn.functional.one_hot(top_e.reshape(B, -1), E).sum(1)
    return int(torch.clamp(counts - C, min=0).sum())


@pytest.mark.parametrize("S", [1, 7, 37, 64])
@pytest.mark.parametrize("experts", [(4, 2), (8, 2), (4, 1)],
                         ids=["4e_top2", "8e_top2", "4e_top1"])
def test_moe_apply_matches_jax(experts, S):
    E, K = experts
    jcfg, cfg = _configs(num_experts=E, num_experts_per_tok=K)
    p = _params(cfg, S + E)
    # a scaled router and a component shared by all tokens make the
    # assignments uneven, so long sequences overflow some experts
    p["router"] *= 8
    rng = np.random.default_rng(S)
    x = (rng.normal(size=(3, S, cfg.d_model))
         + rng.normal(size=cfg.d_model)).astype(np.float32)
    (out, aux), (jout, jaux) = _both(p, jcfg, cfg, x)
    assert out.shape == (3, S, cfg.d_model)
    assert _rel(out, jout) < MOE_BOUND
    assert abs(float(aux) - float(jaux)) < MOE_BOUND * (abs(float(jaux)) + 1)
    if S == 64:
        assert _dropped(cfg, p, x) > 0  # the overflow path is exercised


def test_ties_take_the_lower_expert_first_and_overflow_is_dropped():
    """A zero router gives every expert the same probability: the top-2
    are experts 0 and 1 for every token (jax.lax.top_k's order), so
    those two take the first C tokens each and drop the rest, and the
    other experts see nothing."""
    jcfg, cfg = _configs()
    p = _params(cfg, 1)
    p["router"].zero_()
    S = 40
    x = np.random.default_rng(2).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)
    (out, aux), (jout, jaux) = _both(p, jcfg, cfg, x)
    assert _rel(out, jout) < MOE_BOUND
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    vals, idx = MoE.top_k(torch.full((3, 4), 0.25), 2)
    assert idx.tolist() == [[0, 1]] * 3 and vals.tolist() == [[0.25] * 2] * 3
    C = max(1, int(round(cfg.capacity_factor * S * 2 / 4)))
    assert C == 25 and _dropped(cfg, p, x) == 2 * 2 * (S - C)
    # tokens past C get nothing from their (full) experts
    assert bool((out[:, C:] == 0).all()) and bool((out[:, :C] != 0).any())


def test_top_k_orders_like_jax_top_k_on_ties():
    rng = np.random.default_rng(3)
    probs = rng.choice([0.1, 0.2, 0.3], size=(50, 8)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    v, i = MoE.top_k(torch.from_numpy(probs), 3)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert np.array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("factor", [1.25, 0.625, 1.0])
def test_capacity_rounds_half_to_even(factor):
    """C = round(capacity_factor · S · K / E) with Python's round: at
    S = 4, K = 2, E = 4 the factors give 2.5 → 2, 1.25 → 1 and 2 → 2."""
    jcfg, cfg = _configs(capacity_factor=factor)
    p = _params(cfg, 5)
    p["router"] *= 8
    x = np.random.default_rng(5).normal(size=(4, 4, cfg.d_model)).astype(
        np.float32)
    (out, _), (jout, _) = _both(p, jcfg, cfg, x)
    assert _rel(out, jout) < MOE_BOUND


def test_router_runs_in_float32_under_bf16():
    """A bf16 model keeps its router (a float32 leaf) and the routing in
    float32; the experts run in bf16."""
    cfg = get_config("mixtral-8x7b-smoke")
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    defs = MoE.moe_defs(cfg16)
    assert defs["router"].dtype == torch.float32
    assert defs["wg"].dtype == torch.bfloat16
    p = materialize(defs, torch.Generator().manual_seed(6), "cpu")
    x = torch.randn((2, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    assert MoE.router_logits(p, x.bfloat16()).dtype == torch.float32
    out, aux = MoE.moe_apply(p, cfg16, x.bfloat16())
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32


def test_moe_runs_inside_a_profiler_range():
    cfg = get_config("mixtral-8x7b-smoke")
    p = _params(cfg, 8)
    x = torch.randn((1, 5, cfg.d_model))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        MoE.moe_apply(p, cfg, x)
    assert any(e.name == "moe" for e in prof.events())
