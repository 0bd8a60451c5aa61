"""The port's cross-attention (``layers.cross_attention``, the vlm and audio
families' conditioning path) against ``repro.models.layers``, on the CPU.

The same seeded float32 inputs and parameters go to both packages. The
cross block's ``gate`` initialises to zero (``tanh(0) = 0`` silences the
block), so the tests draw it nonzero: a wrong cross path would otherwise
pass. Tolerance: ``max|Δ| / (max|reference| + 1)`` < ``LAYER_BOUND`` =
1e-6, the bound of the dense layers (float32 sums in other orders;
measured ≤ 1.6e-7).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.params import materialize

LAYER_BOUND = 1e-6


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1.0))


def _configs(arch: str, **kw):
    return (dataclasses.replace(jax_get_config(arch + "-smoke"), **kw),
            dataclasses.replace(get_config(arch + "-smoke"), **kw))


def _params(cfg, seed, cross=True, gate=0.7):
    p = materialize(L.attn_defs(cfg, cross=cross),
                    torch.Generator().manual_seed(seed), "cpu",
                    dtype_override=torch.float32)
    if cross:
        p["gate"] = torch.tensor(gate, dtype=torch.float32)
    return p


@pytest.mark.parametrize("n,chunk", [(8, 32), (40, 16), (37, 16)],
                         ids=["one_chunk", "chunks", "padded"])
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large"],
                         ids=["gqa", "mha"])
def test_cross_attention_with_a_gate_matches_jax(arch, n, chunk):
    jcfg, cfg = _configs(arch, attn_chunk=chunk)
    p = _params(cfg, n)
    rng = np.random.default_rng(n + chunk)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(2, n, cfg.num_kv_heads, cfg.head_dim)).astype(
        np.float32) for _ in range(2))
    jp = {key: jnp.asarray(t.numpy()) for key, t in p.items()}
    want = JL.cross_attention(jp, jcfg, jnp.asarray(x),
                              (jnp.asarray(k), jnp.asarray(v)))
    got = L.cross_attention(p, cfg, torch.from_numpy(x),
                            (torch.from_numpy(k), torch.from_numpy(v)))
    assert got.shape == (2, 5, cfg.d_model)
    assert _rel(got, want) < LAYER_BOUND
    # the gate scales the block: tanh(0.7) of the ungated output
    ungated = L.cross_attention({key: t for key, t in p.items()
                                 if key != "gate"}, cfg,
                                torch.from_numpy(x),
                                (torch.from_numpy(k), torch.from_numpy(v)))
    assert torch.allclose(got, np.tanh(0.7) * ungated, rtol=1e-5, atol=1e-6)


def test_cross_attention_without_a_gate_matches_jax():
    """musicgen's per-layer cross-attention has no gate."""
    jcfg, cfg = _configs("musicgen-large")
    p = _params(cfg, 3, cross=False)
    assert "gate" not in p
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 3, cfg.d_model)).astype(np.float32)
    cond = rng.normal(size=(1, 8, cfg.d_model)).astype(np.float32)
    jp = {key: jnp.asarray(t.numpy()) for key, t in p.items()}
    jk, jv = JL.attn_project_kv(jp, jcfg, jnp.asarray(cond), None, rope=False)
    k, v = L.attn_project_kv(p, cfg, torch.from_numpy(cond), None, rope=False)
    assert _rel(k, jk) < LAYER_BOUND and _rel(v, jv) < LAYER_BOUND
    want = JL.cross_attention(jp, jcfg, jnp.asarray(x), (jk, jv))
    got = L.cross_attention(p, cfg, torch.from_numpy(x), (k, v))
    assert _rel(got, want) < LAYER_BOUND


def test_the_gate_is_a_zero_float32_scalar_that_silences_the_block():
    jcfg, cfg = _configs("llama-3.2-vision-11b")
    d, jd = L.attn_defs(cfg, cross=True), JL.attn_defs(jcfg, cross=True)
    assert set(d) == set(jd) == {"wq", "wk", "wv", "wo", "gate"}
    assert d["gate"].shape == () and d["gate"].dtype == torch.float32
    assert d["gate"].init == jd["gate"].init == "zeros"
    assert "gate" not in L.attn_defs(cfg)
    p = materialize(d, torch.Generator().manual_seed(0), "cpu",
                    dtype_override=torch.float32)
    assert p["gate"].shape == () and float(p["gate"]) == 0.0
    x = torch.randn((1, 4, cfg.d_model))
    kv = (torch.randn((1, 8, cfg.num_kv_heads, cfg.head_dim)),) * 2
    assert bool((L.cross_attention(p, cfg, x, kv) == 0).all())


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large"])
def test_forward_needs_cond(arch):
    cfg = get_config(arch + "-smoke")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="cond"):
        M.forward(params, cfg, torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("layers,blocks", [(4, 2), (5, 2), (2, 1), (1, 0)])
def test_vlm_cross_blocks_follow_the_reference(layers, blocks):
    """num_layers // cross_attn_every blocks (the reduced cadence is 2):
    the parameter and cache trees equal the reference's."""
    jcfg, cfg = _configs("llama-3.2-vision-11b", num_layers=layers)
    defs = M.model_defs(cfg)
    assert defs["cross"]["xattn"]["gate"].shape == (blocks,)
    assert M.param_count(cfg) == JM.param_count(jcfg)
    cache = M.cache_defs(cfg, 2, 16)
    jcache = JM.cache_defs(jcfg, 2, 16)
    assert {k: d.shape for k, d in cache.items()} == \
        {k: d.shape for k, d in jcache.items()}
    assert cache["cross_k"].shape == (blocks, 2, cfg.n_cross_tokens,
                                      cfg.num_kv_heads, cfg.head_dim)
