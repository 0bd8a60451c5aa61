"""The port's Mamba2 mixer (``repro_torch.models.mamba2``) against
``repro.models.mamba2``, on the CPU, and the reference's own Mamba2
properties (tests/test_sequence_mixers.py) on the port alone.

The same seeded float32 inputs and parameters go to both packages.
Tolerances, each as ``max|Δ| / (max|reference| + 1)``:

* ``mamba2_apply`` (output and final state), chunked as the reference
  chunks: ``SSD_BOUND`` = 2e-5, the model bound of the RWKV6 tests (a
  chunk's decays are exponentials of differences of float32 prefix sums,
  summed in other orders; measured ≤ 8.3e-7);
* ``mamba2_decode`` (output and every state): ``DECODE_BOUND`` = 1e-6
  (one step of float32 sums; measured ≤ 2.4e-7). The conv tails are
  the step's inputs, so they are equal.

The reference's properties keep their own bounds: the chunked form within
5e-3 of the token-by-token recurrence (relative to its largest value), and
the final state within 5e-3.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba2 as JMB
from repro_torch.configs import get_config
from repro_torch.models import mamba2 as MB
from repro_torch.models.params import materialize

SSD_BOUND = 2e-5
DECODE_BOUND = 1e-6


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1.0))


@pytest.fixture(scope="module")
def mixer():
    """zamba2-1.2b reduced (d_model 64, d_inner 128, 8 heads of 16, state
    16), float32 parameters with nonzero decays and biases."""
    jcfg = jax_get_config("zamba2-1.2b-smoke")
    cfg = get_config("zamba2-1.2b-smoke")
    p = materialize(MB.mamba2_defs(cfg), torch.Generator().manual_seed(0),
                    "cpu", dtype_override=torch.float32)
    rng = np.random.default_rng(0)
    for key in ("A_log", "dt_bias", "D_skip"):
        p[key] = torch.from_numpy(
            rng.normal(size=cfg.ssm_heads).astype(np.float32))
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    return jcfg, cfg, p, jp


def _x(cfg, B, S, seed):
    return 0.5 * np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _zero_state(cfg, B):
    return {
        "conv_x": torch.zeros((B, cfg.ssm_conv - 1, cfg.d_inner)),
        "conv_B": torch.zeros((B, cfg.ssm_conv - 1, cfg.ssm_state)),
        "conv_C": torch.zeros((B, cfg.ssm_conv - 1, cfg.ssm_state)),
        "ssm": torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state)),
    }


@pytest.mark.parametrize("S,chunk", [(128, 64), (48, 16), (37, 64), (5, 64),
                                     (100, 64)],
                         ids=["two_chunks", "three_chunks", "one_chunk",
                              "short", "fallback"])
def test_mamba2_apply_matches_jax(mixer, S, chunk):
    """S = 100 with chunks of 64 takes the reference's Q = S fallback."""
    jcfg, cfg, p, jp = mixer
    x = _x(cfg, 2, S, S)
    jout, jst = JMB.mamba2_apply(jp, jcfg, jnp.asarray(x), chunk=chunk,
                                 return_state=True)
    out, st = MB.mamba2_apply(p, cfg, torch.from_numpy(x), chunk=chunk,
                              return_state=True)
    assert out.shape == (2, S, cfg.d_model)
    assert _rel(out, jout) < SSD_BOUND
    assert set(st) == set(jst)
    for key in st:
        assert tuple(st[key].shape) == jst[key].shape, key
        assert st[key].dtype == torch.float32, key
        assert _rel(st[key], jst[key]) < SSD_BOUND, key
    none = MB.mamba2_apply(p, cfg, torch.from_numpy(x), chunk=chunk)[1]
    assert none is None


def test_mamba2_decode_matches_jax(mixer):
    """Three steps from a random state; each step's output and state."""
    jcfg, cfg, p, jp = mixer
    rng = np.random.default_rng(4)
    state = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
             for k, v in _zero_state(cfg, 3).items()}
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    x = _x(cfg, 3, 3, 5)
    for t in range(3):
        jout, jstate = JMB.mamba2_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                         jstate)
        out, state = MB.mamba2_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                                      state)
        assert out.shape == (3, 1, cfg.d_model)
        assert _rel(out, jout) < DECODE_BOUND
        for key in state:
            assert _rel(state[key], jstate[key]) < DECODE_BOUND, key


def test_state_defs_are_the_references(mixer):
    """Conv tails at ParamDef's bf16 default, the SSM state in float32."""
    jcfg, cfg, _, _ = mixer
    got, want = MB.mamba2_state_defs(cfg, 3), JMB.mamba2_state_defs(jcfg, 3)
    assert set(got) == set(want)
    for key, d in got.items():
        assert d.shape == want[key].shape and d.logical == want[key].logical
        assert str(d.dtype).split(".")[-1] == jnp.dtype(want[key].dtype).name
    assert got["ssm"].dtype == torch.float32
    assert got["conv_x"].dtype == torch.bfloat16
    defs, jdefs = MB.mamba2_defs(cfg), JMB.mamba2_defs(jcfg)
    assert {k: (d.shape, d.init, d.scale) for k, d in defs.items()} == \
        {k: (d.shape, d.init, d.scale) for k, d in jdefs.items()}


# --------------------------------------------------------------------------
# tests/test_sequence_mixers.py's Mamba2 cases, on the port
# --------------------------------------------------------------------------
def _mamba_sequential(p, cfg, x):
    """Naive per-step SSM recurrence oracle for mamba2_apply."""
    state = _zero_state(cfg, x.shape[0])
    outs = []
    for t in range(x.shape[1]):
        o, state = MB.mamba2_decode(p, cfg, x[:, t:t + 1], state)
        outs.append(o)
    return torch.cat(outs, dim=1)


def test_mamba2_chunked_matches_recurrence():
    cfg = get_config("zamba2-1.2b").reduced()
    p = materialize(MB.mamba2_defs(cfg), torch.Generator().manual_seed(0),
                    "cpu", dtype_override=torch.float32)
    x = torch.from_numpy(_x(cfg, 2, 48, 3))
    full, _ = MB.mamba2_apply(p, cfg, x, chunk=16)
    step = _mamba_sequential(p, cfg, x)
    scale = float(full.abs().max()) + 1e-3
    assert float((full - step).abs().max()) / scale < 5e-3


def test_mamba2_final_state_matches_decode_state():
    cfg = get_config("zamba2-1.2b").reduced()
    p = materialize(MB.mamba2_defs(cfg), torch.Generator().manual_seed(1),
                    "cpu", dtype_override=torch.float32)
    x = torch.from_numpy(_x(cfg, 1, 32, 8))
    _, st_full = MB.mamba2_apply(p, cfg, x, chunk=8, return_state=True)
    # replay the same tokens through decode; final ssm states must agree
    state = _zero_state(cfg, 1)
    for t in range(32):
        _, state = MB.mamba2_decode(p, cfg, x[:, t:t + 1], state)
    assert float((state["ssm"] - st_full["ssm"]).abs().max()) < 5e-3
    for key in ("conv_x", "conv_B", "conv_C"):
        assert torch.allclose(state[key], st_full[key], atol=1e-6), key


def test_mamba2_in_bf16_keeps_a_float32_state():
    cfg = dataclasses.replace(get_config("zamba2-1.2b-smoke"),
                              dtype=torch.bfloat16)
    p = materialize(MB.mamba2_defs(cfg), torch.Generator().manual_seed(2),
                    "cpu")
    x = torch.from_numpy(_x(cfg, 1, 64, 9)).bfloat16()
    out, st = MB.mamba2_apply(p, cfg, x, return_state=True)
    assert out.dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    assert st["conv_x"].dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
