"""The port's moe, vlm and audio families against ``repro``'s, on the CPU
(the hybrid's cases are in test_torch_hybrid.py, the engines' in
test_torch_families_engine.py; the shared checks in _torch_families.py).

Model tests carry ``repro``'s reduced parameters (stored in bf16, the
router and the cross gates in float32; computed in float32) over with
``params_from_numpy``, draw the vlm's cross ``gate``s nonzero and feed a
random ``cond`` (a zero gate or zero ``cond`` would silence the cross
path), and compare ``forward``, ``prefill`` and two ``decode_step``s from
``repro``'s own cache, carried over with ``cache_from_numpy``, with and
without ``+kv8``; then ``lm_loss`` (the moe family's ``0.01 · aux``
included) with its gradients.

Tolerances, each as ``max|Δ| / (max|reference| + 1)``:

* hidden states, logits, ``aux``, losses, K/V caches, int8 scales and
  float32 states: ``MODEL_BOUND`` = 2e-5, the bound of the dense and RWKV6
  tests (measured ≤ 4.9e-7 for moe, vlm and audio; the hybrid's hidden
  state reads 1.05e-5 at two 64-token chunks: its decays are
  exponentials of float32 prefix sums that reach ~-45 over a chunk, where
  the float32 spacing is 3.8e-6);
* the Mamba2 conv tails a prefill casts to bf16: one bf16 spacing,
  ``BF16_BOUND`` = 2**-7 (float32 values ~1e-7 apart can round one step
  apart; measured ≤ 4.2e-4);
* an int8 cache from float32 K/V ~1e-7 apart: each entry equal or one step
  apart, at most ``INT8_OFF_SHARE`` = 1e-3 of them apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (MODEL_BOUND, carried, check_model, cond_for,
                             flat)
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.models import model as M

# (arch, config changes, prompt length): the moe prompt (37) is longer
# than its reduced sliding window (32), so its cache is a rolling buffer
CASES = {
    "mixtral-8x7b": ("mixtral-8x7b", {}, 37),
    "llama-3.2-vision-11b": ("llama-3.2-vision-11b", {}, 37),
    "musicgen-large": ("musicgen-large", {}, 37),
}


@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "kv8"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case, kv8):
    check_model(*CASES[case], kv8)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-1.2b",
                                  "llama-3.2-vision-11b", "musicgen-large"])
def test_lm_loss_matches_jax(arch):
    jcfg, jparams, cfg, params = carried(arch, {}, seed=2)
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    cond = cond_for(cfg, 2, rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    if cond is not None:
        jbatch["cond"] = jnp.asarray(cond)
        tbatch["cond"] = torch.from_numpy(cond)
    want = float(JM.lm_loss(jparams, jcfg, jbatch))
    leaves = [t for _, t in flat(params)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = M.lm_loss(params, cfg, tbatch)
    assert abs(got.item() - want) < MODEL_BOUND * (want + 1)
    if cfg.family == "moe":  # the aux term is in the loss
        x, jaux, _ = JM.forward(jparams, jcfg, jbatch["tokens"])
        xent = float(JL.softmax_xent_chunked(jparams["embed"], jcfg, x,
                                             jbatch["labels"]))
        assert float(jaux) > 0
        assert want - xent == pytest.approx(0.01 * float(jaux), rel=1e-3)
    got.backward()
    grads = [t.grad for t in leaves]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0
