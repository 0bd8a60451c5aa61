"""tests/test_models_smoke.py's cases for the moe, hybrid, vlm and audio
archs, on the port alone (reduced configs, random parameters from a
``torch.Generator``, ``cond`` from a numpy seed), with the reference's
bounds: the forward's shape and finiteness and a training step's finite,
nonzero gradients; prefill + one decode step against the full forward
(5e-2, 0.1 for MoE, whose capacity drops differ between the two); the
int8 cache within 0.25 of the full forward; greedy decode token by token
equal to the full forward's argmax (not asserted for MoE, as there).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.params import tree_map

ARCHS = ["mixtral-8x7b", "mixtral-8x22b", "zamba2-1.2b",
         "llama-3.2-vision-11b", "musicgen-large"]


def _batch(cfg, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         size=(B, S))).long()
    b = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    if cfg.family in ("vlm", "audio"):
        b["cond"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_cross_tokens, cfg.d_model)).astype(np.float32))
    return b


def _params(cfg, seed):
    return M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _last_logits(params, cfg, toks, cond):
    x, _, _ = M.forward(params, cfg, toks, cond=cond)
    return L.logits_apply(params["embed"], cfg, x[:, -1:])[:, 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    cfg = get_config(arch).reduced()
    params = _params(cfg, 0)
    batch = _batch(cfg)
    x, aux, _ = M.forward(params, cfg, batch["tokens"],
                          cond=batch.get("cond"), mode="train")
    assert x.shape == (2, 64, cfg.d_model)
    assert not bool(torch.isnan(x).any())
    leaves = []

    def collect(t):
        t.requires_grad_(t.is_floating_point())
        if t.requires_grad:
            leaves.append(t)
    tree_map(collect, params)
    loss = M.lm_loss(params, cfg, batch)
    assert np.isfinite(loss.item())
    loss.backward()
    gsum = sum(float(t.grad.abs().sum()) for t in leaves
               if t.grad is not None)
    assert np.isfinite(gsum) and gsum > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    cfg = get_config(arch).reduced()
    params = _params(cfg, 1)
    b = _batch(cfg, B=2, S=33, seed=2)
    toks, cond = b["tokens"], b.get("cond")
    ref = _last_logits(params, cfg, toks, cond)
    _, cache = M.prefill(params, cfg, toks[:, :32], cond=cond, max_len=64)
    got, _ = M.decode_step(params, cfg, cache, toks[:, 32:33],
                           torch.full((2,), 32, dtype=torch.int32))
    tol = 0.1 if cfg.num_experts else 5e-2  # MoE capacity drops differ
    assert float((ref - got).abs().max()) < tol


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "musicgen-large",
                                  "llama-3.2-vision-11b"])
def test_int8_kv_cache_close_to_bf16(arch):
    cfg = get_config(arch + "-smoke+kv8")
    params = _params(cfg, 1)
    b = _batch(cfg, B=2, S=17, seed=3)
    toks, cond = b["tokens"], b.get("cond")
    ref = _last_logits(params, cfg, toks, cond)
    _, cache = M.prefill(params, cfg, toks[:, :16], cond=cond, max_len=32)
    assert cache["k"].dtype == torch.int8
    got, _ = M.decode_step(params, cfg, cache, toks[:, 16:17],
                           torch.full((2,), 16, dtype=torch.int32))
    assert float((ref - got).abs().max()) < 0.25


@pytest.mark.parametrize("arch", ARCHS)
def test_multi_token_greedy_decode_consistency(arch):
    """Greedy decode token-by-token == argmax of the full forward pass."""
    cfg = get_config(arch).reduced()
    params = _params(cfg, 4)
    b = _batch(cfg, B=1, S=16, seed=5)
    toks, cond = b["tokens"], b.get("cond")
    logits, cache = M.prefill(params, cfg, toks[:, :8], cond=cond,
                              max_len=32)
    seq = toks[0, :8].tolist()
    cur = int(torch.argmax(logits[0]))
    for step in range(3):
        seq.append(cur)
        want = int(torch.argmax(_last_logits(params, cfg,
                                             torch.tensor([seq]), cond)[0]))
        got_logits, cache = M.decode_step(
            params, cfg, cache, torch.tensor([[cur]]),
            torch.tensor([len(seq) - 1], dtype=torch.int32))
        got = int(torch.argmax(got_logits[0]))
        if cfg.num_experts:  # capacity dispatch may flip rare near-ties
            continue
        assert got == want, f"step {step}: {got} != {want}"
        cur = got
