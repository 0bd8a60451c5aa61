"""The port's RWKV6 serving path against ``repro``'s, on the CPU.

``repro``'s ``rwkv6-3b-smoke`` parameters (2 layers, d_model 64, 4 heads ×
16, vocab 256; stored in bf16, computed in f32) are carried over with
``params_from_numpy``; the port runs its plain versions on CPU tensors.

Tolerances, each as ``max|Δ| / (max|reference| + 1)``:

* logits and float32 state: 2e-5 (float32 matmuls and the wkv summed in
  other orders; measured ≤ 3.3e-6);
* the bf16 token shifts of the cache: one bf16 spacing, 2**-7 relative to
  the largest value (the f32 values agree to ~1e-6, and a rounding to bf16
  can land one step apart when a value sits near the middle of two;
  measured ≤ 4.3e-4).

The engines' greedy tokens must be equal: the smoke model's f32 logits are
far from ties at these prompts.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.models.params import materialize, tree_defs
from repro_torch.models.weights import cache_from_numpy, params_from_numpy
from repro_torch.serve import ContinuousBatchingEngine, Request

F32_BOUND = 2e-5
BF16_BOUND = 2.0 ** -7


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1.0))


def _host(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config("rwkv6-3b-smoke")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("rwkv6-3b-smoke")
    return jcfg, jparams, cfg, params_from_numpy(_host(jparams), cfg, "cpu")


def _check_cache(got: dict, want: dict):
    for key, g in got["rwkv"].items():
        w = np.asarray(want["rwkv"][key].astype(jnp.float32))
        assert g.shape == w.shape, key
        bound = F32_BOUND if g.dtype == torch.float32 else BF16_BOUND
        assert _rel(g.float(), w) < bound, key


@pytest.mark.parametrize("S", [13, 128])
def test_prefill_and_decode_match_jax(smoke, S):
    jcfg, jparams, cfg, params = smoke
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    jlogits, jcache = JM.prefill(jparams, jcfg, jnp.asarray(tokens),
                                 max_len=256)
    logits, cache = M.prefill(params, cfg, torch.from_numpy(tokens).long(),
                              max_len=256)
    assert logits.shape == (2, cfg.vocab_size)
    assert _rel(logits, jlogits) < F32_BOUND
    assert cache["rwkv"]["shift_tm"].dtype == torch.bfloat16
    _check_cache(cache, jcache)

    # one decode step from repro's own cache, carried over
    tok = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
    pos = np.full(2, S, np.int32)
    jlogits, jnew = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                   jnp.asarray(pos))
    carried = cache_from_numpy(_host(jcache), cfg, 2, 256, "cpu")
    wkv = carried["rwkv"]["wkv"]
    logits, new = M.decode_step(params, cfg, carried,
                                torch.from_numpy(tok).long(),
                                torch.from_numpy(pos))
    assert _rel(logits, jlogits) < F32_BOUND
    _check_cache(new, jnew)
    # decode_step writes the new state into the cache it was given: the
    # float32 wkv state in place; the bf16 token shifts become float32,
    # as the reference's scan returns them from this f32 model
    assert new is carried and new["rwkv"]["wkv"] is wkv
    assert jnew["rwkv"]["shift_tm"].dtype == jnp.float32
    assert new["rwkv"]["shift_tm"].dtype == torch.float32


def _run_jax_engine(jcfg, jparams, prompts, max_new, slots, max_len):
    eng = JaxEngine(jcfg, jparams, batch_size=slots, max_len=max_len)
    got = {}
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        eng.submit(JaxRequest(prompt=p, max_new_tokens=n,
                              done=lambda t, i=i: got.update({i: t})))
    eng.run_until_drained()
    return got, eng.steps


def _run_engine(cfg, params, prompts, max_new, slots, max_len):
    eng = ContinuousBatchingEngine(cfg, params, batch_size=slots,
                                   max_len=max_len)
    got = {}
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(prompt=p, max_new_tokens=n,
                           done=lambda t, i=i: got.update({i: t})))
    eng.run_until_drained()
    assert not eng.backlog and not any(eng.active) and not eng.generated
    return got, eng.steps


def test_engine_tokens_equal_jax_engine(smoke):
    """Five requests over two slots; the 20-token prompt is longer than
    max_len (16), so it answers with its prefill token alone, and the
    11-token one stops at the max_len rule before its budget."""
    jcfg, jparams, cfg, params = smoke
    rng = np.random.default_rng(5)
    lengths, max_new = [5, 11, 3, 20, 7], [4, 6, 3, 4, 5]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    want, jsteps = _run_jax_engine(jcfg, jparams, prompts, max_new, 2, 16)
    got, steps = _run_engine(cfg, params, prompts, max_new, 2, 16)
    assert got == want and steps == jsteps
    assert len(got[3]) == 1 and len(got[1]) < max_new[1]


def _greedy_solo(cfg, params, prompt, n):
    """Token-by-token reference using prefill + decode_step directly."""
    logits, cache = M.prefill(params, cfg,
                              torch.from_numpy(prompt)[None].long(),
                              max_len=64)
    out = [int(torch.argmax(logits[0]))]
    for i in range(n - 1):
        pos = torch.tensor([len(prompt) + i])
        logits, cache = M.decode_step(params, cfg, cache,
                                      torch.tensor([[out[-1]]]), pos)
        out.append(int(torch.argmax(logits[0])))
    return out


def test_batched_results_match_isolated_runs(smoke):
    """Slot packing must not leak state between concurrent requests."""
    _, _, cfg, params = smoke
    prompts = [(np.arange(4) + s).astype(np.int32) % cfg.vocab_size
               for s in (0, 11, 23)]
    solo = [_greedy_solo(cfg, params, p, 4) for p in prompts]
    got, _ = _run_engine(cfg, params, prompts, [4, 4, 4], 3, 64)
    for i in range(3):
        assert got[i] == solo[i], f"request {i} diverged under batching"


def test_param_count_equals_repro():
    for name in ("rwkv6-3b", "rwkv6-3b-smoke"):
        assert M.param_count(get_config(name)) == \
            JM.param_count(jax_get_config(name))
    assert M.param_count(get_config("rwkv6-3b")) == 3_099_609_600


def test_materialize_follows_the_reference_init_rules(smoke):
    jcfg, jparams, cfg, _ = smoke
    got = materialize(M.model_defs(cfg),
                      torch.Generator().manual_seed(1), "cpu")
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    want = {tuple(k.key for k in path): a for path, a in flat_j.items()}
    defs = dict(tree_defs(M.model_defs(cfg)))
    assert set(defs) == set(want)
    for path, d in defs.items():
        node = got
        for key in path:
            node = node[key]
        a, j = node, want[path]
        assert tuple(a.shape) == tuple(j.shape) == d.shape, path
        assert str(a.dtype).split(".")[-1] == str(j.dtype), path
        if d.init in ("zeros", "ones"):
            assert bool((a == (1 if d.init == "ones" else 0)).all()), path
            continue
        std = 0.02 if d.init == "small" else d.scale or 1 / math.sqrt(
            int(np.prod(d.shape[1:-1] if d.logical[0] == "layers"
                        else d.shape[:-1])))
        # the sample std of >= 1000 draws lies within 15 % of its own
        for sample in (a.float().numpy(), np.asarray(j, np.float32)):
            assert abs(sample.std() / std - 1) < 0.15, path
            assert abs(sample.mean()) < 0.2 * std, path


def test_get_config_resolves_smoke_and_rejects_variants():
    cfg = get_config("rwkv6-3b-smoke")
    assert cfg == get_config("rwkv6-3b").reduced()
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (2, 64, 256)
    # the reference's runtime variants resolve as the reference resolves
    # them, except +kv8, which the port refuses for a family with no KV
    # cache (ROADMAP F12); an unknown variant or arch is refused by name
    for name in ("rwkv6-3b+kv8", "rwkv6-3b+ac512", "rwkv6-3b-smoke+kv8"):
        want = jax_get_config(name)
        if "+kv8" in name:
            assert want.kv_cache_dtype == "int8"
            with pytest.raises(ValueError, match="ssm family"):
                get_config(name)
            continue
        got = get_config(name)
        assert got.name == want.name
        assert (got.kv_cache_dtype, got.attn_chunk) == \
            (want.kv_cache_dtype, want.attn_chunk)
    for name in ("rwkv6-3b+kv4", "llama3-8b"):
        with pytest.raises(KeyError, match=name.split("+")[-1]):
            get_config(name)


def test_prefill_takes_a_wkv_function_in_place_of_the_kernel(smoke):
    """``impl`` may be a function with ``ops.wkv_chunk``'s signature: the
    prefill calls it once per layer and its result is what the model
    uses (chip_smoke.py instruments the wkv this way)."""
    _, _, cfg, params = smoke
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, 40))).long()
    calls = []

    def wkv(*a):
        calls.append(tuple(a[0].shape))
        return ops.wkv_chunk(*a, impl="ref")

    want, want_cache = M.prefill(params, cfg, tokens, impl="ref")
    got, cache = M.prefill(params, cfg, tokens, impl=wkv)
    assert calls == [(1, 40, cfg.num_heads, cfg.head_dim)] * cfg.num_layers
    assert torch.equal(got, want)
    assert all(torch.equal(cache["rwkv"][k], want_cache["rwkv"][k])
               for k in want_cache["rwkv"])


@pytest.mark.parametrize("family", ["moe", "hybrid", "vlm", "audio"])
def test_other_families_name_the_roadmap_item(family):
    """The other families are ported (ROADMAP A9.1): each family's
    parameter tree equals repro's, leaf by leaf; an unknown family is
    refused by name."""
    import dataclasses
    arch = {"moe": "mixtral-8x7b", "hybrid": "zamba2-1.2b",
            "vlm": "llama-3.2-vision-11b", "audio": "musicgen-large"}[family]
    cfg, jcfg = get_config(arch + "-smoke"), jax_get_config(arch + "-smoke")
    assert cfg.family == family
    got = {path: (d.shape, d.init, d.scale)
           for path, d in tree_defs(M.model_defs(cfg))}
    flat = jax.tree_util.tree_flatten_with_path(
        JM.model_defs(jcfg), is_leaf=lambda x: hasattr(x, "logical"))[0]
    want = {tuple(k.key for k in path): (d.shape, d.init, d.scale)
            for path, d in flat}
    assert got == want
    with pytest.raises(ValueError, match="unknown family 'mlp'"):
        M.model_defs(dataclasses.replace(cfg, family="mlp"))


def test_launch_serve_smoke_on_cpu(capsys):
    assert launch_serve.main(["--arch", "rwkv6-3b", "--smoke", "--device",
                              "cpu", "--requests", "3", "--max-new", "4"]) == 0
    assert "3/3 responses, 12 tokens" in capsys.readouterr().out
