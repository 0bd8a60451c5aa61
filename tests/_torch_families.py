"""Shared pieces of the port's family tests (``test_torch_families.py``,
``test_torch_hybrid.py``, ``test_torch_families_engine.py``): ``repro``'s
reduced parameters carried over, the model check (``forward``,
``prefill`` and two ``decode_step``s from ``repro``'s own cache) and the
engines' token check, with the bounds the test modules state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.weights import cache_from_numpy, params_from_numpy
from repro_torch.serve.engine import ContinuousBatchingEngine, Request

MODEL_BOUND = 2e-5
BF16_BOUND = 2.0 ** -7
INT8_OFF_SHARE = 1e-3
TIE_GAP = 1e-4


def rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1.0))


def host(tree):
    """A jax tree as numpy: float leaves as float32, integer leaves as
    they are."""
    def leaf(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return np.asarray(a.astype(jnp.float32))
        return np.asarray(a)
    return jax.tree_util.tree_map(leaf, tree)


def carried(arch, changes, kv8=False, seed=0):
    """(repro's config, params; the port's config, params): repro's
    reduced parameters, the vlm's cross gates drawn nonzero."""
    name = arch + "-smoke" + ("+kv8" if kv8 else "")
    jcfg = dataclasses.replace(jax_get_config(name), **changes)
    cfg = dataclasses.replace(get_config(name), **changes)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = host(jparams)
    if "cross" in tree:
        gate = tree["cross"]["xattn"]["gate"]
        tree["cross"]["xattn"]["gate"] = np.random.default_rng(seed).normal(
            size=gate.shape).astype(np.float32)
        jparams = jax.tree_util.tree_map(lambda a, h: jnp.asarray(h, a.dtype),
                                         jparams, tree)
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg, "cpu")


def cond_for(cfg, B, rng):
    if cfg.family not in ("vlm", "audio"):
        return None
    return rng.normal(size=(B, cfg.n_cross_tokens, cfg.d_model)).astype(
        np.float32)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _check_cache(got: dict, want: dict, *, conv_rounded: bool):
    got, want = dict(flat(got)), dict(flat(want))
    assert set(got) == set(want)
    for key, g in got.items():
        w = np.asarray(want[key])
        assert tuple(g.shape) == w.shape, key
        if key == "kv_pos":
            assert np.array_equal(g.numpy(), w), key
        elif g.dtype == torch.int8:
            diff = np.abs(g.numpy().astype(int) - w.astype(int))
            assert diff.max() <= 1 and diff.mean() <= INT8_OFF_SHARE, key
        elif conv_rounded and key.startswith("mamba.conv"):
            assert rel(g, w) < BF16_BOUND, key
        else:
            assert rel(g, w) < MODEL_BOUND, key


def _dtype_name(t) -> str:
    return str(t.dtype).split(".")[-1]


def check_model(arch: str, changes: dict, S: int, kv8: bool) -> None:
    """A reduced arch on carried parameters against repro: forward (hidden,
    aux, cache parts), prefill (logits, every cache leaf and its dtype),
    two decode steps from repro's own cache (logits, every leaf, written
    in place)."""
    jcfg, jparams, cfg, params = carried(arch, changes, kv8)
    rng = np.random.default_rng(11)
    max_len = 64 if S < 64 else 256
    tokens = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    cond = cond_for(cfg, 2, rng)
    jcond = None if cond is None else jnp.asarray(cond)
    tcond = None if cond is None else torch.from_numpy(cond)
    toks = torch.from_numpy(tokens).long()

    jx, jaux, jparts = JM.forward(jparams, jcfg, jnp.asarray(tokens),
                                  cond=jcond, mode="prefill")
    x, aux, parts = M.forward(params, cfg, toks, cond=tcond, mode="prefill")
    assert rel(x, jx) < MODEL_BOUND
    assert abs(float(aux) - float(jaux)) < MODEL_BOUND * (abs(float(jaux)) + 1)
    assert (float(aux) > 0) == (cfg.family == "moe")
    jflat = dict(flat(jparts))
    for key, t in flat(parts):
        assert tuple(t.shape) == jflat[key].shape, key
        assert rel(t, host(jflat[key])) < MODEL_BOUND, key
    assert set(dict(flat(parts))) == set(jflat)

    jlogits, jcache = JM.prefill(jparams, jcfg, jnp.asarray(tokens),
                                 cond=jcond, max_len=max_len)
    logits, cache = M.prefill(params, cfg, toks, cond=tcond, max_len=max_len)
    assert rel(logits, jlogits) < MODEL_BOUND
    _check_cache(cache, host(jcache), conv_rounded=True)
    for key, t in flat(cache):
        assert _dtype_name(t) == str(dict(flat(jcache))[key].dtype), key
    if kv8:
        assert cache["k"].dtype == torch.int8
        if "cross_k" in cache:  # stays unquantized
            assert cache["cross_k"].dtype == torch.float32

    # decode steps from repro's own cache, carried over
    cache = cache_from_numpy(host(jcache), cfg, 2, max_len, "cpu")
    for step in range(2):
        tok = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        pos = np.full(2, S + step, np.int32)
        before = dict(flat(cache))
        jlogits, jcache = JM.decode_step(jparams, jcfg, jcache,
                                         jnp.asarray(tok), jnp.asarray(pos))
        logits, new = M.decode_step(params, cfg, cache,
                                    torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos))
        assert rel(logits, jlogits) < MODEL_BOUND
        _check_cache(new, host(jcache), conv_rounded=False)
        # written in place: the same dict and tensors, except the Mamba2
        # conv tails, which a float32 step turns from bf16 to float32 on
        # its first step (as repro's scan does)
        assert new is cache
        for key, t in flat(new):
            assert _dtype_name(t) == str(dict(flat(jcache))[key].dtype), key
            swapped = step == 0 and key.startswith("mamba.conv")
            assert (t is before[key]) is not swapped, key


def _engine_runs(jcfg, jparams, cfg, params, prompts, max_new, slots,
                 max_len):
    """[(repro's engine's tokens, ticks), (the port's tokens, ticks)]."""
    runs = []
    for Engine, Req, c, p in ((JaxEngine, JaxRequest, jcfg, jparams),
                              (ContinuousBatchingEngine, Request, cfg,
                               params)):
        eng = Engine(c, p, batch_size=slots, max_len=max_len)
        got = {}
        for i, (pr, n) in enumerate(zip(prompts, max_new)):
            eng.submit(Req(prompt=pr, max_new_tokens=n,
                           done=lambda t, i=i: got.update({i: t})))
        eng.run_until_drained()
        runs.append((got, eng.steps))
    return runs


def _parts_at_a_near_tie(jcfg, jparams, prompt, want, got) -> bool:
    """Whether two token lists part where repro's logits (a token-by-token
    run of the request alone) have a top-2 gap below TIE_GAP."""
    part = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    seq = list(prompt) + list(want[:part])
    cond = None
    if jcfg.family in ("vlm", "audio"):
        cond = jnp.zeros((1, jcfg.n_cross_tokens, jcfg.d_model), jcfg.dtype)
    x, _, _ = JM.forward(jparams, jcfg, jnp.asarray([seq], jnp.int32),
                         cond=cond)
    logits = np.asarray(JL.logits_apply(jparams["embed"], jcfg,
                                        x[:, -1:]))[0, 0]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0]) < TIE_GAP


def check_engine_tokens(arch: str) -> None:
    """Five requests over two slots on repro's reduced parameters carried
    over (the engines condition vlm and audio on zeros): the same tokens,
    apart from the near-tie rule, and the same number of ticks."""
    jcfg, jparams, cfg, params = carried(arch, {})
    rng = np.random.default_rng(5)
    lengths, max_new = [5, 11, 3, 20, 7], [4, 6, 3, 4, 5]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    (want, jsteps), (got, steps) = _engine_runs(
        jcfg, jparams, cfg, params, prompts, max_new, 2, 16)
    assert steps == jsteps and set(got) == set(want)
    for i in want:
        if got[i] != want[i]:
            assert _parts_at_a_near_tie(jcfg, jparams, prompts[i], want[i],
                                        got[i]), f"request {i}"
    # the 20-token prompt is longer than max_len: its prefill token alone
    assert len(got[3]) == 1
