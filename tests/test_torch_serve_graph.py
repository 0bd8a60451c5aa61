"""The engine's compiled decode step (``serve.steps.DecodeGraph``) on the
CPU, where no CUDA graph can be captured: what the graph relies on, held
on the eager engine of every family.

* The decode step keeps every leaf of the cache (and the parameters) in
  its storage from the second tick on, over a drained engine run with
  slot refills: the check the graph makes before each replay
  (``steps.check_leaves``), applied to the eager path. A float32 model
  of the ssm and hybrid families swaps its bf16 token shifts and conv
  tails for float32 leaves on the first tick (``M.decode_step``'s
  contract): the reason the engine captures on the second tick, never
  the first. The smokes compute in float32; their bf16 variants swap
  nothing.
* ``graphs=False`` gives ``repro``'s jitted engine's tokens (the near-tie
  rule of ``_torch_families.py``: tokens may part only where ``repro``'s
  logits have a top-2 gap below ``TIE_GAP``), with the same ticks.
* A planted leaf replacement raises ``RuntimeError`` naming the leaf.
* ``graphs=True`` on a CPU cache raises ``ValueError``; ``None`` runs
  eagerly there.
* The engine's step is ``serve.steps.make_decode_step``'s.

The graph itself (capture, replays, tokens and logits against the eager
engine) is tested on the card in ``tests/test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_families import _parts_at_a_near_tie, carried
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import steps as sv
from repro_torch.serve.engine import ContinuousBatchingEngine, Request

# case -> (arch, +kv8, compute dtype: None keeps the smoke's float32)
CASES = {
    "rwkv6": ("rwkv6-3b", False, None),
    "rwkv6-bf16": ("rwkv6-3b", False, torch.bfloat16),
    "phi4": ("phi4-mini-3.8b", False, None),
    "phi4-kv8": ("phi4-mini-3.8b", True, None),
    "mixtral": ("mixtral-8x7b", False, None),
    "zamba2": ("zamba2-1.2b", False, None),
    "zamba2-bf16": ("zamba2-1.2b", False, torch.bfloat16),
    "vlm": ("llama-3.2-vision-11b", False, None),
    "musicgen": ("musicgen-large", False, None),
}
# the cases whose eager engine is held to repro's engine's tokens: the
# float32 smokes (a bf16 model's tokens part from repro's wherever two
# roundings of one logit do, far above TIE_GAP)
F32_CASES = sorted(c for c, (_, _, dt) in CASES.items() if dt is None)
LENGTHS, MAX_NEW = [5, 11, 3, 9, 7], [4, 6, 3, 5, 5]
SLOTS, MAX_LEN = 2, 32


def _config(case):
    arch, kv8, dt = CASES[case]
    cfg = get_config(arch + "-smoke" + ("+kv8" if kv8 else ""))
    return dataclasses.replace(cfg, dtype=dt) if dt is not None else cfg


def _prompts(cfg, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in LENGTHS]


def _submit(eng, prompts, got, Req=Request):
    for i, (p, n) in enumerate(zip(prompts, MAX_NEW)):
        eng.submit(Req(prompt=p, max_new_tokens=n,
                       done=lambda t, i=i: got.update({i: t})))


def _engine(case, seed=0, **kw):
    cfg = _config(case)
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return ContinuousBatchingEngine(cfg, params, batch_size=SLOTS,
                                    max_len=MAX_LEN, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_keeps_every_leaf_from_the_second_tick(case):
    eng = _engine(case)
    assert not eng.graphs
    got = {}
    _submit(eng, _prompts(eng.cfg), got)
    first = sv.leaf_ids(eng.params, eng.cache)
    eng.tick()
    want = sv.leaf_ids(eng.params, eng.cache)
    checks = 0
    while eng.backlog or any(eng.active):
        sv.check_leaves(want, eng.params, eng.cache)
        eng.tick()
        checks += 1
    sv.check_leaves(want, eng.params, eng.cache)
    assert set(got) == set(range(len(LENGTHS))) and checks >= 8
    assert eng.steps == checks + 1
    swapped = sorted(k for k in want if want[k] != first[k])
    if eng.cfg.family in ("ssm", "hybrid") and \
            eng.cfg.dtype == torch.float32:
        assert swapped and all(first[k][1] == torch.bfloat16
                               and want[k][1] == torch.float32
                               for k in swapped), swapped
    else:
        assert swapped == []


@pytest.mark.parametrize("case", F32_CASES)
def test_eager_engine_gives_repro_engines_tokens(case):
    arch, kv8, _ = CASES[case]
    jcfg, jparams, cfg, params = carried(arch, {}, kv8=kv8)
    prompts = _prompts(cfg)
    want, got = {}, {}
    jeng = JaxEngine(jcfg, jparams, batch_size=SLOTS, max_len=MAX_LEN)
    _submit(jeng, prompts, want, JaxRequest)
    jeng.run_until_drained()
    eng = ContinuousBatchingEngine(cfg, params, batch_size=SLOTS,
                                   max_len=MAX_LEN, graphs=False)
    _submit(eng, prompts, got)
    eng.run_until_drained()
    assert eng.steps == jeng.steps and set(got) == set(want)
    assert eng.graph_captures == eng.graph_replays == 0
    for i in want:
        if got[i] != want[i]:
            assert _parts_at_a_near_tie(jcfg, jparams, prompts[i], want[i],
                                        got[i]), f"request {i}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_replaced_leaf_raises_naming_it(case):
    eng = _engine(case)
    _submit(eng, _prompts(eng.cfg), {})
    eng.tick()
    want = sv.leaf_ids(eng.params, eng.cache)
    key = sorted(eng.cache)[0]
    leaf = eng.cache[key]
    node, sub = (leaf, sorted(leaf)[0]) if isinstance(leaf, dict) \
        else (eng.cache, key)
    name = f"cache/{key}" + (f"/{sub}" if node is leaf else "")
    kept = node[sub]
    node[sub] = kept.clone()
    with pytest.raises(RuntimeError, match=f"leaf {name} changed"):
        sv.check_leaves(want, eng.params, eng.cache)
    node[sub] = kept
    sv.check_leaves(want, eng.params, eng.cache)
    eng.params["final_norm"] = eng.params["final_norm"].clone()
    with pytest.raises(RuntimeError, match="leaf params/final_norm changed"):
        sv.check_leaves(want, eng.params, eng.cache)


def test_a_leaf_of_another_dtype_or_shape_or_a_new_leaf_raises():
    eng = _engine("phi4")
    want = sv.leaf_ids(eng.params, eng.cache)
    kv_pos = eng.cache["kv_pos"]
    for planted in (kv_pos.view(torch.float32), kv_pos[:1]):
        eng.cache["kv_pos"] = planted
        with pytest.raises(RuntimeError, match="leaf cache/kv_pos changed"):
            sv.check_leaves(want, eng.params, eng.cache)
    eng.cache["kv_pos"] = kv_pos
    sv.check_leaves(want, eng.params, eng.cache)
    eng.cache["extra"] = kv_pos.clone()
    with pytest.raises(RuntimeError, match="leaf cache/extra changed"):
        sv.check_leaves(want, eng.params, eng.cache)


def test_graphs_need_a_cuda_cache():
    with pytest.raises(ValueError, match="CUDA"):
        _engine("rwkv6", graphs=True)
    assert not _engine("rwkv6").graphs and not _engine("rwkv6",
                                                       graphs=None).graphs
    cfg = _config("phi4")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = M.init_cache(cfg, SLOTS, MAX_LEN, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        sv.DecodeGraph(sv.make_decode_step(cfg), params, cache, SLOTS)


def test_engine_steps_through_make_decode_step(monkeypatch):
    """The engine builds its step with ``serve.steps.make_decode_step``
    and calls it once a tick; the step equals ``M.decode_step``."""
    calls = []

    def counting(cfg):
        step = sv.make_decode_step(cfg)

        def wrapped(*a):
            calls.append(a[3].shape)
            return step(*a)
        return wrapped

    monkeypatch.setattr(engine_mod, "make_decode_step", counting)
    eng = _engine("mixtral")
    got = {}
    _submit(eng, _prompts(eng.cfg), got)
    eng.run_until_drained()
    assert len(calls) == eng.steps > 0
    assert all(s == (SLOTS,) for s in calls)
    monkeypatch.undo()
    again = _engine("mixtral")
    assert again._step.__qualname__ == "make_decode_step.<locals>.step"
    want = {}
    _submit(again, _prompts(again.cfg), want)
    again.run_until_drained()
    assert want == got and again.steps == eng.steps
