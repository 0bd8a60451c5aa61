"""The port's dense family against ``repro``'s, on the CPU.

Inputs come from numpy seeds. Layer tests feed the same float32 arrays to
both packages; model tests carry ``repro``'s reduced parameters (stored in
bf16, computed in float32) over with ``params_from_numpy`` and compare
``forward``, ``prefill`` and ``decode_step`` (from ``repro``'s own cache,
carried over with ``cache_from_numpy``).

Tolerances, each as ``max|Δ| / (max|reference| + 1)``:

* layers in float32: ``LAYER_BOUND`` = 1e-6 (float32 sums in other orders,
  XLA's ``cos``/``sin``/``exp`` against torch's; measured ≤ 1.6e-7);
* models in float32 (hidden states, logits, K/V caches and int8 scales):
  ``MODEL_BOUND`` = 2e-5, the bound of the RWKV6 tests (measured
  ≤ 8.9e-7);
* ``quantize_kv`` and the bf16 embedding (gemma's rounded
  ``sqrt(d_model)``): exact;
* an int8 cache built from float32 K/V that differ by ~1e-7: each entry
  equal or one step apart, and at most ``INT8_OFF_SHARE`` = 1e-3 of them
  apart (a step only flips where a value sits at a rounding tie).

Then the reference's own smoke properties (tests/test_models_smoke.py) on
the port alone, with their bounds: prefill + decode against the full
forward (5e-2), greedy decode against the full forward's argmax, and the
int8 cache within 0.25 of the full forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import SHAPES, get_config, get_shape, list_archs
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.params import materialize
from repro_torch.models.weights import cache_from_numpy, params_from_numpy

LAYER_BOUND = 1e-6
MODEL_BOUND = 2e-5
INT8_OFF_SHARE = 1e-3
DENSE = ("gemma-2b", "phi4-mini-3.8b", "minitron-8b", "command-r-plus-104b")
# the reduced dense configs the models are compared at: the three archs,
# a parallel block and a sliding window (a rolling cache of 16 slots)
CASES = {
    "gemma-2b": {},
    "phi4-mini-3.8b": {},
    "minitron-8b": {},
    "parallel": {"parallel_block": True},
    "window": {"sliding_window": 16},
}


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1.0))


def _host(tree):
    """A jax tree as numpy: float leaves as float32, integer leaves as
    they are."""
    def leaf(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return np.asarray(a.astype(jnp.float32))
        return np.asarray(a)
    return jax.tree_util.tree_map(leaf, tree)


def _configs(case: str, kv8: bool = False):
    """(repro's, the port's) reduced config of a model case."""
    arch = case if case in DENSE else "phi4-mini-3.8b"
    name = arch + "-smoke" + ("+kv8" if kv8 else "")
    return (dataclasses.replace(jax_get_config(name), **CASES[case]),
            dataclasses.replace(get_config(name), **CASES[case]))


PORT_FIELDS = [f.name for f in dataclasses.fields(
    get_config("gemma-2b").__class__)]


def _cfg_fields(cfg) -> dict:
    """The port's fields of a config of either package, dtype by name."""
    out = {name: getattr(cfg, name) for name in PORT_FIELDS}
    out["dtype"] = str(cfg.dtype).split(".")[-1] if isinstance(
        cfg.dtype, torch.dtype) else jnp.dtype(cfg.dtype).name
    return out


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
def test_config_fields_are_the_references():
    """The port's fields are the reference's, in its order and with its
    defaults (less ``attn_bias`` and ``scan_layers``, which no ported
    code reads)."""
    import repro.configs.base as jbase
    import repro_torch.configs.base as tbase
    jfields = {f.name: f for f in dataclasses.fields(jbase.ModelConfig)}
    assert PORT_FIELDS == [f for f in jfields if f in PORT_FIELDS]
    for f in dataclasses.fields(tbase.ModelConfig):
        if f.name != "dtype":
            assert f.default == jfields[f.name].default, f.name
    assert [f.name for f in dataclasses.fields(tbase.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ShapeConfig)]
    assert SHAPES == {k: get_shape(k) for k in JAX_SHAPES}
    assert {k: dataclasses.astuple(s) for k, s in SHAPES.items()} == \
        {k: dataclasses.astuple(s) for k, s in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_get_config_equals_the_reference(arch):
    """Field by field on the port's fields; the reference's other fields
    sit at their defaults, so the port drops no setting of the arch."""
    import repro.configs.base as jbase
    rest = [f for f in dataclasses.fields(jbase.ModelConfig)
            if f.name not in PORT_FIELDS]
    assert arch in jax_list_archs()
    for name in (arch, arch + "-smoke", arch + "+kv8", arch + "-smoke+kv8",
                 arch + "+ac512", arch + "-smoke+ac16+kv8"):
        jcfg = jax_get_config(name)
        if "+kv8" in name and jcfg.family in ("ssm", "hybrid"):
            # refused where there is no scaled int8 cache (ROADMAP F12)
            with pytest.raises(ValueError, match="no scaled int8 KV cache"):
                get_config(name)
            continue
        cfg = get_config(name)
        assert _cfg_fields(cfg) == _cfg_fields(jcfg), name
        for f in rest:
            assert getattr(jcfg, f.name) == f.default, (name, f.name)
        for shape in SHAPES.values():
            assert cfg.supports_shape(shape) == jcfg.supports_shape(
                JAX_SHAPES[shape.name])
        assert cfg.sub_quadratic == jcfg.sub_quadratic
    assert get_config(arch + "-smoke") == get_config(arch).reduced()


def test_unported_archs_and_variants_are_refused_by_name():
    """Every arch of repro is registered, in its order; an unknown arch or
    variant is refused by name."""
    assert list_archs() == jax_list_archs()
    with pytest.raises(KeyError, match="llama3-8b"):
        get_config("llama3-8b")
    with pytest.raises(KeyError, match="kv4"):
        get_config("gemma-2b+kv4")


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_repro(arch):
    for name in (arch, arch + "-smoke"):
        cfg, jcfg = get_config(name), jax_get_config(name)
        assert M.param_count(cfg) == JM.param_count(jcfg)
        assert M.active_param_count(cfg) == JM.active_param_count(jcfg)
    if arch == "mixtral-8x7b":  # all 8 experts, and the top-2 a token uses
        cfg = get_config(arch)
        assert (M.param_count(cfg), M.active_param_count(cfg)) == \
            (46_702_792_704, 12_879_925_248)
    tied = get_config(arch).tie_embeddings
    assert ("head" in M.model_defs(get_config(arch))["embed"]) is not tied


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_jax(plus_one):
    rng = np.random.default_rng(int(plus_one))
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    w = rng.normal(size=64).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, plus_one)
    got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                     plus_one)
    assert _rel(got, want) < LAYER_BOUND


@pytest.mark.parametrize("fraction", [1.0, 0.75, 0.5])
def test_apply_rope_matches_jax(fraction):
    rng = np.random.default_rng(int(fraction * 100))
    x = rng.normal(size=(2, 37, 4, 16)).astype(np.float32)
    pos = (np.arange(37, dtype=np.int32)[None] + np.array([[0], [3000]],
                                                         np.int32))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, fraction)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0,
                       fraction)
    assert _rel(got, want) < LAYER_BOUND
    rot = int(16 * fraction)
    assert torch.equal(got[..., rot:], torch.from_numpy(x[..., rot:]))


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("S", [32, 37], ids=["chunked", "padded"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_blocked_attention_matches_jax(heads, S, window):
    H, KV = heads
    rng = np.random.default_rng(S + window + KV)
    q = rng.normal(size=(2, S, H, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, S, KV, 16)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    args = (q, k, v, pos, pos)
    want = JL.blocked_attention(*map(jnp.asarray, args), window=window,
                                chunk=16)
    got = L.blocked_attention(*map(torch.from_numpy, args), window=window,
                              chunk=16)
    assert got.shape == (2, S, H, 16)
    assert _rel(got, want) < LAYER_BOUND


def test_blocked_attention_non_causal_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 21, 2, 16)).astype(np.float32)
            for _ in range(2))
    qp, kp = np.zeros((2, 5), np.int32), np.zeros((2, 21), np.int32)
    args = (q, k, v, qp, kp)
    want = JL.blocked_attention(*map(jnp.asarray, args), causal=False,
                                chunk=8)
    got = L.blocked_attention(*map(torch.from_numpy, args), causal=False,
                              chunk=8)
    assert _rel(got, want) < LAYER_BOUND


def test_quantize_kv_is_exact():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 40, 2, 16)).astype(np.float32)
    # rows whose scale is 1: their values sit at exact halves, where the
    # rounding must go to even; and an all-zero row (the 1e-8 floor)
    x[0, 0, 0] = np.r_[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -127.0,
                       np.zeros(8)]
    x[0, 1, 1] = 0.0
    qj, sj = JL.quantize_kv(jnp.asarray(x))
    q, s = L.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(s.numpy(), np.asarray(sj))
    assert q[0, 0, 0, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -127]


def _attn_params(cfg, seed):
    return materialize(L.attn_defs(cfg), torch.Generator().manual_seed(seed),
                       "cpu", dtype_override=torch.float32)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_decode_self_attention_matches_jax(int8, window):
    jcfg, cfg = _configs("phi4-mini-3.8b")
    p = _attn_params(cfg, 5)
    rng = np.random.default_rng(6)
    B, W, KV, hd = 3, 24, cfg.num_kv_heads, cfg.head_dim
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    # row 0 early (free slots ahead), row 1 at the last slot, row 2 past W
    pos = np.array([5, 23, 40], np.int32)
    kv_pos = np.full((B, W), 2**30, np.int32)
    for b, n in enumerate(pos):
        have = np.arange(max(0, n - W + 1), n + 1)
        slots = have % W if window else np.minimum(have, W - 1)
        kv_pos[b, slots] = have
    if int8:
        kc, vc = (rng.integers(-127, 128, size=(B, W, KV, hd), dtype=np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.001, 0.02, size=(B, W, KV)).astype(np.float32)
                  for _ in range(2))
    else:
        kc, vc = (rng.normal(size=(B, W, KV, hd)).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    scales = (ks, vs)
    jout = JL.decode_self_attention(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()}, jcfg,
        jnp.asarray(x1), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kv_pos), jnp.asarray(pos), window=window,
        **{n: None if a is None else jnp.asarray(a)
           for n, a in zip(("k_scale", "v_scale"), scales)})
    caches = [torch.from_numpy(a.copy()) for a in (kc, vc)]
    sc = [None if a is None else torch.from_numpy(a.copy()) for a in scales]
    out = L.decode_self_attention(
        p, cfg, torch.from_numpy(x1), *caches, torch.from_numpy(kv_pos),
        torch.from_numpy(pos), window=window, k_scale=sc[0], v_scale=sc[1])
    assert _rel(out[0], jout[0]) < LAYER_BOUND
    # the caches are written in place and returned as they were passed
    assert out[1] is caches[0] and out[2] is caches[1]
    for got, want in zip(out[1:], jout[1:]):
        if want is None:
            assert got is None
        elif got.dtype == torch.int8:
            diff = np.abs(got.numpy().astype(int) - np.asarray(want, int))
            assert diff.max() <= 1 and diff.mean() <= INT8_OFF_SHARE
        else:
            assert _rel(got, want) < LAYER_BOUND


def test_write_kv_pos_matches_jax():
    kv = np.full((3, 8), 2**30, np.int32)
    pos = np.array([2, 7, 13], np.int32)
    for window in (0, 8):
        want = JL.write_kv_pos(jnp.asarray(kv), jnp.asarray(pos),
                               window=window)
        got = torch.from_numpy(kv.copy())
        assert L.write_kv_pos(got, torch.from_numpy(pos), window=window) \
            is got
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_apply_matches_jax(mlp_type):
    jcfg, cfg = (dataclasses.replace(c, mlp_type=mlp_type)
                 for c in _configs("phi4-mini-3.8b"))
    p = materialize(L.mlp_defs(cfg), torch.Generator().manual_seed(7), "cpu",
                    dtype_override=torch.float32)
    x = 3 * np.random.default_rng(8).normal(size=(2, 5, 64)).astype(
        np.float32)
    want = JL.mlp_apply({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                        jcfg, jnp.asarray(x))
    assert _rel(L.mlp_apply(p, cfg, torch.from_numpy(x)), want) < LAYER_BOUND


def test_gelu_mlps_use_the_tanh_form():
    """The gelu MLP through identity projections is the activation alone:
    JAX's default (tanh) form, which torch's default (erf) form misses by
    more than the bound."""
    jcfg, cfg = (dataclasses.replace(c, mlp_type="gelu", d_ff=64)
                 for c in _configs("phi4-mini-3.8b"))
    eye = torch.eye(64)
    x = np.linspace(-4, 4, 64, dtype=np.float32)[None, None]
    want = np.asarray(JL.mlp_apply({"wu": jnp.eye(64), "wd": jnp.eye(64)},
                                   jcfg, jnp.asarray(x)))
    got = L.mlp_apply({"wu": eye, "wd": eye}, cfg, torch.from_numpy(x))
    assert _rel(got, want) < LAYER_BOUND
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert _rel(erf, want) > 50 * LAYER_BOUND


def test_embed_apply_rounds_gemmas_scale_in_bf16():
    """gemma in bf16: JAX rounds sqrt(2048) to bf16 (45.25) before the
    multiply, and the port must too; the unrounded scale gives other bf16
    values on [-3, 3]."""
    jcfg = dataclasses.replace(jax_get_config("gemma-2b"), vocab_size=1001)
    cfg = dataclasses.replace(get_config("gemma-2b"), vocab_size=1001)
    assert cfg.dtype == torch.bfloat16 and cfg.embed_scale
    table = np.linspace(-3, 3, 1001, dtype=np.float32)[:, None].repeat(4, 1)
    tokens = np.arange(1001)[None]
    want = JL.embed_apply({"table": jnp.asarray(table, jnp.bfloat16)}, jcfg,
                          jnp.asarray(tokens))
    t = torch.from_numpy(table).bfloat16()
    got = L.embed_apply({"table": t}, cfg, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.array_equal(got.float().numpy(), want)
    unrounded = (t[torch.from_numpy(tokens)] * 2048 ** 0.5).float().numpy()
    assert (unrounded != want).any()


@pytest.mark.parametrize("S", [64, 37], ids=["chunked", "one_chunk"])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_chunked_matches_jax(S, masked):
    jcfg, cfg = _configs("phi4-mini-3.8b")
    p = materialize(L.embed_defs(cfg), torch.Generator().manual_seed(9),
                    "cpu", dtype_override=torch.float32)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    mask = (rng.random((2, S)) < 0.7).astype(np.float32) if masked else None
    want = JL.softmax_xent_chunked(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()}, jcfg,
        jnp.asarray(x), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = L.softmax_xent_chunked(
        p, cfg, torch.from_numpy(x), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert abs(float(got) - float(want)) < LAYER_BOUND * (abs(float(want)) + 1)


# --------------------------------------------------------------------------
# models on carried parameters
# --------------------------------------------------------------------------
def _check_cache(got: dict, want: dict):
    assert set(got) == set(want)
    for key, g in got.items():
        w = np.asarray(want[key])
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).split(".")[-1] == str(w.dtype), key
        if key == "kv_pos":
            assert np.array_equal(g.numpy(), w), key
        elif g.dtype == torch.int8:
            diff = np.abs(g.numpy().astype(int) - w.astype(int))
            assert diff.max() <= 1 and diff.mean() <= INT8_OFF_SHARE, key
        else:
            assert _rel(g, w) < MODEL_BOUND, key


@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "kv8"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case, kv8):
    jcfg, cfg = _configs(case, kv8)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(_host(jparams), cfg, "cpu")
    rng = np.random.default_rng(11)
    S, max_len = 37, 64
    tokens = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    toks = torch.from_numpy(tokens).long()

    jx, _, jparts = JM.forward(jparams, jcfg, jnp.asarray(tokens),
                               mode="prefill")
    x, aux, parts = M.forward(params, cfg, toks, mode="prefill")
    assert _rel(x, jx) < MODEL_BOUND and float(aux) == 0.0
    for side in ("k", "v"):
        assert parts[side].shape == jparts[side].shape
        assert _rel(parts[side], jparts[side]) < MODEL_BOUND

    jlogits, jcache = JM.prefill(jparams, jcfg, jnp.asarray(tokens),
                                 max_len=max_len)
    logits, cache = M.prefill(params, cfg, toks, max_len=max_len)
    assert _rel(logits, jlogits) < MODEL_BOUND
    _check_cache(cache, _host(jcache))
    if kv8:
        assert cache["k"].dtype == torch.int8
    if case == "window":
        assert cache["k"].shape[2] == 16  # a rolling buffer of the window

    # decode steps from repro's own cache, carried over
    carried = cache_from_numpy(_host(jcache), cfg, 2, max_len, "cpu")
    for step in range(2):
        tok = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        pos = np.full(2, S + step, np.int32)
        jlogits, jcache = JM.decode_step(jparams, jcfg, jcache,
                                         jnp.asarray(tok), jnp.asarray(pos))
        logits, new = M.decode_step(params, cfg, carried,
                                    torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos))
        assert _rel(logits, jlogits) < MODEL_BOUND
        _check_cache(new, _host(jcache))
        # written in place: the returned cache holds the same tensors
        assert all(new[k] is carried[k] for k in carried)


@pytest.mark.parametrize("case", ["gemma-2b", "minitron-8b", "parallel"])
def test_lm_loss_matches_jax(case):
    jcfg, cfg = _configs(case)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
    params = params_from_numpy(_host(jparams), cfg, "cpu")
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    want = JM.lm_loss(jparams, jcfg, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    for leaf in jax.tree_util.tree_leaves(params):
        leaf.requires_grad_(True)
    got = M.lm_loss(params, cfg, {k: torch.from_numpy(v).long()
                                  for k, v in batch.items()})
    assert abs(got.item() - float(want)) < MODEL_BOUND * (float(want) + 1)
    got.backward()
    grads = [t.grad for t in jax.tree_util.tree_leaves(params)]
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0


# --------------------------------------------------------------------------
# the reference's smoke properties, on the port alone
# --------------------------------------------------------------------------
SMOKE = ["gemma-2b", "phi4-mini-3.8b", "minitron-8b", "parallel"]


def _port(case: str, seed: int, kv8: bool = False):
    cfg = _configs(case, kv8)[1]
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _tokens(cfg, B, S, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S))).long()


def _last_logits(params, cfg, toks):
    x, _, _ = M.forward(params, cfg, toks)
    return L.logits_apply(params["embed"], cfg, x[:, -1:])[:, 0]


@pytest.mark.parametrize("case", SMOKE)
def test_prefill_decode_matches_full_forward(case):
    cfg, params = _port(case, 1)
    toks = _tokens(cfg, 2, 33, 2)
    ref = _last_logits(params, cfg, toks)
    _, cache = M.prefill(params, cfg, toks[:, :32], max_len=64)
    got, _ = M.decode_step(params, cfg, cache, toks[:, 32:33],
                           torch.full((2,), 32, dtype=torch.int32))
    assert float((ref - got).abs().max()) < 5e-2


@pytest.mark.parametrize("case", SMOKE)
def test_int8_kv_cache_close_to_full_forward(case):
    cfg, params = _port(case, 1, kv8=True)
    toks = _tokens(cfg, 2, 17, 3)
    ref = _last_logits(params, cfg, toks)
    _, cache = M.prefill(params, cfg, toks[:, :16], max_len=32)
    assert cache["k"].dtype == torch.int8
    got, _ = M.decode_step(params, cfg, cache, toks[:, 16:17],
                           torch.full((2,), 16, dtype=torch.int32))
    assert float((ref - got).abs().max()) < 0.25


@pytest.mark.parametrize("case", SMOKE)
def test_multi_token_greedy_decode_consistency(case):
    """Greedy decode token by token == argmax of the full forward pass."""
    cfg, params = _port(case, 4)
    toks = _tokens(cfg, 1, 16, 5)
    logits, cache = M.prefill(params, cfg, toks[:, :8], max_len=32)
    seq = toks[0, :8].tolist()
    cur = int(torch.argmax(logits[0]))
    for step in range(3):
        seq.append(cur)
        want = int(torch.argmax(_last_logits(params, cfg,
                                             torch.tensor([seq]))[0]))
        got_logits, cache = M.decode_step(
            params, cfg, cache, torch.tensor([[cur]]),
            torch.tensor([len(seq) - 1], dtype=torch.int32))
        got = int(torch.argmax(got_logits[0]))
        assert got == want, f"step {step}: {got} != {want}"
        cur = got
