"""The port's RWKV6 wkv against ``repro``'s, on the CPU.

The same seeded numpy inputs go through the JAX functions and the port's:
``kernels.ref.wkv_chunked_ref`` and ``kernels.ops.wkv_chunk`` (``auto`` on
CPU tensors runs the plain version) against ``repro.models.rwkv6.
wkv_chunked``, ``repro.kernels.wkv_chunk.wkv_chunk_pallas`` (interpret
mode) and the sequential oracle; then the RWKV6 block, prefill and decode
on parameters carried over from ``repro``'s ``init_params``.

Tolerances, each as ``max|Δ| / (max|reference| + 1)``:

* chunked form vs chunked form with the same chunk and sub-block: the
  float32 spacing of ``64 · decay_max``, the largest log-decay a chunk's
  prefix sum reaches (the two sum it in other orders, and every decay is
  the exponential of a difference of such sums): 1.5e-5 at decay 2, 1.2e-4
  at decay 25; measured ≤ 4e-6 and ≤ 4e-5;
* chunked vs sequential, and chunk 64 vs the Pallas kernel's chunking: the
  reference's own bound for its kernel, 5e-4 (tests/test_kernels.py);
  measured ≤ 4e-5;
* sequential vs sequential, one-token decode: 2e-6 (one order of float32
  sums per step; measured ≤ 5e-7).

``kernels.ref.wkv_chunk_passes_ref``, the CUDA kernel's passes mirrored in
plain torch (chunks of 64 with a zero-padded tail), is held to
``wkv_sequential`` by the reference's bound, 5e-4 (measured ≤ 9e-6), and to
``wkv_chunked`` by the float32 spacing of ``Q · decay_max``, Q the longest
chunk either side sums its log-decays over: 64, or S for JAX's ``Q = S``
fallback when S is not a multiple of 64 (measured ≤ 1.2e-4 at S = 200,
decay 25, against a bound of 4.9e-4; ≤ 6e-6 at decay 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.wkv_chunk import wkv_chunk_pallas
from repro.models import model as JM
from repro.models import rwkv6 as jrw
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import rwkv6 as prw
from repro_torch.models.weights import params_from_numpy

KERNEL_BOUND = 5e-4  # the reference's bound (tests/test_kernels.py)
SEQ_BOUND = 2e-6


def _inputs(B, S, H, K, decay_max, seed, state_scale=0.2):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, K)).astype(np.float32)
               for _ in range(3))
    logw = -rng.uniform(0.005, decay_max, (B, S, H, K)).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    state = (state_scale * rng.normal(size=(B, H, K, K))).astype(np.float32)
    return r, k, v, logw, u, state


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1.0))


def _chunk_tol(decay_max: float) -> float:
    return float(np.spacing(np.float32(64 * decay_max)))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


# the reference test's cases (tests/test_kernels.py) and two tail lengths
CASES = [(64, 32, 8), (128, 64, 16), (256, 64, 16), (70, 64, 16),
         (100, 64, 16)]


@pytest.mark.parametrize("S,chunk,sub", CASES)
@pytest.mark.parametrize("decay_max", [2.0, 25.0])
def test_plain_wkv_matches_jax_chunked_and_sequential(S, chunk, sub,
                                                      decay_max):
    a = _inputs(2, S, 2, 64, decay_max, S + int(decay_max))
    jo, js = jrw.wkv_chunked(*_jax(a), chunk=chunk, sub=sub)
    so, ss = jrw.wkv_sequential(*_jax(a))
    to, ts = ref.wkv_chunked_ref(*_torch(a), chunk=chunk, sub=sub)
    tol = _chunk_tol(decay_max)
    assert _rel(to, jo) < tol and _rel(ts, js) < tol
    # the wrapper (auto on the CPU: the plain version at chunk 64)
    n0 = ops.wkv_chunk.launches
    oo, os_ = ops.wkv_chunk(*_torch(a))
    assert ops.wkv_chunk.launches == n0  # no kernel on the CPU
    for out, state in ((to, ts), (oo, os_)):
        assert _rel(out, so) < KERNEL_BOUND and _rel(state, ss) < KERNEL_BOUND
        assert not torch.isnan(out).any() and not torch.isnan(state).any()


@pytest.mark.parametrize("S,chunk,sub", CASES[:3])
@pytest.mark.parametrize("decay_max", [2.0, 25.0])
def test_wrapper_matches_pallas_kernel_interpret(S, chunk, sub, decay_max):
    r, k, v, logw, u, state = _inputs(2, S, 2, 64, decay_max, 7 * S)
    state = np.zeros_like(state)  # the Pallas kernel starts from zero
    want = wkv_chunk_pallas(*_jax((r, k, v, logw, u)), chunk=chunk, sub=sub)
    got, _ = ops.wkv_chunk(*_torch((r, k, v, logw, u, state)))
    assert _rel(got, want) < KERNEL_BOUND


def test_extreme_decay_gives_no_nan():
    """logw ≈ -1e8, the clip's far end (-exp(20) ≈ -4.9e8), and logw
    spread over the clip's whole range: every decay is exp(Δ) with Δ ≤ 0,
    so nothing overflows. At these magnitudes the chunked form's prefix
    sums round in steps of 8 or more and it parts from the sequential
    oracle (the reference too, ROADMAP F9); with a uniform -1e8 the port's
    plain version still follows the reference's chunked form."""
    r, k, v, logw, u, state = _inputs(1, 128, 2, 64, 2.0, 5)
    rng = np.random.default_rng(6)
    wide = -np.exp(rng.uniform(-20, 20, logw.shape)).astype(np.float32)
    for lw in (np.full_like(logw, -1e8), wide):
        a = (r, k, v, lw, u, state)
        out, st = ops.wkv_chunk(*_torch(a))
        assert torch.isfinite(out).all() and torch.isfinite(st).all()
    jo, js = jrw.wkv_chunked(*_jax((r, k, v, np.full_like(logw, -1e8), u,
                                    state)))
    out, st = ops.wkv_chunk(*_torch((r, k, v, np.full_like(logw, -1e8), u,
                                     state)))
    assert _rel(out, jo) < SEQ_BOUND and _rel(st, js) < SEQ_BOUND


@pytest.mark.parametrize("S", [1, 17])
def test_sequential_and_decode_match_jax(S):
    a = _inputs(2, S, 3, 16, 3.0, 40 + S)
    so, ss = jrw.wkv_sequential(*_jax(a))
    po, ps = prw.wkv_sequential(*_torch(a))
    assert _rel(po, so) < SEQ_BOUND and _rel(ps, ss) < SEQ_BOUND
    r, k, v, logw, u, state = a
    jo, js = jrw.wkv_decode(*_jax((r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u,
                                   state)))
    po, ps = prw.wkv_decode(*_torch((r[:, 0], k[:, 0], v[:, 0], logw[:, 0],
                                     u, state)))
    assert _rel(po, jo) < SEQ_BOUND and _rel(ps, js) < SEQ_BOUND


# the kernel's passes, mirrored on the CPU: S across chunk edges and
# tails, both head widths, B and the initial state, small and large decays
@pytest.mark.parametrize("S", [1, 17, 64, 65, 130, 200])
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("decay_max", [2.0, 25.0])
@pytest.mark.parametrize("B,zero_state", [(1, True), (3, False)])
def test_passes_mirror_matches_jax_chunked_and_sequential(S, K, decay_max, B,
                                                          zero_state):
    a = _inputs(B, S, 2, K, decay_max, 7 * S + K + int(decay_max),
                state_scale=0.0 if zero_state else 0.2)
    m = ref.wkv_chunk_passes_ref(*_torch(a))
    assert m["out"].shape == (B, S, 2, K)
    nc = -(-S // 64)
    assert m["dS"].shape == m["s_in"].shape == (B, 2, nc, K, K)
    so, ss = jrw.wkv_sequential(*_jax(a))
    assert _rel(m["out"], so) < KERNEL_BOUND
    assert _rel(m["final_state"], ss) < KERNEL_BOUND
    jo, js = jrw.wkv_chunked(*_jax(a))
    Q = S if S % 64 else 64  # JAX's chunk: the whole sequence when S % 64
    tol = float(np.spacing(np.float32(max(Q, 64) * decay_max)))
    assert _rel(m["out"], jo) < tol and _rel(m["final_state"], js) < tol
    for t in m.values():
        assert bool(torch.isfinite(t).all())


@pytest.mark.parametrize("S", [65, 130, 200])
@pytest.mark.parametrize("K", [16, 64])
def test_passes_mirror_scratch_matches_jax_sequential(S, K):
    """Each pass's product on its own: chunk c's state increment is the
    state ``wkv_sequential`` reaches over that chunk from zero, its decay
    the exponential of the chunk's log-decay sum, and the state handed to
    chunk c the sequential state after its first 64 c positions."""
    r, k, v, logw, u, state = _inputs(3, S, 2, K, 3.0, S + K)
    m = ref.wkv_chunk_passes_ref(*_torch((r, k, v, logw, u, state)))
    zero = np.zeros_like(state)
    for c in range(-(-S // 64)):
        sl = slice(64 * c, min(64 * c + 64, S))
        _, inc = jrw.wkv_sequential(*_jax((r[:, sl], k[:, sl], v[:, sl],
                                           logw[:, sl], u, zero)))
        assert _rel(m["dS"][:, :, c], inc) < KERNEL_BOUND
        want = np.exp(logw[:, sl].astype(np.float64).sum(1))  # (B, H, K)
        assert _rel(m["decay"][:, :, c], want) < SEQ_BOUND
        _, before = jrw.wkv_sequential(*_jax((r[:, :64 * c], k[:, :64 * c],
                                              v[:, :64 * c],
                                              logw[:, :64 * c], u, state))) \
            if c else (None, state)
        assert _rel(m["s_in"][:, :, c], before) < KERNEL_BOUND


@pytest.mark.parametrize("shape", [(1, 200, 2, 64), (3, 1, 2, 16)])
def test_scratch_views_have_the_mirror_layout(shape):
    """The kernel's scratch, read through ``ops.wkv_scratch_views``, holds
    the mirror's ``dS``, ``s_in`` and ``decay`` at their shapes; the
    wrapper allocates ``ops.wkv_scratch_floats`` of it per call."""
    B, S, H, K = shape
    n = ops.wkv_scratch_floats(*shape)
    nc = -(-S // ops.WKV_CHUNK)
    assert n == B * H * nc * K * (2 * K + 1)
    views = ops.wkv_scratch_views(torch.arange(n, dtype=torch.float32),
                                  *shape)
    m = ref.wkv_chunk_passes_ref(*_torch(_inputs(*shape, 2.0, 3)))
    for name, t in views.items():
        assert t.shape == m[name].shape, name
    # the three views tile the scratch in order, with no gap or overlap
    flat = torch.cat([views[k].reshape(-1) for k in ("dS", "s_in", "decay")])
    assert torch.equal(flat, torch.arange(n, dtype=torch.float32))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = _torch(_inputs(1, 8, 2, 16, 2.0, 1))
    with pytest.raises(TypeError):
        ops.wkv_chunk(*(t.double() for t in a))
    with pytest.raises(ValueError):
        ops.wkv_chunk(*_torch(_inputs(1, 8, 2, 12, 2.0, 1)))  # K = 12
    with pytest.raises(ValueError):
        ops.wkv_chunk(a[0], a[1], a[2], a[3], a[4], a[5][:, :1])
    with pytest.raises(ValueError):
        ops.wkv_chunk(*(t[:, :0] if t.dim() == 4 and i < 4 else t
                        for i, t in enumerate(a)))
    with pytest.raises(ValueError):
        ops.wkv_chunk(*a, impl="pallas")
    # ``ref`` takes what the plain version takes (any K)
    out, _ = ops.wkv_chunk(*_torch(_inputs(1, 8, 2, 12, 2.0, 1)), impl="ref")
    assert out.shape == (1, 8, 2, 12)


@pytest.mark.parametrize("which", [0, 1, 2, 3])  # r, k, v, logw
def test_wrapper_rejects_views_off_a_16_byte_boundary(which):
    """The kernel reads r, k, v and logw in 16-byte pieces: a contiguous
    view one float into its storage is refused before any launch, on
    every device, and ``ref`` still takes it."""
    a = _torch(_inputs(1, 8, 2, 16, 2.0, 1))
    buf = torch.cat([torch.zeros(1), a[which].reshape(-1)])
    a[which] = buf[1:].view(a[which].shape)
    assert a[which].is_contiguous() and a[which].data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.wkv_chunk(*a)
    out, _ = ops.wkv_chunk(*a, impl="ref")
    assert out.shape == (1, 8, 2, 16)


# --------------------------------------------------------------------------
# the block, on parameters carried over from repro
# --------------------------------------------------------------------------
BLOCK_BOUND = 2e-5  # float32 model: summation orders of the matmuls and wkv


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config("rwkv6-3b-smoke")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    host = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    cfg = get_config("rwkv6-3b-smoke")
    return jcfg, jparams, cfg, params_from_numpy(host, cfg, "cpu")


def _layer(tree, i, torch_tree=False):
    if torch_tree:
        return {k: a[i] for k, a in tree.items()}
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    D, H, K = cfg.d_model, cfg.num_heads, cfg.head_dim
    wkv = (0.3 * rng.normal(size=(B, H, K, K))).astype(np.float32)
    # token shifts live in bf16 in the cache: make them bf16-exact
    sh = [np.array(jnp.asarray(rng.normal(size=(B, D)), jnp.bfloat16)
                     .astype(jnp.float32)) for _ in range(2)]
    return {"wkv": wkv, "shift_tm": sh[0], "shift_cm": sh[1]}


@pytest.mark.parametrize("S,with_state", [(9, False), (70, True)])
def test_rwkv_block_matches_jax(smoke, S, with_state):
    jcfg, jparams, cfg, params = smoke
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    st = _state(cfg, 2, S) if with_state else None
    jst = None if st is None else {
        "wkv": jnp.asarray(st["wkv"]),
        "shift_tm": jnp.asarray(st["shift_tm"], jnp.bfloat16),
        "shift_cm": jnp.asarray(st["shift_cm"], jnp.bfloat16)}
    pst = None if st is None else {
        "wkv": torch.from_numpy(st["wkv"]),
        "shift_tm": torch.from_numpy(st["shift_tm"]).bfloat16(),
        "shift_cm": torch.from_numpy(st["shift_cm"]).bfloat16()}
    for i in range(cfg.num_layers):
        jx, jnew = jrw.rwkv_block(_layer(jparams["layers"], i), jcfg,
                                  jnp.asarray(x), jst)
        px, pnew = prw.rwkv_block(_layer(params["layers"], i, True), cfg,
                                  torch.from_numpy(x), pst)
        assert _rel(px, jx) < BLOCK_BOUND
        for key in ("wkv", "shift_tm", "shift_cm"):
            assert _rel(pnew[key].float(), jnew[key].astype(jnp.float32)) \
                < BLOCK_BOUND


def test_rwkv_block_decode_matches_jax(smoke):
    jcfg, jparams, cfg, params = smoke
    rng = np.random.default_rng(11)
    x1 = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    st = _state(cfg, 3, 12)
    jst = {"wkv": jnp.asarray(st["wkv"]),
           "shift_tm": jnp.asarray(st["shift_tm"], jnp.bfloat16),
           "shift_cm": jnp.asarray(st["shift_cm"], jnp.bfloat16)}
    pst = {"wkv": torch.from_numpy(st["wkv"]),
           "shift_tm": torch.from_numpy(st["shift_tm"]).bfloat16(),
           "shift_cm": torch.from_numpy(st["shift_cm"]).bfloat16()}
    jx, jnew = jrw.rwkv_block_decode(_layer(jparams["layers"], 1), jcfg,
                                     jnp.asarray(x1), jst)
    px, pnew = prw.rwkv_block_decode(_layer(params["layers"], 1, True), cfg,
                                     torch.from_numpy(x1), pst)
    assert _rel(px, jx) < BLOCK_BOUND
    for key in ("wkv", "shift_tm", "shift_cm"):
        assert _rel(pnew[key].float(), jnew[key].astype(jnp.float32)) \
            < BLOCK_BOUND
