"""The wkv gradient: ``ops.WkvChunk`` (its forward the kernel's wrapper,
here on the CPU its plain version; its backward autograd through the plain
chunked form) against ``jax.grad`` of ``repro.models.rwkv6.wkv_chunked``,
the function ``repro`` differentiates in training, for all six inputs.

Inputs as ``tests/test_torch_wkv.py`` draws them (decays up to 2 and 25),
and a random cotangent on both outputs. Bound, as ``max|Δ| / (max|ref| +
1)`` per gradient: the float32 spacing of ``Q · decay_max``, Q the chunk
both sides sum their log-decays over (64, or S when 64 does not divide
it), as test_torch_wkv.py bounds the forward: 1.5e-5 at decay 2, 1.2e-4 at
decay 25; measured ≤ 3.8e-6 and ≤ 5.9e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401
from repro.models import rwkv6 as jrw
from repro_torch.kernels import ops, ref
from test_torch_wkv import _inputs, _rel


def _cotangents(a, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=a[0].shape).astype(np.float32),
            rng.normal(size=a[5].shape).astype(np.float32))


@pytest.mark.parametrize("S", [128, 72])
@pytest.mark.parametrize("decay_max", [2.0, 25.0])
def test_wkv_function_gradients_match_reference(S, decay_max):
    a = _inputs(2, S, 4, 16, decay_max, S + int(decay_max))
    g_out, g_state = _cotangents(a, S)

    def f(*xs):
        out, state = jrw.wkv_chunked(*xs)
        return jnp.sum(out * g_out) + jnp.sum(state * g_state)

    grad = jax.jit(jax.grad(f, argnums=tuple(range(6))))
    want = grad(*map(jnp.asarray, a))
    xs = [torch.from_numpy(x).requires_grad_() for x in a]
    out, state = ops.WkvChunk.apply(*xs)
    got = torch.autograd.grad((out, state), xs, (torch.from_numpy(g_out),
                                                 torch.from_numpy(g_state)))
    Q = S if S % 64 else 64
    tol = float(np.spacing(np.float32(Q * decay_max)))
    for name, g, w in zip(("r", "k", "v", "logw", "u", "state"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) < tol, (name, _rel(g.numpy(), w), tol)


def test_wkv_function_is_the_plain_version_on_the_cpu():
    """On CPU tensors the Function's output is the plain version's and its
    six gradients are autograd's through the plain version, bit for bit
    (the backward is that same code)."""
    a = _inputs(1, 128, 2, 16, 2.0, 3)
    g_out, g_state = (torch.from_numpy(c) for c in _cotangents(a, 4))
    xs = [torch.from_numpy(x).requires_grad_() for x in a]
    out, state = ops.WkvChunk.apply(*xs)
    got = torch.autograd.grad((out, state), xs, (g_out, g_state))
    ys = [torch.from_numpy(x).requires_grad_() for x in a]
    out2, state2 = ref.wkv_chunked_ref(*ys)
    want = torch.autograd.grad((out2, state2), ys, (g_out, g_state))
    assert torch.equal(out, out2) and torch.equal(state, state2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
