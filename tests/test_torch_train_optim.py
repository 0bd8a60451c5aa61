"""The port's AdamW (``repro_torch.train.optim``) against ``repro``'s on
the same numpy trees: bf16 and float32 parameters, bf16 and float32
gradients, with the clip inactive and active.

Bounds: ``lr_at`` within 4 float32 ULPs of the reference's (``cos`` of
two libraries; measured 2); ``global_norm`` within 4 ULPs of the float64
norm (measured ≤ 0.5) and within ``NORM_REL`` (2e-6) of the reference's,
whose CPU sum parts from the float64 norm by up to 9.7e-7; the first and
second moments within ``MOMENT_ULPS`` (2) float32 ULPs of the reference's
(measured 0 without the clip), plus, with the clip on, the two norms'
relative difference times the leaf's largest moment, which the clip's
scale carries into every term of a moment, twice over for ``m`` and four
times for ``v`` (the scale squared; terms of two steps may cancel); updated bf16 parameters equal, updated float32 parameters within
``PARAM_ULPS`` (2) ULPs. The update writes the port's parameters and
moments in place.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401
from repro.train import optim as J
from repro_torch.train import optim as P

NORM_REL = 2e-6
MOMENT_ULPS = 2
PARAM_ULPS = 2
SHAPES = {"a": (64, 32), "b": {"c": (16,), "d": (2, 8, 8)}, "e": ()}
DTYPES = {"a": "bf16", "b": {"c": "f32", "d": "bf16"}, "e": "f32"}


def _tree(fn, shapes=SHAPES, dtypes=DTYPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, shapes[k], dtypes[k]) for k in shapes}
    return fn(shapes, dtypes)


def _numpy(seed: int, scale: float):
    rng = np.random.default_rng(seed)
    return _tree(lambda s, d: (scale * rng.normal(size=s)).astype(
        np.float32))


def _jax(tree, dtypes=DTYPES):
    if isinstance(tree, dict):
        return {k: _jax(tree[k], dtypes[k]) for k in tree}
    return jnp.asarray(tree, jnp.bfloat16 if dtypes == "bf16"
                       else jnp.float32)


def _torch(tree, dtypes=DTYPES):
    if isinstance(tree, dict):
        return {k: _torch(tree[k], dtypes[k]) for k in tree}
    return torch.from_numpy(np.array(tree)).to(
        torch.bfloat16 if dtypes == "bf16" else torch.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(
            tree.float() if isinstance(tree, torch.Tensor)
            else jnp.asarray(tree, jnp.float32), np.float64)


def _spacing(want):
    return np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)


def _ulps(got, want) -> float:
    """max |got - want| in float32 ULPs of ``want``."""
    return float((np.abs(got - want) / _spacing(want)).max())


def test_lr_schedule_matches_reference():
    tc = J.TrainConfig(lr=3e-3, warmup_steps=5, total_steps=40)
    ptc = P.TrainConfig(lr=3e-3, warmup_steps=5, total_steps=40)
    for step in range(0, 46):
        want = float(J.lr_at(tc, jnp.int32(step)))
        got = float(P.lr_at(ptc, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 4 * np.spacing(np.float32(want)), step


def test_global_norm_matches_reference():
    g = _numpy(1, 0.3)
    exact = np.sqrt(sum(np.sum(v ** 2) for _, v in _flat(_torch(g))))
    want = float(J.global_norm(_jax(g)))
    got = float(P.global_norm(_torch(g)))
    assert abs(got - exact) <= 4 * np.spacing(np.float32(exact))
    assert abs(got - want) <= NORM_REL * want


@pytest.mark.parametrize("grad_scale", [0.005, 0.5])
def test_adamw_update_matches_reference(grad_scale):
    """Two steps from zero moments; ``grad_scale`` 0.005 keeps the global
    norm below the clip (scale 1), 0.5 puts it above."""
    tc = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jp, tp = _jax(_numpy(0, 1.0)), _torch(_numpy(0, 1.0))
    jopt, topt = J.init_opt(jp), P.init_opt(tp)
    for step in range(2):
        g = _numpy(10 + step, grad_scale)
        jp, jopt, jm = J.adamw_update(J.TrainConfig(**tc), jp, _jax(g), jopt)
        same = tp
        tp, topt, tm = P.adamw_update(P.TrainConfig(**tc), tp, _torch(g),
                                      topt)
        assert tp is same  # in place
        assert (float(jm["grad_norm"]) > 1.0) == (grad_scale == 0.5)
        assert int(topt["count"]) == int(jopt["count"]) == step + 1
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= np.spacing(
            np.float32(float(jm["lr"])))
        jn, tn = float(jm["grad_norm"]), float(tm["grad_norm"])
        assert abs(tn - jn) <= NORM_REL * jn
        clip_rel = abs(tn - jn) / jn if jn > 1.0 else 0.0
        for key, times in (("m", 2), ("v", 4)):
            want = dict(_flat(jopt[key]))
            for name, got in _flat(topt[key]):
                w = want[name]
                lim = (MOMENT_ULPS * _spacing(w)
                       + times * clip_rel * np.abs(w).max())
                assert (np.abs(got - w) <= lim).all(), (key, name)
        want = dict(_flat(jp))
        for (name, got), dt in zip(_flat(tp), ("bf16", "f32", "bf16",
                                               "f32")):
            if dt == "bf16":
                assert np.array_equal(got, want[name]), name
            else:
                assert _ulps(got, want[name]) <= PARAM_ULPS, name
