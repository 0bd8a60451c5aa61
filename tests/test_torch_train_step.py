"""The port's train step (``repro_torch.train``) against ``repro``'s on one
carried state, for the dense, moe and ssm families' reduced configs (the
hybrid, vlm and audio families: ``test_torch_train_families.py``), with
the bounds ``tests/_torch_train.py`` states; gradient accumulation, the
remat policies and the stacked-layer split on the port alone."""
import numpy as np
import pytest
import torch

import _torch_train as T
from _torch_train import one_torch_thread  # noqa: F401
from repro_torch.models import model as M
from repro_torch.models.params import tree_map
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.optim import init_opt
from repro_torch.train.step import loss_and_grads


@pytest.mark.parametrize("family", ["dense", "moe", "ssm"])
def test_step_matches_reference(family):
    T.check_step(T.FAMILY_ARCHS[family])


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_microbatched_step_matches_reference(family):
    T.check_step(T.FAMILY_ARCHS[family], microbatches=2)


def _step(cfg, params, b, **tc):
    state = {"params": tree_map(torch.clone, params),
             "opt": init_opt(params)}
    return make_train_step(cfg, TrainConfig(lr=1e-3, **tc))(state, b)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_two_microbatches_match_one(family):
    """k = 2 sums two half-batch gradients in float32 and halves them:
    the loss within 1e-6 and the first moments (0.1 · clipped grads)
    within ``|Δ| ≤ 2·2^-7·|m| + 3e-3·max|m leaf|`` of one full-batch
    step's: each half's gradient is rounded to bf16 before the sum, as
    the reference's scan rounds it, a step relative to the half, which is
    larger than the sum where the halves cancel (measured 1.47e-3 of the
    leaf's largest at worst, gemma-2b's and rwkv6-3b's reduced configs)."""
    _, _, cfg, params = T.carried(T.FAMILY_ARCHS[family])
    b = T.to_torch(T.batch(cfg))
    one, m1 = _step(cfg, params, b)
    two, m2 = _step(cfg, params, b, microbatches=2)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-6 * float(
        m1["loss"])
    got = T.leaves(two["opt"]["m"])
    for k, w in T.leaves(one["opt"]["m"]).items():
        lim = 2 * T.BF16_REL * np.abs(w) + 3e-3 * np.abs(w).max()
        assert (np.abs(got[k] - w) <= lim).all(), k


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "vlm",
                                    "audio"])
def test_remat_policies_give_equal_gradients(family):
    """remat none / nothing / dots: the same loss and gradients, bit for
    bit (the recompute runs the same ops on the same values)."""
    import dataclasses
    _, _, cfg, params = T.carried(T.FAMILY_ARCHS[family])
    b = T.to_torch(T.batch(cfg, B=2, S=16))
    got = {}
    for remat in ("none", "nothing", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        loss, grads = loss_and_grads(params, c, b)
        got[remat] = (float(loss), T.leaves(grads))
    for remat in ("nothing", "dots"):
        assert got[remat][0] == got["none"][0]
        for k, g in got["none"][1].items():
            assert np.array_equal(got[remat][1][k], g), (remat, k)


@pytest.mark.parametrize("family", ["ssm", "hybrid", "vlm"])
def test_unbind_and_slices_give_equal_gradients(family, monkeypatch):
    """The forward's one ``torch.unbind`` a stack and per-layer ``a[i]``
    slices give the same gradients bit for bit."""
    _, _, cfg, params = T.carried(T.FAMILY_ARCHS[family])
    b = T.to_torch(T.batch(cfg, B=2, S=16))
    want = T.leaves(loss_and_grads(params, cfg, b)[1])
    monkeypatch.setattr(M, "_unstack", lambda tree, n: [
        M._layer(tree, i) for i in range(n)])
    got = T.leaves(loss_and_grads(params, cfg, b)[1])
    for k, g in want.items():
        assert np.array_equal(got[k], g), k
