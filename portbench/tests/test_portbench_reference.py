"""The plain references against the serving program's CPU path, the
chunked wkv against the recurrence, and the float8 control against the
program's own reading, at small sizes."""

import numpy as np
import pytest
import torch

from portbench.harness.main import port_config
from portbench.harness.weights import make_params
from portbench.reference import rwkv6
from portbench.reference.common import float32_exact
from portbench.tests.portbench_tiny import CELLS, TINY, one_thread, \
    tiny_cell, tiny_run

#: float32 program against float32 reference: reordered sums only
F32_REL = 1e-4
#: the program keeps rwkv6's token shifts in bf16 in its cache (its
#: reference's layout), so a float32 decode starts from rounded shifts
RWKV_DECODE_REL = 2e-2


def _setup(family, seed=3):
    cell = tiny_cell(CELLS[family])
    model = {**cell.model, **TINY[family], "dtype": "float32"}
    params = make_params(cell.reference.layout(model), seed, "cpu",
                         torch.float32)
    return cell, model, port_config(model), params


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("family", sorted(TINY))
def test_reference_holds_the_program_prefill(family):
    """Prefills of growing prefixes (across the 64-position chunks) give
    the reference's logits at their last positions."""
    from repro_torch.models import model as M

    cell, model, cfg, params = _setup(family)
    S = 140
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, model["vocab_size"], S)).long()
    with one_thread(), torch.no_grad(), float32_exact():
        ref = cell.reference.logits(params, model, toks, 0)
        for s in (1, 17, 64, 65, 140):
            got, _ = M.prefill(params, cfg, toks[None, :s], max_len=S + 2)
            assert _rel(got[0], ref[s - 1]) < F32_REL, s


@pytest.mark.parametrize("family", sorted(TINY))
def test_reference_holds_the_program_decode(family):
    """Greedy decode steps through the program's cache give the
    reference's logits over the prompt and the decoded tokens."""
    from repro_torch.models import model as M

    cell, model, cfg, params = _setup(family)
    S, n = 90, 12
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, model["vocab_size"], S)).long()
    with one_thread(), torch.no_grad(), float32_exact():
        lg, cache = M.prefill(params, cfg, toks[None], max_len=S + n + 1)
        got, out = [lg[0]], [int(lg[0].argmax())]
        for i in range(n - 1):
            lg, cache = M.decode_step(params, cfg, cache,
                                      torch.tensor([[out[-1]]]),
                                      torch.tensor([S + i], dtype=torch.int32))
            got.append(lg[0])
            out.append(int(lg[0].argmax()))
        ref = cell.reference.logits(
            params, model, torch.cat([toks, torch.tensor(out[:-1])]), S - 1)
    bound = RWKV_DECODE_REL if family == "rwkv6" else F32_REL
    assert _rel(got[0], ref[0]) < F32_REL
    assert _rel(torch.stack(got[1:]), ref[1:]) < bound


def test_chunked_wkv_equals_the_recurrence():
    gen = torch.Generator().manual_seed(0)
    S, H, K = 150, 2, 8
    r, k, v = (torch.randn(S, H, K, generator=gen) for _ in range(3))
    # decays from 0.9975 to 0.001 a step
    logw = -torch.exp(torch.empty(S, H, K).uniform_(-6, 2, generator=gen))
    u = torch.randn(H, K, generator=gen)
    state = torch.zeros(H, K, K)
    want = []
    for t in range(S):
        kv = k[t][:, :, None] * v[t][:, None, :]
        want.append(torch.einsum("hk,hkv->hv", r[t], state + u[:, :, None] * kv))
        state = torch.exp(logw[t])[:, :, None] * state + kv
    got = rwkv6.wkv(r, k, v, logw, u)
    assert float((got - torch.stack(want)).abs().max()) < 1e-4


@pytest.mark.parametrize("family", sorted(TINY))
def test_control_reads_above_the_program(family):
    """The float8 control's widest gap over the served tokens of a bf16 run
    is above three times the program's own, on three seeds."""
    for seed in (11, 12, 13):
        _, _, notes = tiny_run(family, seed=seed, control=True)
        got = notes[-1]
        assert got["control_gap"] > 0
        assert got["control_gap"] > 3 * got["program_gap"], got
