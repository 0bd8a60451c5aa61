"""Public names of ``repro``'s API that the port carries (ROADMAP F11), on
the CPU: ``kernels.idct8x8_dequant`` and ``ref.idct8x8_dequant_ref``,
the ``PSVReader`` re-export of ``wsi.slide`` and the engine's
``greedy=``.

``idct8x8_dequant`` is plain PyTorch on both sides of the comparison
(``repro``'s is jnp only). Tolerance: ``max|Δ| / (max|reference| + 1)``
< ``IDCT_BOUND`` = 1e-6 (an 8-term float32 sum per pass in another order;
measured ≤ 1.7e-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import idct8x8_dequant as jax_idct8x8_dequant
from repro.kernels import ref as jref
from repro.wsi.slide import SyntheticScanner as JaxScanner
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import model as M
from repro_torch.serve.engine import ContinuousBatchingEngine, Request
from repro_torch.wsi import slide
from repro_torch.wsi.formats import psv

IDCT_BOUND = 1e-6


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1.0))


@pytest.mark.parametrize("table", ["luma", "chroma"])
@pytest.mark.parametrize("shape", [(8, 8), (16, 128), (256, 256)])
def test_idct8x8_dequant_matches_repro(shape, table):
    """On the coefficients of a slide-like plane and of noise."""
    q = ref.JPEG_LUMA_Q if table == "luma" else ref.JPEG_CHROMA_Q
    rng = np.random.default_rng(shape[1])
    plane = rng.normal(0, 60, size=shape).astype(np.float32)
    coef = ref.dct8x8_quant_ref(torch.from_numpy(plane), q)
    want = jax_idct8x8_dequant(jnp.asarray(coef.numpy()), jnp.asarray(q))
    got = kernels.idct8x8_dequant(coef, q)
    assert got.dtype == torch.float32 and got.shape == shape
    assert _rel(got, want) < IDCT_BOUND
    assert torch.equal(got, ref.idct8x8_dequant_ref(coef, q))
    jref_out = jref.idct8x8_dequant_ref(jnp.asarray(coef.numpy()),
                                        jnp.asarray(q))
    assert _rel(got, jref_out) < IDCT_BOUND
    # the round trip stays within the quantization step (the reference's
    # property, tests/test_kernels.py)
    assert float((got - torch.from_numpy(plane)).abs().max()) <= \
        float(q.max()) * 4.0


def test_psv_reader_is_re_exported_from_slide():
    assert slide.PSVReader is psv.PSVReader
    assert slide.write_psv is psv.write_psv
    assert {"SyntheticScanner", "PSVReader", "write_psv"} <= set(
        slide.__all__)
    blob = slide.SyntheticScanner(seed=1).scan(512, 512, 256)
    assert blob == JaxScanner(seed=1).scan(512, 512, 256)
    tile = slide.PSVReader(blob).read_tile(1, 1)
    assert tile.shape == (256, 256, 3)


def test_engine_takes_greedy():
    """``greedy=`` is accepted and unread, as in repro's engine; ``impl=``
    stays."""
    cfg = get_config("gemma-2b-smoke")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = []
    for kw in ({}, {"greedy": True}, {"greedy": False, "impl": "ref"}):
        eng = ContinuousBatchingEngine(cfg, params, batch_size=2,
                                       max_len=32, **kw)
        got = {}
        eng.submit(Request(prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=3,
                           done=lambda t: got.update(out=t)))
        eng.run_until_drained()
        runs.append(got["out"])
    assert runs[0] == runs[1] == runs[2] and len(runs[0]) == 3
