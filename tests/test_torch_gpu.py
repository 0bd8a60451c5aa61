"""The port on a CUDA card: each kernel vs its plain version, and the
converter on the card vs its CPU plain path. Every test here is marked
``gpu`` and skips without a card; the file imports no JAX, so it runs on a
GPU machine that has none:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                             convert_wsi_to_dicom, open_slide)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _slide_tiles(seed: int, hw: int) -> np.ndarray:
    rd = open_slide(SyntheticScanner(seed=seed).scan(hw, hw, 256))
    bh, bw = rd.grid
    return np.ascontiguousarray(
        np.stack([np.transpose(rd.read_tile(r, c), (2, 0, 1))
                  for r in range(bh) for c in range(bw)]), dtype=np.float32)


def test_downsample2x2_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(11)
    for shape in ((3, 1024, 1536), (3, 34, 50), (1, 17, 35)):
        pix = torch.from_numpy(rng.integers(0, 256, size=shape)
                               .astype(np.float32)).to(cuda_device)
        n0 = ops.downsample2x2.launches
        got = ops.downsample2x2(pix)
        assert ops.downsample2x2.launches == n0 + 1
        assert torch.equal(got, ops.downsample2x2(pix, impl="ref"))


def test_jpeg_transform_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(12)
    for tiles in (_slide_tiles(7, 1024),
                  rng.integers(0, 256, size=(8, 3, 256, 256)),
                  rng.integers(0, 256, size=(3, 3, 24, 136))):
        t = torch.from_numpy(np.asarray(tiles, np.float32)).to(cuda_device)
        n0 = ops.jpeg_transform.launches
        got = ops.jpeg_transform(t)
        assert ops.jpeg_transform.launches == n0 + 1
        # same operation order, no FMA contraction: equal on any input
        assert torch.equal(got, ops.jpeg_transform(t, impl="ref"))
    empty = ops.jpeg_transform(torch.zeros((0, 3, 256, 256),
                                           device=cuda_device))
    assert empty.shape == (0, 3, 256, 256) and empty.dtype == torch.int32


def test_conversion_on_card_matches_cpu_plain_path(cuda_device):
    psv = SyntheticScanner(seed=18).scan(1024, 768, 256)
    uids = json.dumps(["2.25.1", "2.25.2"])

    def run(device, **kw):
        opt = ConvertOptions(manifest={"uids": uids}, device=device,
                             min_level_size=64, **kw)
        return convert_wsi_to_dicom(psv, {"slide_id": "AB"}, options=opt)

    cpu_tar = run("cpu")
    assert run("cuda") == cpu_tar
    assert run("cuda", pipelined=False) == cpu_tar
    assert run("cuda", jpeg=False) == run("cpu", jpeg=False)
