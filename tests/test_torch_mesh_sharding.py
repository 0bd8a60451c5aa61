"""The port's data mesh (``kernels.ops``' mesh layer), the counterpart of
``tests/test_mesh_sharding.py``, on the CPU.

- the mesh context: ``default_mesh`` (the CPU alone; a scoped mesh wins),
  ``use_mesh`` scoping and restoring, ``data_sharding``'s contiguous
  shards within one row of each other (batches the mesh does not divide
  included: 5 on 4 entries is 2, 1, 1, 1; 3 on 4 lists three shards; a
  100000 × 50000 scan's 76050 tiles on 8 entries), the zero batch;
- the kernels: ``jpeg_transform`` and ``jpeg_inverse`` under a four-entry
  CPU mesh equal the one-entry call exactly, uneven batches of 3, 5 and
  12 included, each shard is computed on its own rows, and an empty shard
  runs nothing;
- a CUDA mesh over a CPU tensor raises ``ValueError``;
- the convert → store → export circle of a 512² slide (levels of 64 and
  16 tiles) and of a ragged 448² slide (49, 9 and 1) under a four-entry
  mesh: its study tar and TIFF bytes equal the one-entry mesh's and
  ``repro``'s single-device circle, computed in this process. The slides
  have 64-px tiles where the reference's test has 256: the CPU's plain
  entropy decode steps once per symbol of the longest tile (a 256² tile
  takes ~20 s an export here).
"""
import hashlib
import json

import numpy as np
import pytest
import torch

from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from repro_torch.analysis import racedep
from repro_torch.core import SimScheduler
from repro_torch.core.storage import ObjectStore
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import (data_sharding, default_mesh,
                                     jpeg_inverse, jpeg_transform, use_mesh)
from repro_torch.wsi import (ConvertOptions, DicomStoreService, ExportService,
                             SyntheticScanner, convert_wsi_to_dicom)

CPU = torch.device("cpu")
FOUR = ("cpu",) * 4
UIDS = json.dumps(["1.2.826.0.1.3680043.2.1", "1.2.826.0.1.3680043.2.2"])
TILE = 64


def _tiles(n: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 256, size=(n, 3, 16, 32)).astype(np.float32))


# --------------------------------------------------------------------------
# the mesh context
# --------------------------------------------------------------------------
def test_default_mesh_is_the_cpu_alone():
    assert default_mesh("cpu") == (CPU,)
    assert default_mesh(CPU) == (CPU,)


def test_use_mesh_scopes_and_restores():
    with use_mesh(FOUR) as m:
        assert m == (CPU,) * 4
        assert default_mesh("cpu") == m
        with use_mesh(["cpu"]) as inner:
            assert default_mesh("cpu") == inner == (CPU,)
        assert default_mesh("cpu") == m
    assert default_mesh("cpu") == (CPU,)


def test_use_mesh_is_per_thread():
    seen = []
    with use_mesh(FOUR):
        racedep.spawn(lambda: seen.append(default_mesh("cpu")),
                      name="mesh-reader").join()
    assert seen == [(CPU,)]


def test_a_mesh_names_a_device():
    with pytest.raises(ValueError, match="at least one device"):
        with use_mesh(()):
            pass


@pytest.mark.parametrize("n,want", [
    (8, [(0, 2), (2, 4), (4, 6), (6, 8)]),
    (4, [(0, 1), (1, 2), (2, 3), (3, 4)]),
    (5, [(0, 2), (2, 3), (3, 4), (4, 5)]),
    (3, [(0, 1), (1, 2), (2, 3)]),
    (0, [(0, 0)]),
])
def test_data_sharding_splits_within_one_row(n, want):
    got = data_sharding(n, FOUR)
    assert [(s.start, s.stop) for _, s in got] == want
    assert all(d == CPU for d, _ in got)
    assert [(s.start, s.stop) for _, s in data_sharding(n, ("cpu",))] \
        == [(0, n)]


@pytest.mark.parametrize("n,sizes", [
    (12, [2, 2, 2, 2, 1, 1, 1, 1]),
    (76050, [9507, 9507] + [9506] * 6),  # a 100000 × 50000 scan's level 0
])
def test_data_sharding_on_eight_entries(n, sizes):
    mesh = tuple(torch.device("cpu", i) for i in range(8))
    got = data_sharding(n, mesh)
    assert [d for d, _ in got] == list(mesh)  # mesh order
    assert [s.stop - s.start for _, s in got] == sizes
    assert [s.start for _, s in got] == [0] + [s.stop for _, s in got][:-1]
    assert got[-1][1].stop == n


# --------------------------------------------------------------------------
# the kernels under a four-entry mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [8, 5, 1, 0, 3, 12])
def test_split_kernels_equal_the_whole_call(n):
    tiles = _tiles(12)[:n]
    with use_mesh(("cpu",)):
        coef1 = jpeg_transform(tiles)
        rgb1 = jpeg_inverse(coef1)
    with use_mesh(FOUR):
        coef4 = jpeg_transform(tiles)
        rgb4 = jpeg_inverse(coef4)
    assert coef4.dtype == torch.int32 and rgb4.dtype == torch.uint8
    assert coef4.shape == rgb4.shape == (n, 3, 16, 32)
    assert torch.equal(coef4, coef1) and torch.equal(rgb4, rgb1)
    assert torch.equal(coef4, ref.jpeg_transform_ref(tiles))
    assert torch.equal(rgb4, ref.jpeg_inverse_ref(coef1))


def test_each_shard_is_computed_on_its_rows(monkeypatch):
    """A batch of 8 on four entries: four calls of 2 tiles each, in
    order; a batch of 5: calls of 2, 1, 1 and 1, in order."""
    calls = []
    plain = ref.jpeg_transform_ref

    def spy(x, *a):
        calls.append(x.clone())
        return plain(x, *a)

    monkeypatch.setattr(ref, "jpeg_transform_ref", spy)
    tiles = _tiles(8, seed=1)
    with use_mesh(FOUR):
        jpeg_transform(tiles)
        assert [c.shape[0] for c in calls] == [2, 2, 2, 2]
        assert torch.equal(torch.cat(calls), tiles)
        calls.clear()
        jpeg_transform(tiles[:5])
    assert [c.shape[0] for c in calls] == [2, 1, 1, 1]
    assert torch.equal(torch.cat(calls), tiles[:5])


def _spy_shards(monkeypatch) -> list:
    """Record ``(name, rows)`` of each plain block-kernel call."""
    shards = []
    for name in ("jpeg_transform_ref", "jpeg_inverse_ref"):
        plain = getattr(ref, name)

        def spy(x, *a, _plain=plain, _name=name):
            shards.append((_name, x.shape[0]))
            return _plain(x, *a)
        monkeypatch.setattr(ref, name, spy)
    return shards


def test_an_empty_shard_runs_nothing(monkeypatch):
    """3 tiles on four entries: three shards of one, each run once; the
    fourth entry's shard is empty and runs nothing, in either kernel."""
    shards = _spy_shards(monkeypatch)
    tiles = _tiles(3, seed=2)
    with use_mesh(FOUR):
        jpeg_inverse(jpeg_transform(tiles))
    assert shards == [("jpeg_transform_ref", 1)] * 3 \
        + [("jpeg_inverse_ref", 1)] * 3


def test_a_cuda_mesh_over_a_cpu_tensor_raises():
    tiles = _tiles(4)
    with use_mesh(("cuda:0", "cuda:0")):
        with pytest.raises(ValueError, match="mixes device types"):
            jpeg_transform(tiles)
        with pytest.raises(ValueError, match="mixes device types"):
            jpeg_inverse(torch.zeros((4, 3, 8, 8), dtype=torch.int32))


def test_the_split_path_keeps_the_kernel_contract():
    """The checks run before any split: a wrong dtype or layout raises
    under a mesh as without one."""
    with use_mesh(FOUR):
        with pytest.raises(TypeError):
            jpeg_transform(_tiles(4).double())
        with pytest.raises(ValueError, match="contiguous"):
            jpeg_transform(_tiles(4).transpose(2, 3))
        with pytest.raises(ValueError, match="multiples of 8"):
            jpeg_inverse(torch.zeros((4, 3, 12, 8), dtype=torch.int32))
    assert ops.launch_counts()["jpeg_transform"] == 0  # no card here


# --------------------------------------------------------------------------
# the convert → store → export circle
# --------------------------------------------------------------------------
def _digests(tar: bytes, derived, keys) -> tuple[str, str]:
    tifs = b"".join(derived.get(k).data for k in sorted(keys))
    return (hashlib.sha256(tar).hexdigest(),
            hashlib.sha256(tifs).hexdigest())


def _port_circle(psv: bytes, mesh, levels: int = 2,
                 min_level_size: int = 256) -> tuple[str, str]:
    tar = convert_wsi_to_dicom(
        psv, {"slide_id": "mesh"},
        ConvertOptions(manifest={"uids": UIDS}, device="cpu", mesh=mesh,
                       min_level_size=min_level_size))
    sched = SimScheduler()
    store = ObjectStore(sched)
    svc = DicomStoreService(store.bucket("dicom"), sched)
    svc.store_study_archive("studies/mesh.tar", tar)
    (study,) = svc.search_studies()
    exporter = ExportService(svc, store.bucket("derived"), device="cpu",
                             mesh=mesh)
    keys = exporter.export_study(study)
    assert len(keys) == levels
    return _digests(tar, exporter.derived, keys)


def _repro_circle(psv: bytes, min_level_size: int = 256) -> tuple[str, str]:
    """``repro``'s single-device circle (tests/test_mesh_sharding.py's
    ``_single_device_circle``, at this slide's tiles)."""
    from repro.core import SimScheduler as RSched
    from repro.core.storage import ObjectStore as RStore
    from repro.wsi.convert import ConvertOptions as ROpts
    from repro.wsi.convert import convert_wsi_to_dicom as rconvert
    from repro.wsi.export import ExportService as RExport
    from repro.wsi.store_service import DicomStoreService as RService

    tar = rconvert(psv, {"slide_id": "mesh"},
                   options=ROpts(manifest={"uids": UIDS},
                                 min_level_size=min_level_size))
    sched = RSched()
    store = RStore(sched)
    svc = RService(store.bucket("dicom"), sched)
    svc.store_study_archive("studies/mesh.tar", tar)
    (study,) = svc.search_studies()
    exporter = RExport(svc, store.bucket("derived"))
    keys = exporter.export_study(study)
    return _digests(tar, exporter.derived, keys)


def test_circle_under_a_four_entry_mesh_equals_one_entry_and_repro(
        monkeypatch):
    psv = SyntheticScanner(seed=11).scan(512, 512, TILE)
    shards = _spy_shards(monkeypatch)
    four = _port_circle(psv, FOUR)
    # both levels (64 and 16 frames) split four ways, forward and inverse
    assert shards == [("jpeg_transform_ref", 16)] * 4 \
        + [("jpeg_transform_ref", 4)] * 4 + [("jpeg_inverse_ref", 16)] * 4 \
        + [("jpeg_inverse_ref", 4)] * 4
    shards.clear()
    one = _port_circle(psv, ("cpu",))
    assert shards == [("jpeg_transform_ref", 64), ("jpeg_transform_ref", 16),
                      ("jpeg_inverse_ref", 64), ("jpeg_inverse_ref", 16)]
    assert four == one
    assert _port_circle(psv, None) == one  # the ambient mesh: the CPU
    assert four == _repro_circle(psv)


def test_ragged_circle_under_a_four_entry_mesh_equals_one_entry_and_repro(
        monkeypatch):
    """A 448² slide with levels down to one tile: 49, 9 and 1 tiles, none
    of which four divides, split 13/12/12/12, 3/2/2/2 and 1 (4 + 4 + 1
    calls a kernel)."""
    psv = SyntheticScanner(seed=11).scan(448, 448, TILE)
    shards = _spy_shards(monkeypatch)
    four = _port_circle(psv, FOUR, levels=3, min_level_size=TILE)
    for name in ("jpeg_transform_ref", "jpeg_inverse_ref"):
        assert [n for k, n in shards if k == name] == \
            [13, 12, 12, 12, 3, 2, 2, 2, 1]
    shards.clear()
    one = _port_circle(psv, ("cpu",), levels=3, min_level_size=TILE)
    assert [n for _, n in shards] == [49, 9, 1] * 2
    assert four == one
    assert four == _repro_circle(psv, min_level_size=TILE)
