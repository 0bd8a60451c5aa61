"""The port's converter (``device="cpu"``) vs ``repro``'s: whole study tars,
byte for byte, with the same seeded manifest ``"uids"``.

Also: the host codec (JFIF bytes of ``encode_coef_batch``) and the Part-10
writer against the reference on equal inputs, the port's own engines
against each other, manifest resume (including a conversion started by
``repro`` and finished by ``repro_torch``), and the device policy.
"""
import json

import numpy as np
import pytest
import torch

import repro.wsi.convert as jax_cv
import repro_torch.wsi.convert as cv
from repro.wsi import ConvertOptions as JaxOptions
from repro.wsi import convert_wsi_to_dicom as jax_convert
from repro.wsi.dicom import write_part10 as jax_write_part10
from repro.wsi.jpeg import encode_coef_batch as jax_encode_coef_batch
from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                             convert_wsi_to_dicom, study_levels)
from repro_torch.wsi.dicom import (TS_EXPLICIT_LE, TS_JPEG_BASELINE,
                                   Part10Index, write_part10)
from repro_torch.wsi.jpeg import encode_coef_batch

META = {"slide_id": "AB"}


def _uids(seed: int) -> str:
    """Deterministic study/series UIDs (the manifest's ``"uids"`` entry)."""
    rng = np.random.default_rng(seed)
    return json.dumps(["2.25." + "".join(map(str, rng.integers(0, 10, 30)))
                       for _ in range(2)])


def _port(slide, uids, **kw):
    opt = ConvertOptions(manifest={"uids": uids}, device="cpu", **kw)
    return convert_wsi_to_dicom(slide, META, options=opt), opt


def _jax(slide, uids, **kw):
    opt = JaxOptions(manifest={"uids": uids}, **kw)
    return jax_convert(slide, META, options=opt), opt


# --------------------------------------------------------------------------
# study tars: port vs reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("hw,min_level", [
    ((512, 512), 256),
    ((1024, 512), 256),   # non-square, multi-level
    ((512, 512), 64),     # runs into sub-tile levels (0 full frames)
])
def test_tar_identical_to_reference(hw, min_level):
    psv = SyntheticScanner(seed=11).scan(*hw, 256)
    uids = _uids(1)
    ref_tar, _ = _jax(psv, uids, min_level_size=min_level)
    pipe_tar, _ = _port(psv, uids, min_level_size=min_level)
    sync_tar, _ = _port(psv, uids, min_level_size=min_level, pipelined=False)
    assert pipe_tar == ref_tar
    assert sync_tar == ref_tar


def test_psv_and_tiff_tars_identical_to_reference():
    scanner = SyntheticScanner(seed=9)
    psv, tiff = scanner.scan(768, 512, 256), scanner.scan_tiff(768, 512, 256)
    uids = _uids(2)
    ref_tar, _ = _jax(psv, uids)
    for slide in (psv, tiff):
        for pipelined in (True, False):
            tar, _ = _port(slide, uids, pipelined=pipelined)
            assert tar == ref_tar


def test_native_explicit_le_tar_identical_to_reference():
    psv = SyntheticScanner(seed=5).scan(512, 512, 256)
    uids = _uids(3)
    ref_tar, _ = _jax(psv, uids, jpeg=False)
    tar, _ = _port(psv, uids, jpeg=False)
    assert tar == ref_tar
    idx = Part10Index(study_levels(tar)["level_0.dcm"])
    assert idx.get_str(0x0002, 0x0010) == TS_EXPLICIT_LE
    assert idx.n_frames == 4


def test_tile_128_tar_identical_to_reference():
    psv = SyntheticScanner(seed=6).scan(512, 384, 128)
    uids = _uids(4)
    ref_tar, _ = _jax(psv, uids, min_level_size=96)
    tar, _ = _port(psv, uids, min_level_size=96)
    assert tar == ref_tar


def test_levels_decode_and_cover_pyramid():
    psv = SyntheticScanner(seed=12).scan(1024, 1024, 256)
    cv.TRANSFER_STATS.reset()
    tar, _ = _port(psv, _uids(5))
    assert (cv.TRANSFER_STATS.uploads, cv.TRANSFER_STATS.dispatches,
            cv.TRANSFER_STATS.fetches) == (1, 1, 3)
    lv = study_levels(tar)
    assert json.loads(lv["study.json"])["levels"] == 3  # 1024 → 512 → 256
    for li, (total, frames) in enumerate([(1024, 16), (512, 4), (256, 1)]):
        idx = Part10Index(lv[f"level_{li}.dcm"])
        idx.verify()
        assert idx.get_int(0x0048, 0x0007) == total
        assert idx.get_int(0x0028, 0x0008) == frames == idx.n_frames


# --------------------------------------------------------------------------
# manifest resume, within the port and across packages
# --------------------------------------------------------------------------
def test_full_and_partial_manifest_resume_tar_identical():
    psv = SyntheticScanner(seed=13).scan(1024, 1024, 256)
    tar1, opt1 = _port(psv, _uids(6))
    full = ConvertOptions(manifest=dict(opt1.manifest), device="cpu")
    assert convert_wsi_to_dicom(psv, META, options=full) == tar1
    for pipelined in (True, False):
        partial = {"uids": opt1.manifest["uids"], "0": opt1.manifest["0"]}
        opt = ConvertOptions(manifest=partial, device="cpu",
                             pipelined=pipelined)
        assert convert_wsi_to_dicom(psv, META, options=opt) == tar1


def test_crash_mid_pyramid_checkpoints_finished_levels(monkeypatch):
    psv = SyntheticScanner(seed=15).scan(512, 512, 256)  # 2 chunks + 1 chunk
    calls = []
    real = cv.encode_coef_batch

    def flaky(coef):
        calls.append(1)
        if len(calls) == 3:  # die on level 1's (only) chunk
            raise RuntimeError("killed")
        return real(coef)

    monkeypatch.setattr(cv, "encode_coef_batch", flaky)
    opt = ConvertOptions(manifest={"uids": _uids(7)}, device="cpu")
    with pytest.raises(RuntimeError):
        convert_wsi_to_dicom(psv, META, options=opt)
    assert "0" in opt.manifest and "1" not in opt.manifest
    monkeypatch.setattr(cv, "encode_coef_batch", real)
    tar = convert_wsi_to_dicom(psv, META, options=opt)
    fresh, _ = _port(psv, opt.manifest["uids"])
    assert tar == fresh


def test_conversion_started_by_repro_resumed_by_port(monkeypatch):
    """The carried state is the manifest: a repro-written one (crashed after
    level 0) finishes in the port into repro's own tar."""
    psv = SyntheticScanner(seed=16).scan(1024, 1024, 256)
    uids = _uids(8)
    ref_tar, _ = _jax(psv, uids)

    calls = []
    real = jax_cv.encode_coef_batch

    def flaky(coef):
        calls.append(1)
        if len(calls) == 5:  # level 0 is 4 chunks; die on level 1
            raise RuntimeError("killed")
        return real(coef)

    monkeypatch.setattr(jax_cv, "encode_coef_batch", flaky)
    jax_opt = JaxOptions(manifest={"uids": uids})
    with pytest.raises(RuntimeError):
        jax_convert(psv, META, options=jax_opt)
    assert sorted(jax_opt.manifest) == ["0", "uids"]

    cv.TRANSFER_STATS.reset()
    opt = ConvertOptions(manifest=jax_opt.manifest, device="cpu")
    assert convert_wsi_to_dicom(psv, META, options=opt) == ref_tar
    assert cv.TRANSFER_STATS.fetches == 2  # levels 1 and 2 only


# --------------------------------------------------------------------------
# host codec and Part-10 writer on equal inputs
# --------------------------------------------------------------------------
def test_encode_coef_batch_jfif_bytes_identical():
    rng = np.random.default_rng(17)
    smooth = rng.integers(-40, 40, size=(3, 3, 64, 128)).astype(np.int32)
    smooth[..., 1:, :] //= 8  # mostly-small AC, long zero runs
    # AC up to category 10 everywhere, DC differences up to category 11
    dense = rng.integers(-1023, 1024, size=(2, 3, 32, 64)).astype(np.int32)
    dense[:, :, ::8, ::8] = rng.integers(-1023, 1024, size=(2, 3, 4, 8))
    flat = np.zeros((2, 3, 16, 16), np.int32)
    for coef in (smooth, dense, flat, np.zeros((0, 3, 8, 8), np.int32)):
        assert encode_coef_batch(coef) == jax_encode_coef_batch(coef)


def test_encode_coef_batch_rejects_out_of_range_like_reference():
    coef = np.zeros((1, 3, 8, 8), np.int32)
    coef[0, 0, 0, 1] = 2048  # AC category 12
    with pytest.raises(ValueError, match="AC coefficient"):
        encode_coef_batch(coef)


@pytest.mark.parametrize("ts", [TS_JPEG_BASELINE, TS_EXPLICIT_LE])
def test_write_part10_bytes_identical(ts):
    frames = [bytes([i]) * (5 + i) for i in range(4)]
    kw = dict(frames=frames, rows=16, cols=16, total_rows=32,
              total_cols=32, transfer_syntax=ts, study_uid="1.2.3",
              series_uid="1.2.3.4", sop_instance_uid="1.2.3.4.1",
              instance_number=1, metadata={0: "AB", 1: "level=0"})
    assert write_part10(**kw) == jax_write_part10(**kw)


# --------------------------------------------------------------------------
# device policy
# --------------------------------------------------------------------------
@pytest.mark.parametrize("device", [None, "cuda"])
def test_missing_gpu_raises(device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    psv = SyntheticScanner(seed=1).scan(256, 256, 256)
    assert ConvertOptions().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_wsi_to_dicom(psv, options=ConvertOptions(device=device))


def test_unaligned_slide_raises():
    from repro_torch.wsi.formats import write_psv
    tile = np.zeros((256, 256, 3), np.uint8)
    psv = write_psv({(0, 0): tile}, 200, 256, 256)
    with pytest.raises(ValueError, match="tile-aligned"):
        convert_wsi_to_dicom(psv, options=ConvertOptions(device="cpu"))

