"""The port's per-tile encode path on the CPU vs ``repro``'s: the
``rgb2ycbcr`` and ``dct8x8_quant`` plain versions, ``encode_tile`` bytes,
and ``ConvertOptions(batched=False)`` study tars.

(Each CUDA kernel vs its plain version, on a card: ``test_torch_gpu.py``.)

Stated tolerance for ``dct8x8_quant`` (F4 in ROADMAP, as for the batched
``jpeg_transform``): the port sums the 8×8 DCT in a fixed order, ``repro``
lets XLA pick it (and its Pallas kernel rebuilds C with a float32 cosine).
A last-ULP difference changes a coefficient only at a rounding tie, so on
slide content the coefficients must be **equal**; on continuous random
planes every mismatch must be ±1 with ``abs(abs(frac(y/q)) − 0.5) < 1e-5``
on at most 1e-6 of the coefficients.

Stated tolerance for ``rgb2ycbcr``: the port evaluates the reference's
polynomials term by term in its order, one rounding per operation (the
CUDA kernel's arithmetic); XLA's CPU backend evaluates the same expression
with other roundings (measured: ~16 % of samples off by one ULP of the
intermediate sums, at most 2^-16). So the float planes must agree within
``2^-15`` absolute, and the quantized coefficients built from them — what
reaches the JFIF bytes — must be equal on slide content.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dct8x8_quant as jax_dct8x8_quant
from repro.kernels import rgb2ycbcr as jax_rgb2ycbcr
from repro.wsi import ConvertOptions as JaxOptions
from repro.wsi import convert_wsi_to_dicom as jax_convert
from repro.wsi import jpeg as J
from repro_torch.kernels import ops, ref
from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                             convert_wsi_to_dicom, open_slide)
from repro_torch.wsi import jpeg as P

TIE = 1e-5
MAX_MISMATCH_FRACTION = 1e-6
META = {"slide_id": "AB"}


def _uids(seed: int) -> str:
    rng = np.random.default_rng(seed)
    return json.dumps(["2.25." + "".join(map(str, rng.integers(0, 10, 30)))
                       for _ in range(2)])


def _slide_tiles(seed: int, hw: int = 512, tile: int = 256) -> np.ndarray:
    rd = open_slide(SyntheticScanner(seed=seed).scan(hw, hw, tile))
    bh, bw = rd.grid
    return np.stack([rd.read_tile(r, c) for r in range(bh)
                     for c in range(bw)])


# --------------------------------------------------------------------------
# rgb2ycbcr and dct8x8_quant: plain versions vs repro.kernels
# --------------------------------------------------------------------------
@pytest.mark.parametrize("h,w", [(8, 128), (16, 256), (64, 384), (256, 256)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb2ycbcr_plain_matches_jax(h, w, dtype):
    img = np.random.default_rng(42).integers(0, 256, size=(3, h, w))
    got = ops.rgb2ycbcr(torch.from_numpy(img.astype(np.float32)))
    assert got.dtype == torch.float32 and got.shape == (3, h, w)
    for impl in ("ref", "pallas"):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jax_rgb2ycbcr(
                jnp.asarray(img.astype(dtype)), impl=impl)),
            rtol=0, atol=2.0 ** -15)


@pytest.mark.parametrize("h,w", [(8, 128), (64, 256), (256, 384)])
@pytest.mark.parametrize("table", ["luma", "chroma"])
def test_dct8x8_quant_plain_matches_jax(h, w, table):
    q = ref.JPEG_LUMA_Q if table == "luma" else ref.JPEG_CHROMA_Q
    plane = np.random.default_rng(42).normal(0, 40, size=(h, w)) \
        .astype(np.float32)
    got = ops.dct8x8_quant(torch.from_numpy(plane), q).numpy()
    for impl in ("ref", "pallas"):
        _assert_within_tie_rule(got, plane, q, impl)


def _assert_within_tie_rule(got, plane, q, impl):
    """``got`` vs repro's ``dct8x8_quant``: every mismatch ±1 at a
    rounding tie, at most 1e-6 of the coefficients (module doc)."""
    quotient = ref._unblocks(ref._fixed_order_dct(
        ref._blocks(torch.from_numpy(plane)),
        torch.from_numpy(ref.dct_matrix())) / torch.from_numpy(
            np.asarray(q, np.float32))).numpy()
    expect = np.asarray(jax_dct8x8_quant(jnp.asarray(plane), jnp.asarray(q),
                                         impl=impl))
    bad = expect != got
    assert np.all(np.abs(expect[bad].astype(np.int64) - got[bad]) == 1)
    v = quotient[bad]
    assert np.all(np.abs(np.abs(v - np.trunc(v)) - 0.5) < TIE), v
    assert bad.sum() <= max(1, MAX_MISMATCH_FRACTION * bad.size)


def test_per_tile_transform_equals_whole_level_and_jax_on_slide():
    """rgb2ycbcr + 3 × dct8x8_quant ≡ jpeg_transform ≡ repro, per tile."""
    tiles = _slide_tiles(3, 1024)
    chw = torch.from_numpy(np.ascontiguousarray(
        np.transpose(tiles, (0, 3, 1, 2)), np.float32))
    batched = ops.jpeg_transform(chw)
    qs = (ref.JPEG_LUMA_Q, ref.JPEG_CHROMA_Q, ref.JPEG_CHROMA_Q)
    for i in range(len(tiles)):
        ycc = ops.rgb2ycbcr(chw[i])
        for c in range(3):
            coef = ops.dct8x8_quant(ycc[c], qs[c])
            assert torch.equal(coef, batched[i, c])
            np.testing.assert_array_equal(
                coef.numpy(), np.asarray(jax_dct8x8_quant(
                    jax_rgb2ycbcr(jnp.asarray(chw[i].numpy()))[c],
                    jnp.asarray(qs[c]))))


def test_per_tile_kernel_contract():
    with pytest.raises(TypeError, match="float32"):
        ops.rgb2ycbcr(torch.zeros((3, 8, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="3, H, W"):
        ops.rgb2ycbcr(torch.zeros((4, 8, 8)))
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.dct8x8_quant(torch.zeros((8, 12)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.dct8x8_quant(torch.zeros((16, 16))[::2])


@pytest.mark.parametrize("h,w", [(3, 3), (2, 5), (5, 7), (24, 136)])
@pytest.mark.parametrize("offset", [0, 1])
def test_rgb2ycbcr_plain_takes_any_contiguous_shape_and_offset(h, w, offset):
    """Every input the kernel takes (H·W % 4 of 1, 2, 3 and 0, a view one
    element into its storage) runs the plain version on the CPU, within
    the stated tolerance of repro's."""
    img = np.random.default_rng(43).integers(0, 256, size=(3, h, w)) \
        .astype(np.float32)
    buf = torch.zeros(offset + img.size)
    x = buf[offset:].view(3, h, w)
    x.copy_(torch.from_numpy(img))
    n0 = ops.rgb2ycbcr.launches
    got = ops.rgb2ycbcr(x)
    assert ops.rgb2ycbcr.launches == n0
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_rgb2ycbcr(jnp.asarray(img), impl="ref")),
        rtol=0, atol=2.0 ** -15)


@pytest.mark.parametrize("h,w", [(8, 8), (8, 24), (8, 136), (1032, 24)])
def test_dct8x8_quant_plain_matches_jax_on_narrow_planes(h, w):
    """The kernel's edge shapes (W = 8, 24, 136: strips whose last block
    row ends before 32 columns; H = 8 and a tall plane), flat blocks
    beside noise: repro's coefficients, within the stated tie rule."""
    rng = np.random.default_rng(44)
    plane = rng.normal(0, 40, size=(h, w)).astype(np.float32)
    plane[:, :8] = 17.0  # flat blocks: sums of exactly 0 but the DC
    got = ops.dct8x8_quant(torch.from_numpy(plane), ref.JPEG_CHROMA_Q)
    assert (got.numpy()[:, :8].reshape(-1, 8, 8)[:, 1:, 1:] == 0).all()
    _assert_within_tie_rule(got.numpy(), plane, ref.JPEG_CHROMA_Q, "ref")


@pytest.mark.parametrize("table", ["luma", "chroma", "custom", "list"])
def test_dct8x8_quant_table_cache(table):
    """The table the kernel reads: a contiguous float32 (8, 8) array equal
    to ``np.asarray(q, np.float32)``; a float32 table (the ``ref`` tables
    the per-tile path passes) is taken as it is, with no copy a call, and
    ``None`` is the cached, read-only Annex-K luma plane."""
    q = {"luma": ref.JPEG_LUMA_Q, "chroma": ref.JPEG_CHROMA_Q,
         "custom": np.arange(1, 65, dtype=np.float32).reshape(8, 8),
         "list": [[int(v) for v in row] for row in ref.JPEG_CHROMA_Q]}[table]
    got = ops._host_table(q)
    assert got.dtype == np.float32 and got.shape == (8, 8)
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, np.asarray(q, np.float32))
    if table != "list":
        assert got is q
    default = ops._host_table(None)
    np.testing.assert_array_equal(default, ref.JPEG_LUMA_Q)
    assert default.dtype == np.float32 and default.flags.c_contiguous
    assert not default.flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        default[0, 0] = 1.0
    assert np.shares_memory(default, ops._host_table(None))


def test_dct8x8_quant_plain_path_takes_the_cached_table(monkeypatch):
    seen, original = [], ref.dct8x8_quant_ref

    def plain(plane, qtable=None):
        seen.append(qtable)
        return original(plane, qtable)

    monkeypatch.setattr(ref, "dct8x8_quant_ref", plain)
    plane = torch.from_numpy(np.random.default_rng(45).normal(
        0, 40, size=(16, 24)).astype(np.float32))
    for q in (None, ref.JPEG_CHROMA_Q):
        got = ops.dct8x8_quant(plane, q)
        assert np.shares_memory(seen[-1], ops._host_table(q))
        assert torch.equal(got, original(plane, q))


@pytest.mark.parametrize("shape", [(64,), (8,), (8, 8, 1), (4, 16)])
def test_dct8x8_quant_rejects_tables_not_8x8(shape):
    """The kernel reads 64 floats from the table, row-major: any other
    shape is refused on every device (on the card an 8-entry table would
    be read past its end)."""
    with pytest.raises(ValueError, match=r"qtable must be \(8, 8\)"):
        ops.dct8x8_quant(torch.zeros((8, 8)), np.ones(shape, np.float32))


@pytest.mark.parametrize("name", sorted(
    __import__("repro_torch.kernels._build", fromlist=["_ENTRIES"])
    ._ENTRIES))
def test_launcher_signatures_match_their_ctypes_entries(name):
    """Each ``csrc/<name>.cu`` exports the C entry point that
    ``_build._ENTRIES`` binds, with as many parameters as it passes
    (``dct8x8_quant_launch`` takes no DCT matrix: it is compiled in)."""
    import re
    from repro_torch.kernels import _build
    symbol, argtypes = _build._ENTRIES[name]
    text = (_build.CSRC / f"{name}.cu").read_text()
    params = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)", text,
                       re.S)[1]
    assert len(params.split(",")) == len(argtypes)
    if name == "dct8x8_quant":
        assert "c_host" not in params and len(argtypes) == 6


# --------------------------------------------------------------------------
# encode_tile: JFIF bytes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,hw,tile", [(3, 512, 256), (5, 512, 128),
                                          (7, 256, 64)])
def test_encode_tile_bytes_identical_to_jax_and_batched(seed, hw, tile):
    tiles = _slide_tiles(seed, hw, tile)
    batched = P.encode_tiles_batch(tiles, device="cpu")
    assert batched == J.encode_tiles_batch(tiles)
    for t, b in zip(tiles, batched):
        jpg = P.encode_tile(t, device="cpu")
        assert jpg == J.encode_tile(t)
        assert jpg == b


def test_encode_tile_adversarial_content_matches_jax():
    """Flat tiles with one outlier, gradients and an odd 8×8 geometry:
    everything the per-coefficient loop branches on (EOB everywhere, long
    zero runs, ZRLs, DC drift)."""
    flat = np.full((64, 128, 3), 200, np.uint8)
    flat[11, 13] = [0, 255, 7]
    g = np.linspace(0, 255, 64 * 128).reshape(64, 128)
    grad = np.stack([g, g[::-1], 255 - g], axis=-1).astype(np.uint8)
    for t in (flat, grad, np.zeros((8, 8, 3), np.uint8)):
        assert P.encode_tile(t, device="cpu") == J.encode_tile(t)
    with pytest.raises(ValueError, match="multiple of 8"):
        P.encode_tile(np.zeros((12, 8, 3), np.uint8), device="cpu")


# --------------------------------------------------------------------------
# ConvertOptions(batched=False): study tars
# --------------------------------------------------------------------------
@pytest.mark.parametrize("hw,tile,min_level", [
    ((512, 512), 256, 256),
    ((512, 384), 128, 96),     # non-square, tile=128
    ((512, 512), 256, 64),     # runs into sub-tile levels (0 full frames)
])
def test_per_tile_tar_identical_to_jax_and_batched(hw, tile, min_level):
    psv = SyntheticScanner(seed=21).scan(*hw, tile)
    uids = _uids(31)
    kw = dict(min_level_size=min_level)
    jax_tar = jax_convert(psv, META, JaxOptions(
        manifest={"uids": uids}, batched=False, **kw))
    tar = convert_wsi_to_dicom(psv, META, ConvertOptions(
        manifest={"uids": uids}, batched=False, device="cpu", **kw))
    assert tar == jax_tar
    assert tar == convert_wsi_to_dicom(psv, META, ConvertOptions(
        manifest={"uids": uids}, device="cpu", **kw))


def test_per_tile_native_tar_identical_to_jax():
    psv = SyntheticScanner(seed=22).scan(512, 512, 256)
    uids = _uids(32)
    jax_tar = jax_convert(psv, META, JaxOptions(
        manifest={"uids": uids}, batched=False, jpeg=False))
    assert convert_wsi_to_dicom(psv, META, ConvertOptions(
        manifest={"uids": uids}, batched=False, jpeg=False,
        device="cpu")) == jax_tar


def test_per_tile_resume_from_batched_manifest():
    """A conversion checkpointed by the batched engine finishes per tile
    into the same tar (the engines share the manifest)."""
    psv = SyntheticScanner(seed=23).scan(1024, 512, 256)
    uids = _uids(33)
    full = convert_wsi_to_dicom(psv, META, ConvertOptions(
        manifest={"uids": uids}, device="cpu"))
    first = ConvertOptions(manifest={"uids": uids}, device="cpu")
    convert_wsi_to_dicom(psv, META, first)
    partial = {"uids": uids, "0": first.manifest["0"]}
    assert convert_wsi_to_dicom(psv, META, ConvertOptions(
        manifest=partial, batched=False, device="cpu")) == full
