"""The port's read side on the CPU vs ``repro``'s: the inverse transform
(``jpeg_inverse``), the entropy decoder (plain version of the
``entropy_decode`` kernel, and the numpy oracle) and the decode entry points.

(Each CUDA kernel vs its plain version, on a card: ``test_torch_gpu.py``.)

Inputs are made with seeded numpy and handed to both packages as arrays.

Stated tolerance for ``jpeg_inverse``. The port sums the 8×8 inverse DCT
in a fixed order (the CUDA kernel's loop); ``repro`` lets XLA pick the
order, and no order reproduces it bit for bit. Two float results can then
differ in the last ULP, which changes a pixel only when it sits at a
rounding tie. So on slide content the pixels must be **equal**, and on the
coefficients of uniform noise every mismatch must be ±1 at a tie —
``abs(abs(frac(v)) − 0.5) < 1e-4``, read from the plain version's float
sample (a tie's width grows with the magnitude: 3.05e-5 was measured) —
on at most 1e-5 of the samples (measured: ~5e-6).

The entropy decoder is integer code: coefficients, error strings and the
error chosen among several failing tiles must equal ``repro``'s exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import jpeg_inverse as jax_jpeg_inverse
from repro.kernels import jpeg_transform as jax_jpeg_transform
from repro.wsi import jpeg as J
from repro.wsi.dicom import TS_EXPLICIT_LE, TS_JPEG_BASELINE
from repro_torch.kernels import ops, ref
from repro_torch.wsi import jpeg as P
from repro_torch.wsi.entropy import _device_lut, pack_scans
from repro_torch.wsi.formats import open_slide
from repro_torch.wsi.slide import SyntheticScanner

TIE = 1e-4
MAX_MISMATCH_FRACTION = 1e-5
ENGINES = ("kernel", "numpy")


def _jax_coef(tiles_nchw: np.ndarray) -> np.ndarray:
    return np.asarray(jax_jpeg_transform(jnp.asarray(tiles_nchw)))


def _inverse_floats(coef: np.ndarray) -> np.ndarray:
    """The plain version's RGB samples before the round."""
    C = torch.from_numpy(ref.dct_matrix())
    q = ref.quant_tables(None, None, "cpu")[None, :, None, None]
    y = ref._unblocks(ref.idct_dequant_blocks(
        ref._blocks(torch.from_numpy(coef.copy())), q, C))
    return torch.stack(ref.ycbcr_inverse_polynomials(
        y[:, 0], y[:, 1], y[:, 2]), 1).numpy()


def _assert_tie_rule(expect: np.ndarray, got: np.ndarray,
                     coef: np.ndarray) -> int:
    """Every mismatch ±1 at a rounding tie; returns the mismatch count."""
    bad = expect != got
    assert np.all(np.abs(expect[bad].astype(np.int64) - got[bad]) == 1)
    v = _inverse_floats(coef)[bad]
    assert np.all(np.abs(np.abs(v - np.trunc(v)) - 0.5) < TIE), v
    return int(bad.sum())


def _slide_tiles(seed: int, hw: int = 512, tile: int = 128) -> np.ndarray:
    """(N, H, W, 3) uint8 tiles of a synthetic slide."""
    rd = open_slide(SyntheticScanner(seed=seed).scan(hw, hw, tile))
    bh, bw = rd.grid
    return np.stack([rd.read_tile(r, c) for r in range(bh)
                     for c in range(bw)])


def _nchw(tiles: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(tiles, (0, 3, 1, 2)),
                                np.float32)


def _port_coef(jpgs, engine="kernel") -> np.ndarray:
    return P.decode_coef_batch(jpgs, device="cpu", engine=engine).numpy()


def _error(fn, *args, **kw) -> str:
    """The ``ValueError`` string ``fn`` raises (it must raise one)."""
    with pytest.raises(ValueError) as ei:
        fn(*args, **kw)
    return str(ei.value)


# --------------------------------------------------------------------------
# jpeg_inverse: plain version vs repro.kernels.jpeg_inverse
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,h,w", [(1, 8, 128), (2, 64, 128), (3, 32, 256)])
@pytest.mark.parametrize("seed", [0, 1])
def test_jpeg_inverse_plain_matches_jax(n, h, w, seed):
    """The reference's own kernel test inputs: the transform of noise."""
    rng = np.random.default_rng(seed)
    coef = _jax_coef(rng.integers(0, 256, size=(n, 3, h, w))
                     .astype(np.float32))
    got = ops.jpeg_inverse(torch.from_numpy(coef.copy()))
    assert got.dtype == torch.uint8 and got.shape == coef.shape
    for impl in ("ref", "pallas"):
        expect = np.asarray(jax_jpeg_inverse(coef, impl=impl))
        _assert_tie_rule(expect, got.numpy(), coef)


def test_jpeg_inverse_noise_mismatch_rate():
    rng = np.random.default_rng(0)
    coef = _jax_coef(rng.integers(0, 256, size=(16, 3, 256, 256))
                     .astype(np.float32))
    expect = np.asarray(jax_jpeg_inverse(coef, impl="ref"))
    got = ops.jpeg_inverse(torch.from_numpy(coef.copy())).numpy()
    n = _assert_tie_rule(expect, got, coef)
    assert n <= MAX_MISMATCH_FRACTION * expect.size, (n, expect.size)


@pytest.mark.parametrize("tile", [256, 128])
def test_jpeg_inverse_exact_on_slide_content(tile):
    coef = _jax_coef(_nchw(_slide_tiles(3, 1024, tile)))
    np.testing.assert_array_equal(
        ops.jpeg_inverse(torch.from_numpy(coef.copy())).numpy(),
        np.asarray(jax_jpeg_inverse(coef, impl="ref")))


def test_jpeg_inverse_any_multiple_of_8_and_tables():
    """No 128-lane rule; custom tables ride through as in the reference."""
    rng = np.random.default_rng(4)
    coef = rng.integers(-64, 64, size=(2, 3, 24, 72)).astype(np.int32)
    ql = rng.integers(1, 100, size=(8, 8)).astype(np.float32)
    qc = rng.integers(1, 100, size=(8, 8)).astype(np.float32)
    got = ops.jpeg_inverse(torch.from_numpy(coef), ql, qc).numpy()
    expect = np.asarray(jax_jpeg_inverse(coef, jnp.asarray(ql),
                                         jnp.asarray(qc)))
    np.testing.assert_array_equal(got, expect)


def test_jpeg_inverse_contract():
    with pytest.raises(TypeError, match="int32"):
        ops.jpeg_inverse(torch.zeros((1, 3, 8, 8)))
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.jpeg_inverse(torch.zeros((1, 3, 8, 12), dtype=torch.int32))
    empty = ops.jpeg_inverse(torch.zeros((0, 3, 8, 8), dtype=torch.int32))
    assert empty.shape == (0, 3, 8, 8) and empty.dtype == torch.uint8


# --------------------------------------------------------------------------
# entropy decode: both engines vs repro's decoder, coefficient for coefficient
# --------------------------------------------------------------------------
def _content(kind: str) -> np.ndarray:
    rng = np.random.default_rng(13)
    if kind == "noise":
        return rng.integers(0, 256, size=(3, 32, 64, 3)).astype(np.uint8)
    if kind == "flat":
        tiles = np.full((3, 64, 128, 3), 200, np.uint8)
        tiles[1, 11, 13] = [0, 255, 7]  # one outlier block
        return tiles
    g = np.linspace(0, 255, 64 * 128).reshape(64, 128)
    one = np.stack([g, g[::-1], 255 - g], axis=-1).astype(np.uint8)
    return np.stack([one, one[:, ::-1], one[::-1]])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", ["noise", "flat", "gradient"])
def test_decode_coef_batch_matches_jax(kind, engine):
    tiles = _content(kind)
    jpgs = J.encode_tiles_batch(tiles)
    got = _port_coef(jpgs, engine)
    np.testing.assert_array_equal(got, J.decode_coef_batch(jpgs))
    np.testing.assert_array_equal(got, _jax_coef(_nchw(tiles)))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed,n,sparse", [(0, 1, False), (1, 3, False),
                                           (2, 2, True), (3, 4, True)])
def test_decode_coef_batch_inverts_encode(seed, n, sparse, engine):
    """decode ∘ encode is exact for any in-range coefficients (dense
    blocks up to category 10, and sparse ones with long zero runs/ZRLs)."""
    rng = np.random.default_rng(seed)
    coef = rng.integers(-1023, 1024, size=(n, 3, 16, 16)).astype(np.int32)
    if sparse:
        coef *= rng.random(coef.shape) < 0.05
    np.testing.assert_array_equal(
        _port_coef(P.encode_coef_batch(coef), engine), coef)


def test_decode_slide_tiles_pixel_identical_to_jax_and_per_tile():
    jpgs = J.encode_tiles_batch(_slide_tiles(3))
    bat = P.decode_tiles_batch(jpgs, device="cpu")
    np.testing.assert_array_equal(bat, J.decode_tiles_batch(jpgs))
    np.testing.assert_array_equal(
        bat, np.stack([P.decode_tile(j, device="cpu") for j in jpgs]))
    np.testing.assert_array_equal(
        P.decode_tile(jpgs[5], device="cpu"), J.decode_tile(jpgs[5]))


def test_entropy_decode_plain_matches_numpy_oracle_per_lane():
    """The plain kernel writes blocks in place with DC integrated — the
    numpy engine's zigzag output scattered through the inverse zigzag."""
    scans, H, W = P._scans(J.encode_tiles_batch(_slide_tiles(5, 256, 64)))
    zz = P._entropy_decode_batch(scans, H, W)
    expect = np.empty((len(scans), 3, H * W), np.int32)
    expect[:, :, P._zigzag_gather_index(H, W)] = \
        zz.transpose(0, 2, 1, 3).reshape(len(scans), 3, -1)
    coef = P.decode_scans(scans, H, W, torch.device("cpu"))
    np.testing.assert_array_equal(coef.numpy().reshape(expect.shape),
                                  expect)


def test_entropy_decode_stop_is_each_tile_last_symbol():
    """A clean lane stops at its last symbol: one DC and one EOB per unit
    of an all-zero tile; a block with one AC value adds one symbol."""
    coef = np.zeros((2, 3, 16, 16), np.int32)
    coef[1, 0, 0, 5] = 3  # luma block 0: DC, (run 4, 3), EOB
    scans, H, W = P._scans(P.encode_coef_batch(coef))
    buf, offs, nbits = (torch.from_numpy(a) for a in pack_scans(scans))
    got, stop, kind = ops.entropy_decode(
        buf, offs, nbits, _device_lut(torch.device("cpu")), H, W)
    units = 4 * 3
    assert stop.tolist() == [2 * units - 1, 2 * units]
    assert kind.tolist() == [0, 0]
    np.testing.assert_array_equal(got.numpy(), coef)


def test_decode_empty_batch_and_geometry_guard():
    assert P.decode_coef_batch([], device="cpu").shape == (0, 3, 0, 0)
    assert P.decode_tiles_batch([], device="cpu").shape == (0, 0, 0, 3)
    a = P.encode_tile(np.zeros((8, 8, 3), np.uint8), device="cpu")
    b = P.encode_tile(np.zeros((16, 16, 3), np.uint8), device="cpu")
    assert _error(P.decode_coef_batch, [a, b], device="cpu") == \
        _error(J.decode_coef_batch, [a, b])
    with pytest.raises(ValueError, match="engine"):
        P.decode_coef_batch([a], device="cpu", engine="jax")


# --------------------------------------------------------------------------
# corrupt input: the same strings as repro, from every entry point
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tissue_jpg():
    return J.encode_tile(_slide_tiles(7, 256, 128)[1])


def _assert_same_outcome(port_fn, jax_fn, blob):
    """Both raise the same ValueError string, or both decode equal arrays."""
    try:
        expect = jax_fn(blob)
    except ValueError as exc:
        assert _error(port_fn, blob) == str(exc)
        assert str(exc).startswith("corrupt JPEG")
        return
    np.testing.assert_array_equal(port_fn(blob), expect)


def _entry_points():
    """(port, repro) pairs for every decode entry point and engine."""
    return [
        (lambda b: P.decode_tile(b, device="cpu"), J.decode_tile),
        (lambda b: _port_coef([b], "kernel"),
         lambda b: J.decode_coef_batch([b])),
        (lambda b: _port_coef([b], "numpy"),
         lambda b: J.decode_coef_batch([b])),
    ]


@pytest.mark.parametrize("cut", [0, 1, 2, 3, 19, 0.25, 0.5, 0.9, -1])
def test_truncation_raises_reference_string(tissue_jpg, cut):
    n = len(tissue_jpg)
    cut = int(n * cut) if isinstance(cut, float) else (n + cut if cut < 0
                                                      else cut)
    for port_fn, jax_fn in _entry_points():
        _assert_same_outcome(port_fn, jax_fn, tissue_jpg[:cut])
        assert _error(port_fn, tissue_jpg[:cut]).startswith("corrupt JPEG")


def test_garbage_raises_reference_string(tissue_jpg):
    rng = np.random.default_rng(0)
    for blob in (b"", b"\xff", b"not a jpeg at all",
                 rng.integers(0, 256, 512).astype(np.uint8).tobytes(),
                 tissue_jpg[:30] + b"\x00" * 40):
        for port_fn, jax_fn in _entry_points():
            _assert_same_outcome(port_fn, jax_fn, blob)


def test_scan_bitflips_match_reference(tissue_jpg):
    """A flipped scan bit decodes to the reference's pixels or raises the
    reference's string, from the per-tile and the batched decoder."""
    _, _, start, _ = P._parse_jfif(tissue_jpg)
    rng = np.random.default_rng(1)
    for _ in range(12):
        mut = bytearray(tissue_jpg)
        mut[rng.integers(start, len(tissue_jpg) - 2)] ^= \
            1 << int(rng.integers(0, 8))
        blob = bytes(mut)
        _assert_same_outcome(lambda b: P.decode_tiles_batch(
            [b], device="cpu"), lambda b: J.decode_tiles_batch([b]), blob)
        _assert_same_outcome(lambda b: P.decode_tile(b, device="cpu"),
                             J.decode_tile, blob)


def test_even_length_pad_accepted(tissue_jpg):
    padded = tissue_jpg + b"\x00"
    expect = J.decode_tile(tissue_jpg)
    np.testing.assert_array_equal(P.decode_tile(padded, device="cpu"),
                                  expect)
    np.testing.assert_array_equal(
        P.decode_tiles_batch([padded], device="cpu")[0], expect)


def test_corrupt_tile_in_a_batch_raises_like_the_reference(tissue_jpg):
    """One truncated and one bit-flipped tile among good ones."""
    _, _, start, _ = P._parse_jfif(tissue_jpg)
    flipped = bytearray(tissue_jpg)
    flipped[start + 40] ^= 0x10
    batch = [tissue_jpg, tissue_jpg[: len(tissue_jpg) // 2] + b"\xff\xd9",
             bytes(flipped), tissue_jpg]
    expect = _error(J.decode_coef_batch, batch)
    for engine in ENGINES:
        assert _error(_port_coef, batch, engine) == expect


# hand-made scans (Annex-K luma tables): "00" is DC category 0; sixteen 1
# bits match no DC or AC code; an empty scan reads the guard's zeros and
# overruns at its first symbol
_EMPTY = np.zeros(0, np.uint8)
_INVALID_AT_0 = np.array([0xFF, 0xFF, 0xFF], np.uint8)
_INVALID_AT_1 = np.array([0x3F, 0xFF, 0xC0], np.uint8)  # 00 then 1×16


@pytest.mark.parametrize("lanes,kinds,want", [
    # a truncation at an earlier step beats an invalid code at a later one
    ((_EMPTY, _INVALID_AT_1), ((0, ref.ERR_TRUNC), (1, ref.ERR_INVALID)),
     "truncated scan data"),
    # at the same step, the invalid code wins
    ((_EMPTY, _INVALID_AT_0), ((0, ref.ERR_TRUNC), (0, ref.ERR_INVALID)),
     "invalid Huffman code"),
    ((_INVALID_AT_0, _EMPTY), ((0, ref.ERR_INVALID), (0, ref.ERR_TRUNC)),
     "invalid Huffman code"),
])
def test_error_priority_across_lanes(lanes, kinds, want):
    scans = [s.copy() for s in lanes]
    expect = _error(J._entropy_decode_batch, scans, 8, 8, engine="numpy")
    assert expect.endswith(want)
    assert _error(J._entropy_decode_batch, scans, 8, 8, engine="jax") == \
        expect
    assert _error(P._entropy_decode_batch, scans, 8, 8) == expect
    assert _error(P.decode_scans, scans, 8, 8, torch.device("cpu")) == expect
    buf, offs, nbits = (torch.from_numpy(a) for a in pack_scans(scans))
    _, stop, kind = ops.entropy_decode(buf, offs, nbits,
                                       _device_lut(torch.device("cpu")), 8, 8)
    assert list(zip(stop.tolist(), kind.tolist())) == list(kinds)


def test_entropy_decode_contract():
    lut = torch.zeros(4 * 65536, dtype=torch.int16)
    buf = torch.zeros(16, dtype=torch.uint8)
    offs = torch.zeros(1, dtype=torch.int64)
    nbits = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.entropy_decode(buf, offs, nbits, lut, 8, 12)
    with pytest.raises(ValueError, match="nbits"):
        ops.entropy_decode(buf, offs, nbits.long(), lut, 8, 8)
    with pytest.raises(TypeError, match="uint8"):
        ops.entropy_decode(buf.int(), offs, nbits, lut, 8, 8)
    for o, b in ((9, 0), (0, 72), (-1, 0)):  # a scan or its guard overruns
        with pytest.raises(ValueError, match="guard"):
            ops.entropy_decode(buf, torch.tensor([o]), torch.tensor(
                [b], dtype=torch.int32), lut, 8, 8)


# --------------------------------------------------------------------------
# decode_frames and the device policy
# --------------------------------------------------------------------------
def test_decode_frames_matches_jax():
    tiles = _slide_tiles(8, 256, 64)
    jpgs = J.encode_tiles_batch(tiles)
    for frames in (jpgs, jpgs[:1]):
        np.testing.assert_array_equal(
            P.decode_frames(frames, transfer_syntax=TS_JPEG_BASELINE,
                            rows=64, cols=64, device="cpu"),
            J.decode_frames(frames, transfer_syntax=TS_JPEG_BASELINE,
                            rows=64, cols=64))
    native = [t.tobytes() for t in tiles[:3]]
    np.testing.assert_array_equal(
        P.decode_frames(native, transfer_syntax=TS_EXPLICIT_LE, rows=64,
                        cols=64, device="cpu"), tiles[:3])
    for kw in (dict(transfer_syntax=TS_JPEG_BASELINE, rows=32, cols=64),
               dict(transfer_syntax=TS_EXPLICIT_LE, rows=32, cols=64),
               dict(transfer_syntax="1.2.3", rows=64, cols=64),
               dict(transfer_syntax=TS_JPEG_BASELINE, rows=0, cols=64)):
        frames = native if kw["transfer_syntax"] == TS_EXPLICIT_LE else jpgs
        assert _error(P.decode_frames, frames, device="cpu", **kw) == \
            _error(J.decode_frames, frames, **kw)


def test_decode_frames_single_frame_takes_the_batched_path(monkeypatch):
    """One frame goes through entropy_decode, not the per-tile loop."""
    jpgs = J.encode_tiles_batch(_slide_tiles(8, 256, 64)[:1])

    def per_tile_loop(*_):
        raise AssertionError("decode_frames ran the per-tile Huffman loop")

    monkeypatch.setattr(P, "_decode_blocks", per_tile_loop)
    np.testing.assert_array_equal(
        P.decode_frames(jpgs, transfer_syntax=TS_JPEG_BASELINE, rows=64,
                        cols=64, device="cpu"), J.decode_tile(jpgs[0])[None])


def _single_frame_blobs(jpg: bytes, kind: str) -> list[bytes]:
    n = len(jpg)
    if kind == "truncated":
        return [jpg[:c] for c in (0, 3, 19, n // 4, n // 2, 9 * n // 10,
                                  n - 1)]
    if kind == "garbage":
        rng = np.random.default_rng(0)
        return [b"\xff", rng.integers(0, 256, 512).astype(np.uint8)
                .tobytes(), jpg[:30] + b"\x00" * 40]
    _, _, start, _ = P._parse_jfif(jpg)
    rng = np.random.default_rng(2)
    out = []
    for _ in range(16):
        mut = bytearray(jpg)
        mut[rng.integers(start, n - 2)] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(mut))
    return out


@pytest.mark.parametrize("kind", ["truncated", "garbage", "bitflip"])
def test_decode_frames_single_corrupt_frame_matches_jax(tissue_jpg, kind):
    """A one-frame pull of a corrupt frame raises the reference's string
    (the reference decodes it per tile, the port in one batch)."""
    kw = dict(transfer_syntax=TS_JPEG_BASELINE, rows=128, cols=128)
    for blob in _single_frame_blobs(tissue_jpg, kind):
        _assert_same_outcome(
            lambda b: P.decode_frames([b], device="cpu", **kw),
            lambda b: J.decode_frames([b], **kw), blob)


@pytest.mark.parametrize("call", [
    lambda d: P.decode_coef_batch([], device=d),
    lambda d: P.decode_tiles_batch([], device=d),
    lambda d: P.decode_tile(b"", device=d),
    lambda d: P.decode_frames([], transfer_syntax=TS_JPEG_BASELINE, rows=8,
                              cols=8, device=d),
    lambda d: P.encode_tile(np.zeros((8, 8, 3), np.uint8), device=d),
    lambda d: P.encode_tiles_batch(np.zeros((1, 8, 8, 3), np.uint8),
                                   device=d),
], ids=["decode_coef_batch", "decode_tiles_batch", "decode_tile",
        "decode_frames", "encode_tile", "encode_tiles_batch"])
@pytest.mark.parametrize("device", [None, "cuda"])
def test_missing_gpu_raises(call, device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device)
