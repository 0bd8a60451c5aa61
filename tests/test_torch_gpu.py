"""The port on a CUDA card: each kernel vs its plain version, the
converter, the decoders and the RWKV6 and dense serving paths on the
card vs their CPU plain paths, the wkv kernel under autograd, the
engine's decode step as a CUDA graph against the eager step, and the
block kernels and the converter under a data mesh that names the card
twice. Every test here is marked ``gpu`` and skips without a card; the
file imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

The launch counts assume one visible card (the default data mesh is
every visible card): on a machine of several, run it under
``CUDA_VISIBLE_DEVICES=0``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.models.params import tree_defs, tree_map
from repro_torch.serve import ContinuousBatchingEngine, Request
from repro_torch.serve import steps as sv
from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                             convert_wsi_to_dicom, open_slide)
from repro_torch.wsi import jpeg as P
from repro_torch.wsi.dicom import TS_JPEG_BASELINE
from repro_torch.wsi.entropy import _device_lut, pack_scans

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


def _block_batches(rng) -> list[np.ndarray]:
    """Inputs of the 8×8 block kernels: slide tiles, noise, flat 8×8
    blocks (sums that cancel to exactly 0, which the transform does not
    divide), and the edges of their warp-per-8×32-strip walk: H = W = 8,
    W = 40 and 136 (not multiples of 32), N = 1, and (600, 3, 64, 64),
    where each persistent warp walks several strips."""
    flat = np.repeat(np.repeat(rng.integers(0, 256, size=(4, 3, 32, 32)),
                               8, axis=2), 8, axis=3).astype(np.float32)
    return [_slide_tiles(7, 1024), flat, *(
        rng.integers(0, 256, size=shape).astype(np.float32) for shape in (
            (8, 3, 256, 256), (3, 3, 24, 136), (1, 3, 8, 8), (2, 3, 16, 40),
            (1, 3, 256, 256), (600, 3, 64, 64)))]


def _custom_tables(rng):
    return tuple(rng.integers(1, 100, size=(8, 8)).astype(np.float32)
                 for _ in range(2))


def _offset_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 16 bytes into its storage."""
    buf = torch.empty(t.numel() + 16 // t.element_size(), dtype=t.dtype,
                      device=t.device)
    view = buf[16 // t.element_size():].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 0 and view.data_ptr() != buf.data_ptr()
    return view


def _block_cases(t: torch.Tensor, tables):
    """(input, tables) pairs: default tables, custom ones, and an offset
    view."""
    return ((t, (None, None)), (t, tables), (_offset_copy(t), (None, None)))


def test_jpeg_transform_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(12)
    tables = _custom_tables(rng)
    for tiles in _block_batches(rng):
        t = torch.from_numpy(tiles).to(cuda_device)
        for x, q in _block_cases(t, tables):
            n0 = ops.jpeg_transform.launches
            got = ops.jpeg_transform(x, *q)
            assert ops.jpeg_transform.launches == n0 + 1
            # same operation order, no FMA contraction: equal on any input
            assert torch.equal(got, ops.jpeg_transform(x, *q, impl="ref")), \
                (tuple(x.shape), q[0] is not None)
    empty = ops.jpeg_transform(torch.zeros((0, 3, 256, 256),
                                           device=cuda_device))
    assert empty.shape == (0, 3, 256, 256) and empty.dtype == torch.int32


@pytest.mark.parametrize("name,dtype", [("jpeg_transform", torch.float32),
                                        ("jpeg_inverse", torch.int32)])
def test_block_kernels_take_views_off_a_16_byte_boundary(cuda_device, name,
                                                         dtype):
    """The kernels read their input one 4-byte sample a lane: contiguous
    views 1, 2 and 3 elements into their storage launch once each and equal
    the plain version bit for bit."""
    fn = getattr(ops, name)
    n = 2 * 3 * 16 * 40
    buf = torch.randint(0, 256, (3 + n,), dtype=torch.int32,
                        device=cuda_device).to(dtype)
    for off in (1, 2, 3):
        x = buf[off:off + n].view(2, 3, 16, 40)
        assert x.data_ptr() % 16 == 4 * off
        n0 = fn.launches
        got = fn(x)
        assert fn.launches == n0 + 1
        assert torch.equal(got, fn(x, impl="ref")), off


@pytest.mark.parametrize("n", [6, 5, 1, 4095])
def test_block_kernels_split_over_one_card_named_twice(cuda_device, n):
    """The data mesh on one card: a batch of several tiles runs as two
    launches on views of the batch and of the result (shards within one
    tile of each other: 4095 as 2048 and 2047), equal to the whole call
    bit for bit; a batch of one runs whole, once."""
    slide = torch.from_numpy(_slide_tiles(19, 768)).to(cuda_device)
    tiles = slide.repeat(-(-n // slide.shape[0]), 1, 1, 1)[:n].contiguous()
    whole = ops.jpeg_transform(tiles)
    rgb = ops.jpeg_inverse(whole)
    shards = min(n, 2)
    with ops.use_mesh(("cuda:0", "cuda:0")):
        for fn, x, want in ((ops.jpeg_transform, tiles, whole),
                            (ops.jpeg_inverse, whole, rgb)):
            n0 = fn.launches
            got = fn(x)
            assert fn.launches == n0 + shards
            assert torch.equal(got, want), fn.__name__


def test_conversion_under_a_split_mesh_equals_one_card(cuda_device):
    psv = SyntheticScanner(seed=20).scan(1024, 1024, 256)
    uids = json.dumps(["2.25.1", "2.25.2"])

    def run(mesh, **kw):
        opt = ConvertOptions(manifest={"uids": uids}, device="cuda",
                             mesh=mesh, **kw)
        return convert_wsi_to_dicom(psv, {"slide_id": "mesh"}, options=opt)

    one = run(("cuda:0",))
    n0 = ops.jpeg_transform.launches
    assert run(("cuda:0", "cuda:0")) == one
    assert ops.jpeg_transform.launches == n0 + 2 + 2 + 1  # 16, 4, 1 tiles
    assert run(("cuda:0", "cuda:0"), pipelined=False) == one


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


def _jpgs(tiles_nchw: np.ndarray) -> list[bytes]:
    return P.encode_tiles_batch(np.ascontiguousarray(
        np.transpose(tiles_nchw, (0, 2, 3, 1)), dtype=np.uint8), device="cpu")


def test_jpeg_inverse_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(13)
    tables = _custom_tables(rng)
    for tiles in _block_batches(rng):
        t = torch.from_numpy(tiles).to(cuda_device)
        for x, q in _block_cases(t, tables):
            coef = ops.jpeg_transform(x, *q)
            if x.data_ptr() != t.data_ptr():  # the offset case
                coef = _offset_copy(coef)
            n0 = ops.jpeg_inverse.launches
            got = ops.jpeg_inverse(coef, *q)
            assert ops.jpeg_inverse.launches == n0 + 1
            assert got.dtype == torch.uint8
            assert torch.equal(got, ops.jpeg_inverse(coef, *q, impl="ref")), \
                (tuple(x.shape), q[0] is not None)
    empty = ops.jpeg_inverse(torch.zeros((0, 3, 8, 8), dtype=torch.int32,
                                         device=cuda_device))
    assert empty.shape == (0, 3, 8, 8)


def test_per_tile_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(14)
    for shape in ((3, 256, 256), (3, 24, 136)):
        img = torch.from_numpy(rng.integers(0, 256, size=shape)
                               .astype(np.float32)).to(cuda_device)
        n0 = ops.rgb2ycbcr.launches
        ycc = ops.rgb2ycbcr(img)
        assert ops.rgb2ycbcr.launches == n0 + 1
        assert torch.equal(ycc, ops.rgb2ycbcr(img, impl="ref"))
        for plane, q in ((ycc[0], None), (ycc[1], P.JPEG_CHROMA_Q)):
            n0 = ops.dct8x8_quant.launches
            got = ops.dct8x8_quant(plane, q)
            assert ops.dct8x8_quant.launches == n0 + 1
            assert torch.equal(got, ops.dct8x8_quant(plane, q, impl="ref"))


def _assert_launches_once_and_equals_plain(fn, x, *args):
    n0 = fn.launches
    got = fn(x, *args)
    assert fn.launches == n0 + 1
    assert torch.equal(got, fn(x, *args, impl="ref")), tuple(x.shape)


@pytest.mark.parametrize("h,w", [(256, 256), (8, 8), (8, 24), (8, 136),
                                 (24, 40), (2048, 24), (1024, 1536)])
def test_dct8x8_quant_kernel_matches_plain(cuda_device, h, w):
    """The one-channel block8x8 walk on noise and on planes of flat blocks
    (sums of exactly 0, which it does not divide), at the 256² instance
    and generic shapes (W = 8, 24, 40, 136: a strip's last block row ends
    before 32 columns; H = 8 and tall planes, where each persistent warp
    walks many strips), with the luma, chroma and a custom table, and on a
    view one element into its storage: bit-exact, one launch a call."""
    rng = np.random.default_rng(17)
    flat = np.repeat(np.repeat(rng.integers(-128, 128, size=(h // 8, w // 8)),
                               8, axis=0), 8, axis=1)
    tables = (None, P.JPEG_CHROMA_Q, _custom_tables(rng)[0])
    for a in (rng.normal(0, 60, size=(h, w)), flat):
        plane = torch.from_numpy(a.astype(np.float32)).to(cuda_device)
        for q in tables:
            _assert_launches_once_and_equals_plain(ops.dct8x8_quant, plane, q)
        buf = torch.empty(1 + h * w, device=cuda_device)
        view = buf[1:].view(h, w)
        view.copy_(plane)
        assert view.data_ptr() % 16 == 4
        _assert_launches_once_and_equals_plain(ops.dct8x8_quant, view)


def test_dct8x8_quant_kernel_on_colour_plane_views_equals_jpeg_transform(
        cuda_device):
    """Per tile, ``dct8x8_quant`` on the ``rgb2ycbcr`` output's views
    ``ycc[0]``, ``ycc[1]``, ``ycc[2]`` equals the whole-level
    ``jpeg_transform``'s channel on the same tile, bit for bit, with the
    Annex-K and custom tables; slide tiles and noise."""
    rng = np.random.default_rng(18)
    tables = _custom_tables(rng)
    for tiles in (_slide_tiles(9, 512),
                  rng.integers(0, 256, size=(2, 3, 256, 256)),
                  rng.integers(0, 256, size=(2, 3, 24, 136))):
        t = torch.from_numpy(tiles.astype(np.float32)).to(cuda_device)
        for ql, qc in ((None, None), tables):
            batched = ops.jpeg_transform(t, ql, qc)
            qs = (P.JPEG_LUMA_Q if ql is None else ql,
                  P.JPEG_CHROMA_Q if qc is None else qc)
            for i in range(t.shape[0]):
                ycc = ops.rgb2ycbcr(t[i])
                for c in range(3):
                    _assert_launches_once_and_equals_plain(
                        ops.dct8x8_quant, ycc[c], qs[min(c, 1)])
                    assert torch.equal(ops.dct8x8_quant(ycc[c], qs[min(c, 1)]),
                                       batched[i, c]), (tiles.shape, c)


@pytest.mark.parametrize("h,w", [(256, 256), (24, 136), (5, 7), (3, 3),
                                 (2, 5), (1, 1), (4096, 4096), (1001, 999)])
def test_rgb2ycbcr_kernel_matches_plain(cuda_device, h, w):
    """Any H·W (H·W % 4 of 0, 1, 2 and 3; the tile and large planes) and
    views 1, 2, 3 and 4 elements into their storage: bit-exact, one launch
    a call."""
    rng = np.random.default_rng(19)
    img = torch.from_numpy(rng.integers(0, 256, size=(3, h, w))
                           .astype(np.float32)).to(cuda_device)
    _assert_launches_once_and_equals_plain(ops.rgb2ycbcr, img)
    buf = torch.empty(4 + img.numel(), device=cuda_device)
    for off in (1, 2, 3, 4):
        view = buf[off:off + img.numel()].view(3, h, w)
        view.copy_(img)
        assert view.data_ptr() % 16 == (4 * off) % 16
        _assert_launches_once_and_equals_plain(ops.rgb2ycbcr, view)


def _entropy_args(scans, H, W, device):
    return (*(torch.from_numpy(a).to(device) for a in pack_scans(scans)),
            _device_lut(device), H, W)


def _assert_kernel_equals_plain(args):
    n0 = ops.entropy_decode.launches
    got = ops.entropy_decode(*args)
    assert ops.entropy_decode.launches == n0 + 1
    for name, a, b in zip(("coef", "stop", "err_kind"), got,
                          ops.entropy_decode(*args, impl="ref")):
        assert torch.equal(a, b), name
    return got


def _corrupt_lanes(scans):
    """Truncated, bit-flipped, garbage-tailed and hand-made corrupt scans
    among clean ones."""
    rng = np.random.default_rng(16)
    lanes = list(scans)
    for s in scans[:3]:
        lanes += [s[:c] for c in (0, 1, 7, s.size // 2, s.size - 1)]
        for _ in range(4):
            mut = s.copy()
            mut[rng.integers(0, mut.size)] ^= \
                np.uint8(1 << int(rng.integers(8)))
            lanes.append(mut)
        lanes.append(np.concatenate([s, rng.integers(0, 256, 64)
                                     .astype(np.uint8)]))
    return lanes + [np.zeros(0, np.uint8), np.array([0xFF] * 3, np.uint8),
                    np.array([0x3F, 0xFF, 0xC0], np.uint8)]


def test_entropy_decode_kernel_matches_plain_and_numpy(cuda_device):
    rng = np.random.default_rng(15)
    for tiles, plain in ((_slide_tiles(8, 1024), True),
                         (rng.integers(0, 256, size=(5, 3, 64, 128)), True),
                         (_slide_tiles(8, 256), True),  # one tile
                         (rng.integers(0, 256, size=(7, 3, 8, 8)), True),
                         (rng.integers(0, 256, size=(6, 3, 16, 16)), True),
                         # a long scan (~200k symbols): the lockstep takes
                         # a step of some 40 launches a symbol, so the
                         # numpy engine alone checks it
                         (rng.integers(0, 256, size=(1, 3, 256, 256)),
                          False)):
        jpgs = _jpgs(tiles)
        scans, H, W = P._scans(jpgs)
        n0 = ops.entropy_decode.launches
        got = P.decode_coef_batch(jpgs, device=cuda_device)
        assert ops.entropy_decode.launches == n0 + 1
        expect = P.decode_coef_batch(jpgs, device="cpu", engine="numpy")
        assert torch.equal(got.cpu(), expect)
        if not plain:
            continue
        _assert_kernel_equals_plain(_entropy_args(scans, H, W, cuda_device))
        # corrupt lanes beside clean ones: every output equal
        _, _, kind = _assert_kernel_equals_plain(
            _entropy_args(_corrupt_lanes(scans), H, W, cuda_device))
        assert kind.max() > 0


def test_entropy_decode_kernel_on_an_unaligned_buf_of_odd_length(
        cuda_device):
    """buf starts at an odd address, its length is not a multiple of 4 and
    the last scan's guard ends at its last byte. The kernel loads 32-bit
    words at 4-aligned addresses only (a misaligned load faults), reads
    the partial words at buf's edges bytewise, and decodes as the plain
    version does. A read of a few bytes past buf would not show here: the
    allocator rounds every buffer up."""
    scans, H, W = P._scans(_jpgs(_slide_tiles(12, 512)))
    buf, offs, nbits = pack_scans(scans)
    pad = next(p for p in (1, 2, 3, 4) if (buf.size + p) % 4)
    data = torch.from_numpy(np.concatenate([np.zeros(pad, np.uint8), buf]))
    rest = (torch.from_numpy(offs + pad).to(cuda_device),
            torch.from_numpy(nbits).to(cuda_device),
            _device_lut(cuda_device), H, W)
    plain = ops.entropy_decode(data.to(cuda_device), *rest, impl="ref")
    for lead in (1, 2, 3):
        room = torch.zeros(lead + data.numel(), dtype=torch.uint8,
                           device=cuda_device)
        room[lead:] = data.to(cuda_device)
        view = room[lead:]
        assert view.numel() % 4 and view.data_ptr() % 4
        for name, a, b in zip(("coef", "stop", "err_kind"),
                              ops.entropy_decode(view, *rest), plain):
            assert torch.equal(a, b), name


def test_entropy_decode_kernel_rounds_match_the_mirror(cuda_device):
    """The kernel's sync rounds per tile (its debug output) are the plain
    mirror's at the kernel's width, on clean and corrupt lanes."""
    rng = np.random.default_rng(17)
    for tiles in (_slide_tiles(13, 512),
                  rng.integers(0, 256, size=(2, 3, 64, 64)),
                  rng.integers(0, 256, size=(3, 3, 16, 16))):
        scans, H, W = P._scans(_jpgs(tiles))
        for lanes in (scans, _corrupt_lanes(scans)):
            args = _entropy_args(lanes, H, W, cuda_device)
            stats = torch.empty((len(lanes), 3), dtype=torch.int32,
                                device=cuda_device)
            got = ops.entropy_decode(*args, stats=stats)
            cpu = _entropy_args(lanes, H, W, torch.device("cpu"))
            *mirror, rounds = ref.entropy_decode_subseq_ref(
                *cpu, ops.ENTROPY_THREADS)
            for a, b in zip(got, mirror):
                assert torch.equal(a.cpu(), b)
            assert torch.equal(stats[:, 0].cpu(), rounds)
            assert bool((stats[:, 1] >= stats[:, 2]).all())


def test_entropy_decode_kernel_raises_like_numpy_engine(cuda_device):
    jpg = _jpgs(_slide_tiles(9, 512)[:1])[0]
    _, _, start, _ = P._parse_jfif(jpg)
    flipped = bytearray(jpg)
    flipped[start + 40] ^= 0x10
    batch = [jpg, jpg[: len(jpg) // 2] + b"\xff\xd9", bytes(flipped), jpg]
    errs = []
    for device, engine in ((cuda_device, "kernel"), ("cpu", "numpy")):
        with pytest.raises(ValueError) as ei:
            P.decode_coef_batch(batch, device=device, engine=engine)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def test_decoders_on_card_match_cpu_plain_path(cuda_device):
    jpgs = _jpgs(_slide_tiles(10, 1024))
    batched = P.decode_tiles_batch(jpgs, device=cuda_device)
    np.testing.assert_array_equal(batched,
                                  P.decode_tiles_batch(jpgs, device="cpu"))
    np.testing.assert_array_equal(
        batched, np.stack([P.decode_tile(j, device=cuda_device)
                           for j in jpgs]))
    np.testing.assert_array_equal(
        P.decode_frames(jpgs, transfer_syntax=TS_JPEG_BASELINE, rows=256,
                        cols=256, device=cuda_device), batched)


def test_decode_frames_single_frame_launches_both_kernels(cuda_device):
    jpgs = _jpgs(_slide_tiles(11, 256))
    n0 = (ops.entropy_decode.launches, ops.jpeg_inverse.launches)
    one = P.decode_frames(jpgs, transfer_syntax=TS_JPEG_BASELINE, rows=256,
                          cols=256, device=cuda_device)
    assert (ops.entropy_decode.launches - n0[0],
            ops.jpeg_inverse.launches - n0[1]) == (1, 1)
    np.testing.assert_array_equal(one[0],
                                  P.decode_tile(jpgs[0], device="cpu"))


def test_per_tile_conversion_on_card_matches_batched(cuda_device):
    psv = SyntheticScanner(seed=19).scan(768, 512, 256)
    uids = json.dumps(["2.25.3", "2.25.4"])

    def run(**kw):
        opt = ConvertOptions(manifest={"uids": uids}, **kw)
        return convert_wsi_to_dicom(psv, {"slide_id": "AB"}, options=opt)

    n0 = (ops.rgb2ycbcr.launches, ops.dct8x8_quant.launches)
    per_tile = run(device=cuda_device, batched=False)
    frames = 6 + 1  # 768x512 then 384x256
    assert (ops.rgb2ycbcr.launches - n0[0],
            ops.dct8x8_quant.launches - n0[1]) == (frames, 3 * frames)
    assert per_tile == run(device=cuda_device)
    assert per_tile == run(device="cpu", batched=False)


# the reference's bound for its wkv kernel (tests/test_kernels.py)
WKV_BOUND = 5e-4
# the kernel's passes vs their plain mirror (the same chunking, so the
# products' rounding and the order of a few sums part them), between the
# readings on an H100 of the 3xTF32 kernel (at most 1.75e-5, dS at decay
# 25) and of the kernel with each product cut to one TF32 mma (at least
# 2.3e-4), which F7's WKV_BOUND does not tell apart at every shape
MIRROR_BOUND = 6e-5


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1.0))


def _wkv_inputs(shape, decay_max: float, seed: int, device):
    rng = np.random.default_rng(seed)
    B, S, H, K = shape
    r, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    logw = -rng.uniform(0.005, decay_max, shape).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    state = (0.2 * rng.normal(size=(B, H, K, K))).astype(np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (r, k, v, logw, u, state)]


@pytest.mark.parametrize("shape", [(1, 2048, 40, 64), (1, 200, 40, 64),
                                   (2, 70, 3, 16), (1, 130, 2, 16),
                                   (3, 5, 2, 16), (1, 1, 2, 64),
                                   (1, 64, 40, 64), (2, 65, 3, 64),
                                   (4, 256, 8, 64), (1, 1023, 2, 16)])
@pytest.mark.parametrize("decay_max", [2.0, 25.0])
def test_wkv_chunk_kernel_matches_plain(cuda_device, shape, decay_max):
    a = _wkv_inputs(shape, decay_max, sum(shape), cuda_device)
    n0 = ops.wkv_chunk.launches
    out, state = ops.wkv_chunk(*a)
    assert ops.wkv_chunk.launches == n0 + 1
    want_out, want_state = ops.wkv_chunk(*a, impl="ref")
    torch.cuda.synchronize()
    for got, want in ((out, want_out), (state, want_state)):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert _rel(got, want) < WKV_BOUND


@pytest.mark.parametrize("shape", [(2, 200, 3, 64), (3, 130, 2, 16),
                                   (1, 64, 4, 64), (2, 1, 2, 16)])
@pytest.mark.parametrize("decay_max", [2.0, 25.0])
def test_wkv_chunk_scratch_matches_passes_mirror(cuda_device, shape,
                                                 decay_max):
    """Each pass on its own: the state increments and decays (pass 1), the
    states handed to each chunk and the final state (pass 2) and the
    outputs (pass 3), read from the kernel's scratch, vs the plain mirror
    of the passes (ref.wkv_chunk_passes_ref) on the card, within
    MIRROR_BOUND: float32-accurate products, not plain TF32."""
    from repro_torch.kernels import ref
    a = _wkv_inputs(shape, decay_max, 3 * sum(shape), cuda_device)
    scratch = torch.full((ops.wkv_scratch_floats(*shape),), float("nan"),
                         device=cuda_device)
    out, state = ops.wkv_chunk(*a, scratch=scratch)
    got = dict(ops.wkv_scratch_views(scratch, *shape), out=out,
               final_state=state)
    want = ref.wkv_chunk_passes_ref(*a)
    torch.cuda.synchronize()
    rels = {}
    for name in ("dS", "decay", "s_in", "final_state", "out"):
        assert got[name].shape == want[name].shape, name
        assert bool(torch.isfinite(got[name]).all()), name
        rels[name] = _rel(got[name], want[name])
    print(f"mirror {shape} decays up to {decay_max}: "
          + ", ".join(f"{n} {e:.3e}" for n, e in rels.items()))
    for name, rel in rels.items():
        assert rel < MIRROR_BOUND, (name, rel)


def test_wkv_chunk_rejects_views_off_a_16_byte_boundary(cuda_device):
    """A contiguous view one float into its storage, as an input or as the
    scratch, raises before any launch, and the card goes on working."""
    a = _wkv_inputs((1, 130, 2, 64), 2.0, 5, cuda_device)
    want, _ = ops.wkv_chunk(*a)
    buf = torch.cat([torch.zeros(1, device=cuda_device), a[0].reshape(-1)])
    n0 = ops.wkv_chunk.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.wkv_chunk(buf[1:].view(a[0].shape), *a[1:])
    scratch = torch.empty(ops.wkv_scratch_floats(1, 130, 2, 64) + 4,
                          device=cuda_device)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.wkv_chunk(*a, scratch=scratch[1:])
    assert ops.wkv_chunk.launches == n0
    got, _ = ops.wkv_chunk(*a, scratch=scratch[4:])
    assert torch.equal(got, want)


def test_wkv_chunk_kernel_extreme_decays_stay_finite(cuda_device):
    """logw at -1e8 and spread over the clip's range (ROADMAP F9): every
    decay is exp(Δ) with Δ ≤ 0, so the kernel makes no inf or NaN."""
    r, k, v, logw, u, state = _wkv_inputs((1, 300, 4, 64), 2.0, 9,
                                          cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    wide = -torch.exp(40 * torch.rand(logw.shape, generator=gen,
                                      device=cuda_device) - 20)
    for lw in (torch.full_like(logw, -1e8), wide):
        out, st = ops.wkv_chunk(r, k, v, lw, u, state)
        assert bool(torch.isfinite(out).all() and torch.isfinite(st).all())


def test_rwkv_smoke_prefill_and_decode_on_card_match_cpu(cuda_device):
    """The f32 smoke model: the card (wkv kernel, cuBLAS) vs the CPU plain
    path, to 1e-4 on logits and state (summation orders; one bf16 spacing,
    2**-7, on the bf16 token shifts)."""
    cfg = get_config("rwkv6-3b-smoke")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(cuda_device), params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 100))).long()
    n0 = ops.wkv_chunk.launches
    got, got_cache = M.prefill(card, cfg, tokens.to(cuda_device), max_len=256)
    assert ops.wkv_chunk.launches == n0 + cfg.num_layers
    want, want_cache = M.prefill(params, cfg, tokens, max_len=256)
    assert _rel(got, want) < 1e-4
    for key, t in got_cache["rwkv"].items():
        bound = 1e-4 if t.dtype == torch.float32 else 2.0 ** -7
        assert _rel(t, want_cache["rwkv"][key]) < bound, key
    tok = torch.tensor([[3], [7]])
    pos = torch.tensor([100, 100])
    got, _ = M.decode_step(card, cfg, got_cache, tok.to(cuda_device),
                           pos.to(cuda_device))
    want, _ = M.decode_step(params, cfg, want_cache, tok, pos)
    assert _rel(got, want) < 1e-4


def test_rwkv_smoke_engine_on_card_matches_cpu(cuda_device):
    cfg = get_config("rwkv6-3b-smoke")
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 70, 9)]
    runs = []
    for p in (tree_map(lambda t: t.to(cuda_device), params), params):
        eng = ContinuousBatchingEngine(cfg, p, batch_size=2, max_len=128)
        got = {}
        for i, prompt in enumerate(prompts):
            eng.submit(Request(prompt=prompt, max_new_tokens=6,
                               done=lambda t, i=i: got.update({i: t})))
        eng.run_until_drained()
        runs.append(got)
    assert runs[0] == runs[1]


@pytest.mark.parametrize("name", ["phi4-mini-3.8b-smoke",
                                  "phi4-mini-3.8b-smoke+kv8",
                                  "gemma-2b-smoke"])
def test_dense_smoke_prefill_and_decode_on_card_match_cpu(cuda_device, name):
    """The f32 dense smoke models (plain PyTorch attention; cuBLAS on the
    card) vs the CPU: logits and float K/V to 1e-4, an int8 cache within
    one step of the CPU's; two decode steps, each writing the cache in
    place on both."""
    cfg = get_config(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(cuda_device), params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 37))).long()
    got, got_cache = M.prefill(card, cfg, tokens.to(cuda_device), max_len=64)
    want, want_cache = M.prefill(params, cfg, tokens, max_len=64)
    assert _rel(got, want) < 1e-4
    for step in range(2):
        for key, t in got_cache.items():
            w = want_cache[key]
            if t.dtype == torch.float32:
                assert _rel(t, w) < 1e-4, key
            else:  # int8 K/V, int32 kv_pos
                assert (t.cpu().int() - w.int()).abs().max() <= \
                    (1 if t.dtype == torch.int8 else 0), key
        tok = torch.tensor([[3 + step], [7]])
        pos = torch.full((2,), 37 + step, dtype=torch.int32)
        got, new = M.decode_step(card, cfg, got_cache, tok.to(cuda_device),
                                 pos.to(cuda_device))
        assert all(new[k] is got_cache[k] for k in new)
        want, _ = M.decode_step(params, cfg, want_cache, tok, pos)
        assert _rel(got, want) < 1e-4


def test_wkv_chunk_gradients_flow_through_the_wrapper(cuda_device):
    """The kernel writes its outputs through raw pointers: on inputs that
    require grad, with grad mode on, the wrapper goes through WkvChunk, so
    it launches the kernel once and its outputs carry a gradient equal to
    autograd's through the plain version; under no_grad it launches and
    the outputs carry none."""
    a = _wkv_inputs((1, 130, 2, 64), 2.0, 9, cuda_device)
    xs = [t.clone().requires_grad_() for t in a]
    n0 = ops.wkv_chunk.launches
    out, state = ops.wkv_chunk(*xs)
    assert ops.wkv_chunk.launches == n0 + 1
    assert out.grad_fn is not None and state.grad_fn is not None
    got = torch.autograd.grad((out.sum(), state.sum()), xs)
    ys = [t.clone().requires_grad_() for t in a]
    out2, state2 = ref.wkv_chunked_ref(*ys)
    want = torch.autograd.grad((out2.sum(), state2.sum()), ys)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        out, state = ops.wkv_chunk(*xs)
    assert ops.wkv_chunk.launches == n0 + 2
    assert out.grad_fn is None and state.grad_fn is None


@pytest.mark.parametrize("shape", [(2, 1024, 4, 64), (1, 200, 3, 16)])
def test_wkv_function_on_card_launches_and_matches_plain(cuda_device, shape):
    """WkvChunk on the card: its forward launches the kernel once (within
    F7 of the plain version), its six gradients equal autograd through
    the plain version bit for bit (the backward is that code)."""
    a = _wkv_inputs(shape, 2.0, 11, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    g_out = torch.randn(a[0].shape, generator=gen, device=cuda_device)
    g_state = torch.randn(a[5].shape, generator=gen, device=cuda_device)
    xs = [t.clone().requires_grad_() for t in a]
    n0 = ops.wkv_chunk.launches
    out, state = ops.WkvChunk.apply(*xs)
    assert ops.wkv_chunk.launches == n0 + 1
    got = torch.autograd.grad((out, state), xs, (g_out, g_state))
    ys = [t.clone().requires_grad_() for t in a]
    out2, state2 = ref.wkv_chunked_ref(*ys)
    want = torch.autograd.grad((out2, state2), ys, (g_out, g_state))
    assert _rel(out, out2) < WKV_BOUND and _rel(state, state2) < WKV_BOUND
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _counted(fn):
    from repro_torch.roofline import analyze_step
    r = analyze_step(fn)
    torch.cuda.synchronize()
    return r["flops"], r["bytes"], r["ops"]


def test_counter_kernel_equals_plain_wkv(cuda_device):
    """A roofline counter run of ``wkv_chunk`` counts the same work with
    the kernel as with the plain version: its formula, once."""
    a = _wkv_inputs((1, 2048, 40, 64), 2.0, 12, cuda_device)
    n0 = ops.wkv_chunk.launches
    kernel = _counted(lambda: ops.wkv_chunk(*a))
    assert ops.wkv_chunk.launches == n0 + 1
    plain = _counted(lambda: ops.wkv_chunk(*a, impl="ref"))
    assert kernel == plain
    assert list(kernel[2]) == ["kernel.wkv_chunk"]


def test_counter_kernel_equals_plain_transform(cuda_device):
    tiles = torch.from_numpy(_slide_tiles(3, 1024)).to(cuda_device)
    n0 = ops.jpeg_transform.launches
    kernel = _counted(lambda: ops.jpeg_transform(tiles))
    assert ops.jpeg_transform.launches == n0 + 1
    plain = _counted(lambda: ops.jpeg_transform(tiles, impl="ref"))
    assert kernel == plain
    assert list(kernel[2]) == ["kernel.jpeg_transform"]


# the engine's decode graph (serve.steps.DecodeGraph) on reduced configs of
# the six families: case -> (arch, compute dtype; None keeps the smoke's
# float32, whose ssm and hybrid state leaves turn float32 on tick 1)
GRAPH_CASES = {
    "rwkv6": ("rwkv6-3b-smoke", None),
    "rwkv6-bf16": ("rwkv6-3b-smoke", torch.bfloat16),
    "phi4": ("phi4-mini-3.8b-smoke", None),
    "phi4-kv8": ("phi4-mini-3.8b-smoke+kv8", None),
    "mixtral": ("mixtral-8x7b-smoke", None),
    "zamba2": ("zamba2-1.2b-smoke", None),
    "zamba2-bf16": ("zamba2-1.2b-smoke", torch.bfloat16),
    "vlm": ("llama-3.2-vision-11b-smoke", None),
    "musicgen": ("musicgen-large-smoke", None),
}
# max|graph - eager| of one decode step's logits from one cache (the
# graph replays the eager step's own kernels)
GRAPH_LOGIT_BOUND = 0.0


def _graph_case(case, device):
    arch, dt = GRAPH_CASES[case]
    cfg = get_config(arch)
    if dt is not None:
        cfg = dataclasses.replace(cfg, dtype=dt)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 40, 3, 17, 9)]
    return cfg, params, prompts


def _serve(cfg, params, prompts, graphs):
    eng = ContinuousBatchingEngine(cfg, params, batch_size=2, max_len=64,
                                   graphs=graphs)
    got = {}
    for i, (p, n) in enumerate(zip(prompts, (4, 7, 3, 6, 5))):
        eng.submit(Request(prompt=p, max_new_tokens=n,
                           done=lambda t, i=i: got.update({i: t})))
    eng.run_until_drained()
    return eng, got


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_engine_tokens_equal_eager_engine(cuda_device, case):
    """One capture on the second tick, a replay on every tick from it on,
    no counted kernel launch inside the capture, and the eager engine's
    tokens."""
    cfg, params, prompts = _graph_case(case, cuda_device)
    eager, want = _serve(cfg, params, prompts, False)
    eng, got = _serve(cfg, params, prompts, None)
    assert eng.graphs and not eager.graphs
    assert got == want and eng.steps == eager.steps > 2
    assert (eng.graph_captures, eng.graph_replays) == (1, eng.steps - 1)
    assert (eager.graph_captures, eager.graph_replays) == (0, 0)
    assert eng._graph.captured_launches == 0


def _warm_engine(case, device):
    """An eager engine after its first tick (the warm-up: a float32 model's
    state leaves swapped), with requests in both slots."""
    cfg, params, prompts = _graph_case(case, device)
    eng = ContinuousBatchingEngine(cfg, params, batch_size=2, max_len=64,
                                   graphs=False)
    for p in prompts[:2]:
        eng.submit(Request(prompt=p, max_new_tokens=8))
    eng.tick()
    return eng


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_step_logits_equal_eager_step(cuda_device, case):
    """From one cache and one set of inputs, the replayed step's logits and
    the cache it writes equal the eager step's (GRAPH_LOGIT_BOUND)."""
    eng = _warm_engine(case, cuda_device)
    step = sv.make_decode_step(eng.cfg)
    c_graph = tree_map(torch.clone, eng.cache)
    c_eager = tree_map(torch.clone, eng.cache)
    tok, pos = eng._last_tok.copy(), eng.pos.copy()
    want, _ = step(eng.params, c_eager,
                   torch.as_tensor(tok, device=cuda_device)[:, None].long(),
                   torch.as_tensor(pos, device=cuda_device))
    graph = sv.DecodeGraph(step, eng.params, c_graph, 2)
    assert graph.captured_launches == 0
    got = graph(tok, pos)
    assert (got - want).abs().max().item() <= GRAPH_LOGIT_BOUND
    for (path, a), (_, b) in zip(tree_defs(c_graph),
                                 tree_defs(c_eager)):
        assert torch.equal(a, b), path
    assert graph.replays == 1


def test_graph_refuses_a_swapped_leaf_and_a_failed_capture(cuda_device):
    eng = _warm_engine("phi4", cuda_device)
    step = sv.make_decode_step(eng.cfg)
    graph = sv.DecodeGraph(step, eng.params, eng.cache, 2)
    graph(eng._last_tok, eng.pos)
    kept = eng.cache["kv_pos"]
    eng.cache["kv_pos"] = kept.clone()
    with pytest.raises(RuntimeError, match="leaf cache/kv_pos changed"):
        graph(eng._last_tok, eng.pos)
    assert graph.replays == 1
    eng.cache["kv_pos"] = kept
    graph(eng._last_tok, eng.pos)
    assert graph.replays == 2

    def syncing(params, cache, token, pos):
        logits, cache = step(params, cache, token, pos)
        if logits.sum().item() > 0:  # a host sync: capture must fail
            pass
        return logits, cache

    with pytest.raises(RuntimeError):
        sv.DecodeGraph(syncing, eng.params, tree_map(torch.clone, eng.cache),
                       2)
    torch.cuda.synchronize()
