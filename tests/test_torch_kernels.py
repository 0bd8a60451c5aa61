"""The port's kernels: plain versions vs the JAX package, on the CPU.

(Each CUDA kernel vs its plain version, on a card: ``test_torch_gpu.py``.)

Inputs are made with seeded numpy and handed to both packages as arrays.

Stated tolerance for ``jpeg_transform``. The port sums the 8×8 DCT in a
fixed order (the CUDA kernel's loop); the JAX reference lets its backend
pick the order. The two can then differ in the last ULP of ``y / q``, which
changes the rounded coefficient only when the quotient sits at a rounding
tie. So on slide content the coefficients must be **equal**, and on
adversarial content (uniform noise) every mismatch must be off by exactly
±1 at a tie — ``abs(abs(frac(y/q)) − 0.5) < 1e-5``, read from the plain
version's float quotient — and mismatches may be at most 1e-6 of the
coefficients (measured: 3 in 12.58M on uniform noise, 0 on slide tiles).
``downsample2x2`` works on exact integers and must match bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import downsample2x2 as jax_downsample2x2
from repro.kernels import jpeg_transform as jax_jpeg_transform
from repro_torch.kernels import ops, ref
from repro_torch.wsi.formats import open_slide
from repro_torch.wsi.slide import SyntheticScanner

TIE = 1e-5
MAX_MISMATCH_FRACTION = 1e-6


def _assert_tie_rule(expect: np.ndarray, got: np.ndarray,
                     quotient: np.ndarray) -> None:
    """Every mismatch ±1 at a rounding tie, and at most 1e-6 of values."""
    bad = expect != got
    n = int(bad.sum())
    assert np.all(np.abs(expect[bad].astype(np.int64) - got[bad]) == 1)
    q = quotient[bad]
    assert np.all(np.abs(np.abs(q - np.trunc(q)) - 0.5) < TIE), q
    assert n <= MAX_MISMATCH_FRACTION * expect.size, (n, expect.size)


def _slide_tiles(seed: int, hw: int = 1024, tile: int = 256) -> np.ndarray:
    rd = open_slide(SyntheticScanner(seed=seed).scan(hw, hw, tile))
    bh, bw = rd.grid
    return np.ascontiguousarray(
        np.stack([np.transpose(rd.read_tile(r, c), (2, 0, 1))
                  for r in range(bh) for c in range(bw)]), dtype=np.float32)


# --------------------------------------------------------------------------
# downsample2x2: plain versions vs repro.kernels.downsample2x2, exact
# --------------------------------------------------------------------------
@pytest.mark.parametrize("c,h,w", [
    (3, 16, 256), (1, 32, 512), (4, 64, 256),   # tests/test_kernels.py
    (3, 256, 768), (3, 512, 1280),              # odd tile counts across
    (3, 34, 50), (3, 17, 35),                   # odd halves, odd edges
])
def test_downsample_plain_matches_jax(c, h, w):
    rng = np.random.default_rng(1000 * c + h + w)
    pix = rng.integers(0, 256, size=(c, h, w)).astype(np.float32)
    mean_jax = np.asarray(jax_downsample2x2(jnp.asarray(pix)))
    np.testing.assert_array_equal(
        ref.downsample2x2_ref(torch.from_numpy(pix)).numpy(), mean_jax)
    chain_jax = np.clip(np.round(mean_jax), 0, 255)
    got = ops.downsample2x2(torch.from_numpy(pix))
    assert got.dtype == torch.float32 and got.shape == (c, h // 2, w // 2)
    np.testing.assert_array_equal(got.numpy(), chain_jax)
    # real-valued input (the tests/test_kernels.py distribution): the taps
    # are summed in the reference's order, so even the float mean is equal
    x = rng.normal(0, 50, size=(c, h, w)).astype(np.float32)
    np.testing.assert_array_equal(
        ref.downsample2x2_ref(torch.from_numpy(x)).numpy(),
        np.asarray(jax_downsample2x2(jnp.asarray(x))))


def test_downsample_rounds_half_to_even():
    # sums ≡ 2 (mod 4) are exact .5 means: 0.5 → 0, 1.5 → 2, 2.5 → 2
    pix = np.array([[[0, 1, 1, 2, 2, 3], [0, 1, 2, 2, 3, 2]]], np.float32)
    got = ops.downsample2x2(torch.from_numpy(pix)).numpy()
    np.testing.assert_array_equal(got, [[[0.0, 2.0, 2.0]]])


# --------------------------------------------------------------------------
# jpeg_transform: plain version vs repro.kernels.jpeg_transform
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [3, 21])
def test_jpeg_transform_exact_on_slide_content(seed):
    tiles = _slide_tiles(seed)
    got = ops.jpeg_transform(torch.from_numpy(tiles))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_jpeg_transform(jnp.asarray(tiles))))


@pytest.mark.parametrize("n,h,w", [(1, 8, 128), (2, 64, 128), (3, 32, 256),
                                   (2, 24, 72)])
@pytest.mark.parametrize("seed", [0, 1])
def test_jpeg_transform_noise_matrix_within_tie_rule(n, h, w, seed):
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 256, size=(n, 3, h, w)).astype(np.float32)
    t = torch.from_numpy(tiles)
    got = ops.jpeg_transform(t).numpy()
    expect = np.asarray(jax_jpeg_transform(jnp.asarray(tiles)))
    _assert_tie_rule(expect, got, ref.jpeg_quotient_ref(t).numpy())


def test_jpeg_transform_uniform_noise_batch_within_tie_rule():
    rng = np.random.default_rng(2022)
    tiles = rng.integers(0, 256, size=(24, 3, 256, 256)).astype(np.float32)
    t = torch.from_numpy(tiles)
    got = ops.jpeg_transform(t).numpy()
    expect = np.asarray(jax_jpeg_transform(jnp.asarray(tiles)))
    _assert_tie_rule(expect, got, ref.jpeg_quotient_ref(t).numpy())


def test_jpeg_transform_custom_tables_match_jax():
    # the IJG quality-75 tables: Annex K scaled by 0.5
    tiles = _slide_tiles(4, hw=512)
    ql = np.floor(ref.JPEG_LUMA_Q * 0.5 + 0.5).astype(np.float32)
    qc = np.floor(ref.JPEG_CHROMA_Q * 0.5 + 0.5).astype(np.float32)
    got = ops.jpeg_transform(torch.from_numpy(tiles), ql, qc).numpy()
    expect = np.asarray(jax_jpeg_transform(jnp.asarray(tiles),
                                           jnp.asarray(ql), jnp.asarray(qc)))
    _assert_tie_rule(expect, got, ref.jpeg_quotient_ref(
        torch.from_numpy(tiles), ql, qc).numpy())


def test_jpeg_transform_empty_level():
    for impl in ("auto", "ref"):
        out = ops.jpeg_transform(torch.zeros((0, 3, 256, 256)), impl=impl)
        assert out.shape == (0, 3, 256, 256) and out.dtype == torch.int32


def test_impl_rejects_unknown_strings():
    tiles = torch.zeros((1, 3, 8, 8))
    with pytest.raises(ValueError, match="impl"):
        ops.jpeg_transform(tiles, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.downsample2x2(tiles[0], impl="cuda")


def test_auto_takes_only_what_the_kernel_takes():
    # on the CPU too, so a CPU run fails where the card would
    with pytest.raises(ValueError, match="contiguous"):
        ops.downsample2x2(torch.zeros((16, 16, 3)).permute(2, 0, 1))
    with pytest.raises(TypeError, match="float32"):
        ops.jpeg_transform(torch.zeros((1, 3, 8, 8), dtype=torch.uint8))
    ref_out = ops.jpeg_transform(torch.zeros((1, 3, 8, 8), dtype=torch.uint8),
                                 impl="ref")
    assert ref_out.dtype == torch.int32


def test_jpeg_transform_rejects_bad_shapes():
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.jpeg_transform(torch.zeros((1, 3, 12, 16)))
    with pytest.raises(ValueError, match=r"\(N, 3, H, W\)"):
        ops.jpeg_transform(torch.zeros((1, 4, 8, 8)))


def test_cpu_tensors_never_launch_a_kernel():
    before = (ops.jpeg_transform.launches, ops.downsample2x2.launches)
    ops.jpeg_transform(torch.zeros((2, 3, 16, 16)))
    ops.downsample2x2(torch.zeros((3, 16, 16)))
    assert (ops.jpeg_transform.launches,
            ops.downsample2x2.launches) == before


@pytest.mark.parametrize("name,dtype", [("jpeg_transform", torch.float32),
                                        ("jpeg_inverse", torch.int32)])
def test_block_wrappers_take_views_off_a_16_byte_boundary(name, dtype):
    """The 8×8 block kernels read their input one 4-byte sample a lane, so
    a contiguous view one element into its storage is taken like any other
    input (only their outputs, which the wrappers allocate, must sit on a
    16-byte boundary)."""
    fn = getattr(ops, name)
    g = torch.Generator().manual_seed(5)
    buf = torch.randint(0, 256, (1 + 2 * 3 * 8 * 40,), generator=g,
                        dtype=torch.int32).to(dtype)
    view = buf[1:].view(2, 3, 8, 40)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    n0 = fn.launches
    assert torch.equal(fn(view), fn(view.clone(), impl="ref"))
    assert fn.launches == n0


def test_build_target_covers_the_headers(tmp_path, monkeypatch):
    """A kernel's library name hashes its source, every ``csrc/*.cuh`` and
    the flags: an edited header must not load a stale library."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("constexpr int kN = 1;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "shared.cuh").write_text("constexpr int kN = 2;\n")
    second = _build._target("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "other.cuh").write_text("// another header\n")
    assert _build._target("k") != second
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build._target("k") not in (first, second)


def test_block_kernels_dct_immediates_equal_the_plain_matrix():
    """``csrc/block8x8.cuh`` compiles the DCT matrix in as immediates (its
    launchers take no C): its literals must be numpy's ``dct_matrix()`` in
    float32, bit for bit."""
    import re
    from repro_torch.kernels import _build
    text = (_build.CSRC / "block8x8.cuh").read_text()
    body = re.search(r"#define BLOCK8X8_DCT_MATRIX(.*?)\}", text, re.S)[1]
    lits = re.findall(r"-?0x1\.[0-9a-f]+p-?\d+f", body)
    got = np.array([float.fromhex(v[:-1]) for v in lits], np.float32)
    assert got.shape == (64,)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  ref.dct_matrix().reshape(-1).view(np.uint32))
