"""The design of the ``entropy_decode`` kernel, settled on the CPU: its plain
mirror (``ref.entropy_decode_subseq_ref``: one CTA of ``threads`` threads
per tile, self-synchronising subsequences, a scan, a dense write) against
the lockstep plain version (``ref.entropy_decode_ref``) that the kernel is
held to on the card.

Integer code: coefficients, ``stop`` and ``err_kind`` must be equal on
every lane, clean or corrupt, at every thread count — one thread (the
whole scan one range), a few (ranges of many units), and many (ranges of
one unit, or none: most threads idle on a small tile). Tiles are 128² or
smaller. (The kernel against both, on a card: ``test_torch_gpu.py``.)
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.wsi import jpeg as J
from repro_torch.kernels import ops, ref
from repro_torch.wsi import jpeg as P
from repro_torch.wsi.entropy import _device_lut, pack_scans
from repro_torch.wsi.formats import open_slide
from repro_torch.wsi.slide import SyntheticScanner

THREADS = (1, 2, 7, 64, 256)
CPU = torch.device("cpu")


def _content(kind: str) -> list[bytes]:
    """A few small JPEG tiles of one kind of content."""
    rng = np.random.default_rng(13)
    if kind == "noise":
        return J.encode_tiles_batch(
            rng.integers(0, 256, size=(2, 8, 16, 3)).astype(np.uint8))
    if kind == "flat":
        tiles = np.full((2, 32, 64, 3), 200, np.uint8)
        tiles[1, 11, 13] = [0, 255, 7]  # one outlier block
        return J.encode_tiles_batch(tiles)
    if kind == "gradient":
        g = np.linspace(0, 255, 8 * 64).reshape(8, 64)
        one = np.stack([g, g[::-1], 255 - g], axis=-1).astype(np.uint8)
        return J.encode_tiles_batch(np.stack([one, one[::-1]]))
    if kind == "slide":
        rd = open_slide(SyntheticScanner(seed=3).scan(64, 64, 32))
        return J.encode_tiles_batch(np.stack([rd.read_tile(0, 0),
                                              rd.read_tile(1, 1)]))
    # encode_coef_batch of random coefficients: dense blocks up to
    # category 10, or sparse ones with long zero runs and ZRLs
    coef = rng.integers(-1023, 1024, size=(2, 3, 8, 8)).astype(np.int32)
    if kind == "sparse":
        coef = rng.integers(-1023, 1024, size=(2, 3, 16, 16)) \
            .astype(np.int32) * (rng.random((2, 3, 16, 16)) < 0.05)
    return P.encode_coef_batch(coef)


def _args(scans: list[np.ndarray], H: int, W: int):
    return (*(torch.from_numpy(a) for a in pack_scans(scans)),
            _device_lut(CPU), H, W)


@lru_cache(maxsize=None)
def _lockstep(kind: str):
    scans, H, W = P._scans(_content(kind))
    args = _args(scans, H, W)
    return args, ref.entropy_decode_ref(*args)


def _assert_mirror_equals_lockstep(args, want, threads: int):
    *got, rounds = ref.entropy_decode_subseq_ref(*args, threads)
    for name, a, b in zip(("coef", "stop", "err_kind"), got, want):
        assert torch.equal(a, b), name
    assert rounds.dtype == torch.int32 and rounds.shape == got[1].shape
    assert bool((rounds >= 1).all()) and bool((rounds <= threads).all())
    return got, rounds


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("kind", ["noise", "flat", "gradient", "slide",
                                  "dense", "sparse"])
def test_mirror_matches_lockstep(kind, threads):
    args, want = _lockstep(kind)
    (_, stop, kind_), _ = _assert_mirror_equals_lockstep(args, want, threads)
    assert not bool(kind_.any()) and bool((stop > 0).all())


# hand-made scans (Annex-K luma tables): "00" is DC category 0; sixteen 1
# bits match no DC or AC code; an empty scan reads the guard's zeros and
# overruns at its first symbol
_EMPTY = np.zeros(0, np.uint8)
_INVALID_AT_0 = np.array([0xFF, 0xFF, 0xFF], np.uint8)
_INVALID_AT_1 = np.array([0x3F, 0xFF, 0xC0], np.uint8)  # 00 then 1×16


def _corrupt_scans(clean: np.ndarray, rng) -> list[np.ndarray]:
    """Truncated, bit-flipped and garbage-tailed copies of a clean scan."""
    out = [clean[:c] for c in (0, 1, 5, clean.size // 3, clean.size - 1)]
    for _ in range(6):
        mut = clean.copy()
        mut[rng.integers(0, mut.size)] ^= np.uint8(1 << int(rng.integers(8)))
        out.append(mut)
    out.append(np.concatenate([clean, rng.integers(0, 256, 40)
                               .astype(np.uint8)]))
    return out


@lru_cache(maxsize=None)
def _corrupt_batch():
    rd = open_slide(SyntheticScanner(seed=7).scan(64, 64, 32))
    scans, H, W = P._scans(J.encode_tiles_batch(np.stack(
        [rd.read_tile(0, 1), rd.read_tile(1, 0)])))
    lanes = [scans[0], *_corrupt_scans(scans[1], np.random.default_rng(0)),
             _EMPTY, _INVALID_AT_0, _INVALID_AT_1, scans[0]]
    args = _args(lanes, H, W)
    return args, ref.entropy_decode_ref(*args)


@pytest.mark.parametrize("threads", THREADS)
def test_mirror_matches_lockstep_on_corrupt_lanes(threads):
    """Each corrupt lane gives the lockstep's stop, kind and coefficients
    (zeros from its failure on), clean lanes beside them included."""
    args, want = _corrupt_batch()
    kinds = set(want[2].tolist())
    assert {0, ref.ERR_INVALID, ref.ERR_TRUNC} <= kinds, kinds
    _assert_mirror_equals_lockstep(args, want, threads)


@pytest.mark.parametrize("threads", THREADS)
def test_mirror_on_the_hand_made_scans(threads):
    """8×8 tiles of three units: the empty scan overruns at symbol 0, the
    invalid codes fail at symbols 0 and 1."""
    args = _args([_EMPTY, _INVALID_AT_0, _INVALID_AT_1], 8, 8)
    want = ref.entropy_decode_ref(*args)
    assert list(zip(want[1].tolist(), want[2].tolist())) == [
        (0, ref.ERR_TRUNC), (0, ref.ERR_INVALID), (1, ref.ERR_INVALID)]
    _assert_mirror_equals_lockstep(args, want, threads)


@pytest.mark.parametrize("seed", range(2))
def test_mirror_matches_lockstep_on_bit_flips(seed):
    """Seeded bit flips (one to three) of a clean 64² scan."""
    rng = np.random.default_rng(seed)
    clean = _clean_64()
    lanes = []
    for _ in range(4):
        mut = clean.copy()
        for _ in range(int(rng.integers(1, 4))):
            mut[rng.integers(0, mut.size)] ^= \
                np.uint8(1 << int(rng.integers(8)))
        lanes.append(mut)
    args = _args(lanes, 64, 64)
    _assert_mirror_equals_lockstep(args, ref.entropy_decode_ref(*args),
                                   int(rng.choice(THREADS[1:])))


@lru_cache(maxsize=None)
def _clean_64() -> np.ndarray:
    rd = open_slide(SyntheticScanner(seed=5).scan(256, 256, 64))
    scans, _, _ = P._scans(J.encode_tiles_batch(rd.read_tile(2, 2)[None]))
    return scans[0]


@settings(max_examples=8, deadline=None)
@given(flips=st.lists(st.integers(0, 10 ** 6), min_size=1, max_size=4),
       threads=st.sampled_from(THREADS))
def test_mirror_matches_lockstep_on_random_bit_flips(flips, threads):
    mut = _clean_64().copy()
    for f in flips:
        bit = f % (8 * mut.size)
        mut[bit >> 3] ^= np.uint8(0x80 >> (bit & 7))
    args = _args([mut], 64, 64)
    _assert_mirror_equals_lockstep(args, ref.entropy_decode_ref(*args),
                                   threads)


def test_mirror_rounds_follow_the_ranges():
    """One range takes one round; a tile never takes more rounds than it
    has ranges (``⌈nbits / L⌉``, L ≥ 32 bits)."""
    args, want = _lockstep("slide")
    nbits = args[2]
    for threads in THREADS:
        _, rounds = _assert_mirror_equals_lockstep(args, want, threads)
        L = 32 * torch.clamp((nbits + 32 * threads - 1) // (32 * threads),
                             min=1)
        assert bool((rounds <= (nbits + L - 1) // L).all())
        if threads == 1:
            assert rounds.tolist() == [1] * len(rounds)


def test_mirror_empty_batch():
    args = _args([], 8, 8)
    coef, stop, kind, rounds = ref.entropy_decode_subseq_ref(*args, 64)
    assert coef.shape == (0, 3, 8, 8) and stop.numel() == kind.numel() \
        == rounds.numel() == 0



def test_stats_output_needs_a_kernel_launch():
    """``stats`` is the kernel's debug output: a call that runs the plain
    version (a CPU tensor, or ``impl="ref"``) refuses it, as it refuses a
    wrong shape or dtype."""
    args, _ = _lockstep("slide")
    n = args[1].numel()
    for stats, impl in ((torch.zeros((n, 3), dtype=torch.int32), "auto"),
                        (torch.zeros((n, 3), dtype=torch.int32), "ref"),
                        (torch.zeros((n, 2), dtype=torch.int32), "auto"),
                        (torch.zeros((n, 3)), "auto")):
        with pytest.raises(ValueError, match="stats"):
            ops.entropy_decode(*args, impl=impl, stats=stats)
