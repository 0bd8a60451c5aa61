"""Shared pieces of the port's spine tests (``tests/test_torch_*.py``).

* ``port_lockdep_armed`` / ``port_racedep_armed``: autouse fixtures that arm
  the port's own detectors for every test of a file that imports them,
  written as ``tests/conftest.py`` writes ``repro``'s (which see only
  ``repro``'s locks and tracked state). Any violation fails the test.
* ``pinned_uids`` / ``pinned_convert``: conversions whose study and series
  UIDs derive from the slide id, so the port and ``repro`` (and a serial
  and a concurrent run) mint byte-identical studies.
"""
from __future__ import annotations

import hashlib
import json

import pytest

from repro_torch.analysis import lockdep, racedep

CPU = "cpu"


@pytest.fixture(autouse=True)
def port_lockdep_armed():
    """Arm the port's lockdep for every test; fail on any violation."""
    det = lockdep.arm(max_hold=30.0)
    try:
        yield det
    finally:
        violations = lockdep.disarm()
        if violations:
            lines = "\n".join(f"  [{v.kind}] {v.message}" for v in violations)
            pytest.fail(
                f"port lockdep: {len(violations)} violation(s) during "
                f"test:\n{lines}", pytrace=False)


@pytest.fixture(autouse=True)
def port_racedep_armed():
    """Arm the port's data-race detector for every test; fail on any
    report."""
    det = racedep.arm()
    try:
        yield det
    finally:
        violations = racedep.disarm()
        if violations:
            lines = "\n".join(f"  {v.message}\n    first:  {v.first_site}"
                              f"\n    second: {v.second_site}"
                              for v in violations)
            pytest.fail(
                f"port racedep: {len(violations)} data race(s) during "
                f"test:\n{lines}", pytrace=False)


def pinned_uids(slide_id: str) -> str:
    """The manifest ``"uids"`` entry minted from a slide id."""
    h = hashlib.sha256(slide_id.encode()).hexdigest()
    return json.dumps(["2.25." + str(int(h[:24], 16)),
                       "2.25." + str(int(h[24:48], 16))])


def pinned_convert(convert_wsi_to_dicom, ConvertOptions, **opt_kw):
    """A pipeline ``convert`` callable with UIDs pinned per slide id, for
    either package's converter (``opt_kw`` go to its ``ConvertOptions``)."""
    def convert(data: bytes, meta: dict) -> bytes:
        opt = ConvertOptions(manifest={"uids": pinned_uids(meta["slide_id"])},
                             **opt_kw)
        return convert_wsi_to_dicom(data, meta, options=opt)
    return convert
