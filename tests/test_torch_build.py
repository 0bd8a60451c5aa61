"""Kernel builds and launch counts under threads (CPU).

Pipeline workers reach their first kernel launch from several threads at
once: ``_build.build_all`` must run each nvcc once (the others wait), and
each wrapper's ``launches`` count must not lose an update.
"""
import os
import stat
import sys

import torch

from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from repro_torch.analysis.racedep import spawn
from repro_torch.kernels import _build, ops

STUB = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
src = os.path.basename(sys.argv[-1])
time.sleep(0.3)  # widen the window in which a second builder could start
with open({log!r}, "a") as f:
    f.write(src + "\\n")
with open(out, "w") as f:
    f.write("stub library of " + src)
"""


def test_concurrent_first_builds_run_each_nvcc_once(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    _build._build_all.cache_clear()
    results, errors = [], []

    def first_launch():
        try:
            results.append(_build.build_all())
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    try:
        threads = [spawn(first_launch) for _ in range(4)]
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        _build._build_all.cache_clear()
    assert errors == []
    built = sorted(log.read_text().split())
    assert built == sorted(f"{name}.cu" for name in _build._ENTRIES)
    assert len(results) == 4 and all(r is results[0] for r in results)
    libs = sorted(p.name for p in (tmp_path / "kernels").iterdir())
    assert libs == sorted(_build._target(n).name for n in _build._ENTRIES)
    assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path))


def test_launch_counts_stay_exact_across_threads(monkeypatch):
    """Sixteen threads bump one wrapper's count 2000 times each, with the
    interpreter switching threads every microsecond: no update is lost."""
    monkeypatch.setattr(ops.jpeg_transform, "launches", 0)
    per_thread, n_threads = 2000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [spawn(lambda: [ops._count(ops.jpeg_transform)
                                  for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.join(120.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ops.jpeg_transform.launches == per_thread * n_threads


def test_launch_count_waits_for_the_lock(monkeypatch):
    """The count's read-modify-write happens under ``ops._COUNT_LOCK``: a
    launch counted while another thread holds it lands only after the
    holder lets go. (CPython 3.12 does not switch threads between the read
    and the write of a bare ``+=``, so the stress test above alone cannot
    tell a lock from none.)"""
    monkeypatch.setattr(ops.downsample2x2, "launches", 0)
    with ops._COUNT_LOCK:
        t = spawn(ops._count, ops.downsample2x2)
        t.join(0.2)
        assert t.is_alive() and ops.downsample2x2.launches == 0
    t.join(10.0)
    assert not t.is_alive() and ops.downsample2x2.launches == 1


def test_plain_versions_count_no_launch():
    """On a CPU tensor a wrapper runs its plain version and counts
    nothing: counts move only where a kernel launches."""
    before = {n: getattr(ops, n).launches
              for n in ("jpeg_transform", "downsample2x2")}
    img = torch.zeros((3, 64, 64))
    ops.downsample2x2(img)
    ops.jpeg_transform(img[None].contiguous())
    assert {n: getattr(ops, n).launches for n in before} == before
