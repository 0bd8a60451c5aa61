"""The port's lint (``repro_torch.analysis.lint``): copies of
tests/test_lint.py's cases against it, fire and clean cases of its two
adapted rules (``direct-launch``, ``compiled-global-mutation``), and the
port's shipped tree clean under it."""
import textwrap
from pathlib import Path

from repro_torch.analysis import lint

REPO = Path(__file__).resolve().parents[1]


def _findings(tmp_path: Path, source: str, *, rel: str = "mod.py"):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return lint.lint_file(p, root=tmp_path)


def _rules(findings):
    return [f.rule for f in findings]


# ------------------------------------------------ each rule fires (seeded)
def test_bare_lock_fires(tmp_path):
    fs = _findings(tmp_path, """\
        import threading
        LOCK = threading.Lock()
        RLOCK = threading.RLock()
    """)
    assert _rules(fs) == ["bare-lock", "bare-lock"]
    assert "TrackedLock" in fs[0].message


def test_wall_clock_fires(tmp_path):
    fs = _findings(tmp_path, """\
        import time
        t0 = time.time()
        time.sleep(1.0)
        t1 = time.monotonic()
        t2 = time.perf_counter()
    """)
    assert _rules(fs) == ["wall-clock"] * 4
    assert "wall_time" in fs[0].message and "wall_sleep" in fs[1].message
    assert "monotonic" in fs[2].message and "monotonic" in fs[3].message


def test_bare_thread_fires(tmp_path):
    fs = _findings(tmp_path, """\
        import threading
        t = threading.Thread(target=work, daemon=True)
        timer = threading.Timer(5.0, fire)
    """)
    assert _rules(fs) == ["bare-thread", "bare-thread"]
    assert "racedep.spawn" in fs[0].message


def test_unseeded_random_fires(tmp_path):
    fs = _findings(tmp_path, """\
        import random
        import numpy as np
        r = random.Random()
        x = random.random()
        rng = np.random.default_rng()
        y = np.random.uniform(0, 1)
    """)
    assert _rules(fs) == ["unseeded-random"] * 4


def test_direct_launch_fires(tmp_path):
    fs = _findings(tmp_path, """\
        import ctypes
        from ctypes import CDLL
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels._build import library
        lib = ctypes.CDLL("libwkv.so")
        _build.library("wkv_chunk")(0)
        ops._launch("wkv_chunk", x)
    """)
    # the two imports, the ctypes load, the library and the raw launch
    assert _rules(fs) == ["direct-launch"] * 5
    assert "kernels.ops wrapper" in fs[0].message


def test_direct_launch_ignores_the_wrappers(tmp_path):
    fs = _findings(tmp_path, """\
        from repro_torch.kernels import ops
        out = ops.wkv_chunk(r, k, v, logw, u, state)
        n = ops.wkv_chunk.launches
        import ctypes
        buf = ctypes.c_int(3)
    """)
    assert fs == []


def test_counter_name_fires(tmp_path):
    fs = _findings(tmp_path, """\
        metrics.inc("flat")
        metrics.inc("Bad.Case")
        metrics.record("spaced name.x", 1.0)
        metrics.inc(f"svc.{name}.requests")    # placeholder segment: fine
        metrics.inc("svc.conv.cold_starts")    # compliant: fine
    """)
    assert _rules(fs) == ["counter-name"] * 3


def test_counter_name_covers_observe(tmp_path):
    fs = _findings(tmp_path, """\
        metrics.observe("Bad Histogram", 1.0)
        metrics.observe("sub.push.latency", 1.0)   # compliant: fine
    """)
    assert _rules(fs) == ["counter-name"]


def test_span_name_fires(tmp_path):
    fs = _findings(tmp_path, """\
        from repro_torch.core import tracing
        sp = tracing.start_span("FlatName")
        with tracing.span("Bad Span.x"):
            pass
        tracing.add_event(sp, "noDots")
        sp2 = tracing.start_span("sub.push.deliver")       # compliant
        tracing.add_event(sp2, f"fault.{kind}")            # placeholder
        with tracing.span("convert.slide"):                # compliant
            pass
    """)
    assert _rules(fs) == ["span-name"] * 3
    assert "segment.segment" in fs[0].message


def test_compiled_global_mutation_fires(tmp_path):
    fs = _findings(tmp_path, """\
        import torch
        CACHE = {}
        COUNT = 0

        @torch.compile
        def f(x):
            global COUNT
            CACHE[1] = x
            CACHE.update({2: x})
            return x

        @torch.compile(mode="reduce-overhead")
        def g(x):
            CACHE[3] = x
            return x

        def capture(graph, x):
            with torch.cuda.graph(graph):
                CACHE.append(x)
                y = x + 1
            CACHE[4] = y            # after the capture: fine
    """)
    assert _rules(fs) == ["compiled-global-mutation"] * 5


def test_compiled_global_mutation_clean(tmp_path):
    fs = _findings(tmp_path, """\
        import torch
        CACHE = {}

        def eager(x):
            CACHE[1] = x            # not compiled: fine
            return x

        @torch.compile
        def f(x):
            local = {}
            local[1] = x            # local state: fine
            return x

        def capture(graph, x):
            with torch.cuda.graph(graph):
                def later():        # defined, not run, by the capture
                    CACHE[2] = x
                y = x * 2
            return y, later
    """)
    assert fs == []


# ------------------------------------------------------ pragma suppression
def test_pragma_same_line_suppresses(tmp_path):
    fs = _findings(tmp_path, """\
        import threading
        LOCK = threading.Lock()  # detector guts  # lint: allow(bare-lock)
    """)
    assert fs == []


def test_pragma_line_above_suppresses(tmp_path):
    fs = _findings(tmp_path, """\
        import time
        # CLI stopwatch, never under SimScheduler  # lint: allow(wall-clock)
        t0 = time.time()
    """)
    assert fs == []


def test_pragma_is_rule_specific(tmp_path):
    fs = _findings(tmp_path, """\
        import time
        t0 = time.time()  # lint: allow(bare-lock)
    """)
    assert _rules(fs) == ["wall-clock"]


def test_pragma_multiple_rules(tmp_path):
    fs = _findings(tmp_path, """\
        import time
        t0 = time.time()  # lint: allow(bare-lock, wall-clock)
    """)
    assert fs == []


# -------------------------------------------------------- path exemptions
def test_analysis_dir_may_use_bare_locks(tmp_path):
    fs = _findings(tmp_path, """\
        import threading
        MU = threading.Lock()
    """, rel="analysis/guts.py")
    assert fs == []


def test_clock_module_may_use_wall_clock(tmp_path):
    fs = _findings(tmp_path, """\
        import time
        import threading
        def wall_time():
            return time.time()
        def monotonic():
            return time.monotonic()
        t = threading.Timer(1.0, fire)
    """, rel="core/clock.py")
    assert fs == []


def test_benchmarks_dir_may_use_monotonic(tmp_path):
    fs = _findings(tmp_path, """\
        import time
        t0 = time.perf_counter()
        t1 = time.monotonic()
    """, rel="benchmarks/some_bench.py")
    assert fs == []


def test_analysis_dir_may_spawn_threads(tmp_path):
    fs = _findings(tmp_path, """\
        import threading
        t = threading.Thread(target=work)
    """, rel="analysis/racedep.py")
    assert fs == []


def test_kernels_dir_may_launch(tmp_path):
    fs = _findings(tmp_path, """\
        import ctypes
        from repro_torch.kernels._build import library
        lib = ctypes.CDLL(path)
        err = library("wkv_chunk")(0)
    """, rel="kernels/ops.py")
    assert fs == []


# --------------------------------------------------- sanctioned idioms
def test_sanctioned_idioms_are_clean(tmp_path):
    fs = _findings(tmp_path, """\
        import random
        import time
        import numpy as np
        from repro_torch.analysis.lockdep import TrackedLock
        from repro_torch.core.clock import wall_time

        LOCK = TrackedLock("mod.LOCK")
        r = random.Random(7)
        rng = np.random.default_rng(7)
        t2 = wall_time()
        metrics.inc("svc.conv.requests")
    """)
    assert fs == []


def test_syntax_error_reported_not_raised(tmp_path):
    fs = _findings(tmp_path, "def broken(:\n")
    assert _rules(fs) == ["syntax"]


# ------------------------------------------------------ shipped tree + CLI
def test_shipped_tree_is_clean():
    paths = lint.default_paths(REPO)
    assert paths[0] == REPO / "src" / "repro_torch"
    assert any(p.name.startswith("test_torch_") for p in paths)
    findings = lint.lint_paths(paths, root=REPO)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_main_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nt = time.time()\n")
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert lint.main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "[wall-clock]" in out and "1 finding(s)" in out
    assert lint.main([str(good)]) == 0
    assert "clean" in capsys.readouterr().out
    assert lint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in lint.RULES:
        assert rule in out
    assert "direct-pallas" not in out and "jit-global-mutation" not in out


def test_main_defaults_to_the_port(tmp_path, monkeypatch, capsys):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text("import time\nt = time.time()\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_x.py").write_text(
        "import threading\nL = threading.Lock()\n")
    (tmp_path / "tests" / "test_other.py").write_text(
        "import time\nt = time.time()\n")
    monkeypatch.chdir(tmp_path)
    assert lint.main([]) == 1
    out = capsys.readouterr().out
    assert "[wall-clock]" in out and "[bare-lock]" in out
    assert "test_other.py" not in out and "2 finding(s)" in out
