"""The port's own AST lint: ``repro.analysis.lint``'s rules, two of them
adapted to PyTorch and CUDA.

    python -m repro_torch.analysis.lint [paths...] [--list-rules]

With no paths it scans ``src/repro_torch`` and the port's tests
(``tests/test_torch_*.py``, ``tests/_torch_*.py``) under the current
directory. The event-driven spine's correctness rests on conventions a
generic linter cannot know; each rule turns one of them into a checked
property:

======================== =================================================
rule id                  invariant
======================== =================================================
bare-lock                no ``threading.Lock()``/``RLock()`` outside
                         ``analysis/`` — every lock must be a
                         ``TrackedLock`` so lockdep sees it
wall-clock               no ``time.time()``/``time.sleep()``/
                         ``time.monotonic()``/``time.perf_counter()``
                         outside ``core/clock.py`` and ``benchmarks/`` —
                         wall-clock reads break SimScheduler determinism;
                         use the scheduler's ``now()`` or
                         ``core.clock.wall_time``/``wall_sleep``/
                         ``monotonic``
bare-thread              no ``threading.Thread(...)``/``Timer(...)``
                         outside ``analysis/`` and ``core/clock.py`` —
                         spawns go through
                         ``repro_torch.analysis.racedep.spawn`` so
                         racedep/lockdep see thread identity and the
                         fork/join happens-before edges
unseeded-random          no ``random``/``np.random`` use without an
                         explicit seed: ``random.Random(seed)`` or
                         ``np.random.default_rng(seed)`` only
direct-launch            no ``_build.library``, ``ops._launch`` or
                         ``ctypes`` library load outside ``kernels/`` —
                         every kernel launch goes through a
                         ``kernels.ops`` wrapper, which checks the
                         kernel's contract and counts the launch
                         (``repro``'s ``direct-pallas``)
counter-name             first argument of ``metrics.inc``/``record``/
                         ``observe`` must be dotted ``segment.segment``
                         lowercase names (f-string placeholders allowed
                         inside segments)
span-name                names given to ``tracing.span``/``start_span``
                         and ``add_event`` follow the same contract
compiled-global-mutation no mutation of module-level state inside a
                         function under ``torch.compile`` or inside a
                         ``torch.cuda.graph`` capture — it runs while the
                         graph is traced or captured only, and silently
                         stops happening on the compiled call or the
                         replay (``repro``'s ``jit-global-mutation``)
======================== =================================================

Suppression: append ``# lint: allow(<rule-id>)`` (comma-separated ids) to
the offending line, or put it on the line directly above, with a comment
justifying the exemption.
"""
from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path

__all__ = ["lint_file", "lint_paths", "default_paths", "Finding", "RULES"]

RULES = {
    "bare-lock": "threading.Lock/RLock outside analysis/ (use TrackedLock)",
    "bare-thread": "threading.Thread/Timer outside analysis/ and "
                   "core/clock.py (use racedep.spawn)",
    "wall-clock": "time.time()/sleep()/monotonic()/perf_counter() outside "
                  "core/clock.py and benchmarks/",
    "unseeded-random": "random/np.random use without an explicit seed",
    "direct-launch": "_build.library / ops._launch / a ctypes library "
                     "load outside kernels/",
    "counter-name": "metrics counter not in dotted segment.segment form",
    "span-name": "tracing span/event name not in dotted segment.segment "
                 "form",
    "compiled-global-mutation": "module-level state mutated under "
                                "torch.compile or a CUDA graph capture",
}

_ALLOW_RE = re.compile(r"lint:\s*allow\(([^)]*)\)")

#: functions on the stdlib ``random`` module that use the hidden global RNG
_RANDOM_GLOBAL_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "getrandbits", "randbytes", "seed",
}
#: legacy ``np.random`` functions that use the hidden global RandomState
_NP_RANDOM_GLOBAL_FNS = {
    "seed", "random", "rand", "randn", "randint", "random_sample",
    "normal", "uniform", "choice", "shuffle", "permutation", "standard_normal",
}
_MUTATING_METHODS = {
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "clear", "appendleft",
}
_COUNTER_SEG_RE = re.compile(r"[a-z0-9_\x00]+\Z")


class Finding:
    __slots__ = ("path", "line", "rule", "message")

    def __init__(self, path: str, line: int, rule: str, message: str):
        self.path, self.line = path, line
        self.rule, self.message = rule, message

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def __repr__(self):
        return f"Finding({self})"


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` attribute chain as a string ('' if not a plain chain)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _static_text(node: ast.AST) -> str | None:
    """Literal / f-string first arg as text, interpolations as ``\\x00``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        out = []
        for part in node.values:
            if isinstance(part, ast.Constant):
                out.append(str(part.value))
            else:
                out.append("\x00")
        return "".join(out)
    return None


def _is_compiled(fn: ast.AST) -> bool:
    """@torch.compile / @compile / @torch.compile(...) /
    @partial(torch.compile, ...)."""
    for dec in getattr(fn, "decorator_list", []):
        target = dec
        if isinstance(dec, ast.Call):
            name = _dotted(dec.func)
            if name in ("functools.partial", "partial") and dec.args:
                target = dec.args[0]
            else:
                target = dec.func
        name = _dotted(target)
        if name in ("torch.compile", "compile") \
                or name.endswith("torch.compile"):
            return True
    return False


def _is_capture(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(g):`` (any ``*.cuda.graph(...)`` or
    ``graph(...)`` context)."""
    ctx = item.context_expr
    if not isinstance(ctx, ast.Call):
        return False
    name = _dotted(ctx.func)
    return name == "graph" or name.endswith("cuda.graph")


#: ``ctypes`` names that load a shared library
_CTYPES_LOADERS = {"CDLL", "PyDLL", "cdll", "pydll", "LoadLibrary"}


class _Linter(ast.NodeVisitor):
    def __init__(self, path: Path, tree: ast.Module, rel: str):
        self.path = path
        self.rel = rel.replace("\\", "/")
        self.findings: list[Finding] = []
        self._compiled = 0  # compiled functions around the node
        self._captures = 0  # CUDA graph captures around it, in this def
        # module-level bindings (for compiled-global-mutation): names assigned
        # at the module's top level
        self.module_names: set[str] = set()
        for stmt in tree.body:
            for tgt in getattr(stmt, "targets", []) or \
                    ([stmt.target] if isinstance(
                        stmt, (ast.AnnAssign, ast.AugAssign)) else []):
                if isinstance(tgt, ast.Name):
                    self.module_names.add(tgt.id)

    # ---- helpers ----------------------------------------------------------
    def _report(self, node: ast.AST, rule: str, message: str):
        self.findings.append(
            Finding(str(self.path), getattr(node, "lineno", 0), rule,
                    message))

    def _in(self, *parts: str) -> bool:
        return any(p in self.rel for p in parts)

    # ---- visitors ----------------------------------------------------------
    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func)
        tail = name.rsplit(".", 1)[-1] if name else ""

        # bare-lock -------------------------------------------------------
        if name in ("threading.Lock", "threading.RLock", "Lock", "RLock") \
                and tail in ("Lock", "RLock") \
                and not self._in("/analysis/"):
            if name.startswith("threading.") or name in ("Lock", "RLock"):
                self._report(
                    node, "bare-lock",
                    f"{name}() — use repro_torch.analysis.lockdep.TrackedLock"
                    f"{'(reentrant=True)' if tail == 'RLock' else ''} so "
                    "lockdep can see it")

        # bare-thread -----------------------------------------------------
        if name in ("threading.Thread", "threading.Timer") \
                and not self._in("/analysis/") \
                and not self.rel.endswith("core/clock.py"):
            self._report(
                node, "bare-thread",
                f"{name}() — spawn through repro_torch.analysis.racedep.spawn "
                "(or schedule on a RealScheduler) so racedep/lockdep see "
                "thread identity and fork/join ordering")

        # wall-clock ------------------------------------------------------
        if name in ("time.time", "time.sleep", "time.monotonic",
                    "time.perf_counter") \
                and not self.rel.endswith("core/clock.py") \
                and not self._in("/benchmarks/"):
            sanctioned = {"time": "wall_time", "sleep": "wall_sleep",
                          "monotonic": "monotonic",
                          "perf_counter": "monotonic"}[tail]
            self._report(
                node, "wall-clock",
                f"{name}() breaks SimScheduler determinism — use the "
                f"scheduler's now()/schedule(), or core.clock."
                f"{sanctioned}() for sanctioned wall-clock use")

        # unseeded-random -------------------------------------------------
        self._check_random(node, name, tail)

        # counter-name / span-name: one dotted-lowercase naming contract --
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in ("inc", "record", "observe") and node.args:
                self._check_dotted(node, node.args[0], "counter-name",
                                   "counter")
            elif attr == "start_span" and node.args:
                self._check_dotted(node, node.args[0], "span-name", "span")
            elif attr == "span" and node.args \
                    and name.endswith("tracing.span"):
                self._check_dotted(node, node.args[0], "span-name", "span")
            elif attr == "add_event" and len(node.args) >= 2:
                self._check_dotted(node, node.args[1], "span-name",
                                   "span event")

        self.generic_visit(node)

    def _check_dotted(self, node: ast.Call, arg: ast.AST, rule: str,
                      kind: str):
        text = _static_text(arg)
        if text is None:
            return
        segs = text.split(".")
        if len(segs) < 2 or not all(
                s and _COUNTER_SEG_RE.match(s) for s in segs):
            self._report(
                node, rule,
                f"{kind} {text.replace(chr(0), '{…}')!r} must be "
                "dotted lowercase segment.segment form")

    def _check_random(self, node: ast.Call, name: str, tail: str):
        if name in ("random.Random",) and not node.args:
            self._report(node, "unseeded-random",
                         "random.Random() without a seed argument")
        elif name.startswith("random.") and tail in _RANDOM_GLOBAL_FNS \
                and name.count(".") == 1:
            self._report(
                node, "unseeded-random",
                f"{name}() uses the hidden module-global RNG — construct "
                "random.Random(seed) explicitly")
        elif name.endswith("random.default_rng") and not node.args:
            self._report(node, "unseeded-random",
                         "default_rng() without a seed argument")
        elif (name.startswith("np.random.") or
              name.startswith("numpy.random.")) \
                and tail in _NP_RANDOM_GLOBAL_FNS:
            self._report(
                node, "unseeded-random",
                f"{name}() uses numpy's global RandomState — use "
                "np.random.default_rng(seed)")

    def _direct_launch(self, node: ast.AST, what: str):
        if not self._in("/kernels/"):
            self._report(
                node, "direct-launch",
                f"{what} outside kernels/ — launch kernels through a "
                "kernels.ops wrapper (it checks the kernel's contract and "
                "counts the launch)")

    def visit_Attribute(self, node: ast.Attribute):
        owner = _dotted(node.value)
        tail = owner.rsplit(".", 1)[-1] if owner else ""
        if node.attr == "library" and tail == "_build":
            self._direct_launch(node, f"{owner}.library")
        elif node.attr == "_launch" and tail == "ops":
            self._direct_launch(node, f"{owner}._launch")
        elif node.attr in _CTYPES_LOADERS and (
                tail == "ctypes" or owner.startswith("ctypes.")):
            self._direct_launch(node, f"{owner}.{node.attr}")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        mod = node.module or ""
        for alias in node.names:
            if (mod.endswith("_build") and alias.name == "library") or (
                    mod == "ctypes" and alias.name in _CTYPES_LOADERS) or (
                    mod.endswith("ops") and alias.name == "_launch"):
                self._direct_launch(node, f"importing {alias.name} from "
                                    f"{mod}")
        self.generic_visit(node)

    # ---- compiled-global-mutation ------------------------------------------
    def _visit_function(self, node):
        compiled = _is_compiled(node)
        # a def inside a capture body is not run by the capture
        captures, self._captures = self._captures, 0
        self._compiled += compiled
        self.generic_visit(node)
        self._compiled -= compiled
        self._captures = captures

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_With(self, node: ast.With):
        captured = any(_is_capture(item) for item in node.items)
        self._captures += captured
        self.generic_visit(node)
        self._captures -= captured

    @property
    def _traced(self) -> bool:
        return bool(self._compiled or self._captures)

    def visit_Global(self, node: ast.Global):
        if self._traced:
            self._report(
                node, "compiled-global-mutation",
                f"global {', '.join(node.names)} under torch.compile or a "
                "CUDA graph capture — the mutation happens while tracing "
                "or capturing only and stops on the compiled call or the "
                "replay")
        self.generic_visit(node)

    def _root_name(self, node: ast.AST) -> str | None:
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        return node.id if isinstance(node, ast.Name) else None

    def _check_store(self, target: ast.AST, node: ast.AST):
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            root = self._root_name(target)
            if root in self.module_names:
                self._report(
                    node, "compiled-global-mutation",
                    f"module-level {root!r} mutated under torch.compile or "
                    "a CUDA graph capture — a trace-time side effect, "
                    "silently dropped on compiled calls and replays")

    def visit_Assign(self, node: ast.Assign):
        if self._traced:
            for tgt in node.targets:
                self._check_store(tgt, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        if self._traced:
            self._check_store(node.target, node)
        self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr):
        # CACHE.update(...) / CACHE.append(...) on a module-level name
        if self._traced and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Attribute) \
                and node.value.func.attr in _MUTATING_METHODS:
            root = self._root_name(node.value.func.value)
            if root in self.module_names:
                self._report(
                    node, "compiled-global-mutation",
                    f"module-level {root!r}.{node.value.func.attr}() "
                    "under torch.compile or a CUDA graph capture — a "
                    "trace-time side effect, silently dropped on compiled "
                    "calls and replays")
        self.generic_visit(node)


def _allowed(lines: list[str], finding: Finding) -> bool:
    """``# lint: allow(rule)`` on the finding's line or the line above."""
    for ln in (finding.line, finding.line - 1):
        if 1 <= ln <= len(lines):
            m = _ALLOW_RE.search(lines[ln - 1])
            if m and finding.rule in \
                    {s.strip() for s in m.group(1).split(",")}:
                return True
    return False


def lint_file(path: Path, root: Path | None = None) -> list[Finding]:
    src = path.read_text(encoding="utf-8")
    rel = str(path.resolve())
    if root is not None:
        try:
            rel = str(path.resolve().relative_to(root.resolve()))
        except ValueError:
            pass
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as exc:
        return [Finding(str(path), exc.lineno or 0, "syntax",
                        f"unparseable: {exc.msg}")]
    linter = _Linter(path, tree, "/" + rel)
    linter.visit(tree)
    lines = src.splitlines()
    return [f for f in linter.findings if not _allowed(lines, f)]


def lint_paths(paths: list[Path], root: Path | None = None) -> list[Finding]:
    files: list[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    findings: list[Finding] = []
    for f in files:
        findings.extend(lint_file(f, root=root))
    return findings


def default_paths(root: Path) -> list[Path]:
    """The port's package and its tests under ``root``."""
    tests = root / "tests"
    return [root / "src" / "repro_torch",
            *sorted(tests.glob("test_torch_*.py")),
            *sorted(tests.glob("_torch_*.py"))]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.lint",
        description="the port's lint rules (see module docstring)")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: "
                         "src/repro_torch and the port's tests)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rid, desc in RULES.items():
            print(f"{rid:26s} {desc}")
        return 0
    root = Path.cwd()
    paths = [Path(p) for p in args.paths] or default_paths(root)
    findings = lint_paths(paths, root=root)
    for f in findings:
        print(f)
    n_files = len({f.path for f in findings})
    if findings:
        print(f"lint: {len(findings)} finding(s) in {n_files} file(s)")
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
