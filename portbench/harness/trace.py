"""The traced slice and what is read from it.

After the measured window, the loop runs on under ``torch.profiler``:
first ``pre_s`` seconds that are not read (the trace loses its first
launches: they fall here), then a slice of ``slice_s`` seconds inside a
``record_function("portbench.slice")`` range, which is what is read. In
the slice the benchmark's own ranges, around the engine's calls, mark the
host's work: each prefill (``portbench.prefill:<prompt tokens>``), the
decode call (``portbench.decode``), the argmax read-back
(``portbench.argmax``), the bus (``portbench.bus``), and each call of the
attention (``portbench.attention:<shape>``, around
``models.layers.blocked_attention``). The wkv kernels are found by their
names (``wkv_*``, the kernels of ``kernels/csrc/wkv_chunk.cu``) among the
kernels each prefill launched.

A CUDA graph's replay shows in the trace as one launch; where its
kernels are not in the trace, each replay's device interval is timed by
CUDA events around ``graph.replay()`` and placed on the trace's clock by a
marker kernel launched right after a reference event. The raw events are
read (``kineto_results``), as the program's ``chip_smoke.py`` reads them,
and each kernel is given to a range by its launch's thread and time.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
from collections import defaultdict

import torch

__all__ = ["Slice", "traced_slice"]

#: a wkv kernel's name (``void (anonymous namespace)::wkv_pass1_state<64>(…)``)
_WKV = re.compile(r"(^|[\s:])wkv_\w")

_RANGES = ("portbench.prefill", "portbench.decode", "portbench.argmax",
           "portbench.bus")


@dataclasses.dataclass
class Slice:
    """What the traced slice gives the metric readers."""

    window_s: float
    busy_s: float
    calls: dict  # "attention": [(shape, device s)]; "wkv": [((S,), device s)]
    device_ops: list  # [(name, seconds)], longest first
    idle_gaps: list  # [(host activity, seconds)], longest first


class _TimedGraph:
    """A CUDA graph whose replays are timed by events."""

    def __init__(self, graph):
        self.graph = graph
        self.pairs = []

    def replay(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        self.pairs.append((a, b))


def _shape_tag(*dims) -> str:
    return ",".join(str(int(d)) for d in dims)


@contextlib.contextmanager
def _instrumented(system):
    """The slice's ranges and the replay timing, undone on exit."""
    from repro_torch.models import layers

    rf = torch.profiler.record_function
    eng = system.engine
    saved = {n: getattr(eng, n) for n in ("_prefill_into", "_decode",
                                          "_greedy")}
    deliver = system.deliver
    attention = layers.blocked_attention

    def ranged(name, fn):
        def call(*a, **k):
            with rf(name):
                return fn(*a, **k)
        return call

    def attn(q, k, v, q_pos, kv_pos, *, causal=True, window=0, chunk=1024):
        B, S, H, D = q.shape
        tag = _shape_tag(B, S, k.shape[1], H, k.shape[2], D, int(causal))
        with rf("portbench.attention:" + tag):
            return attention(q, k, v, q_pos, kv_pos, causal=causal,
                             window=window, chunk=chunk)

    def prefill(b, req):
        with rf("portbench.prefill:" + _shape_tag(len(req.prompt))):
            return saved["_prefill_into"](b, req)

    eng._prefill_into = prefill
    eng._decode = ranged("portbench.decode", saved["_decode"])
    eng._greedy = ranged("portbench.argmax", saved["_greedy"])
    system.deliver = ranged("portbench.bus", deliver)
    layers.blocked_attention = attn
    timed = None
    if eng._graph is not None:
        timed = _TimedGraph(eng._graph.graph)
        eng._graph.graph = timed
    try:
        yield timed
    finally:
        for n, fn in saved.items():
            setattr(eng, n, fn)
        system.deliver = deliver
        layers.blocked_attention = attention
        if timed is not None:
            eng._graph.graph = timed.graph


def _union(intervals, lo, hi):
    """Merged [start, end) intervals, clipped to [lo, hi]."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Spans:
    """Non-overlapping [start, end] spans of one kind, per thread."""

    def __init__(self):
        self.by_thread = defaultdict(list)

    def add(self, thread, start, end, tag=None):
        self.by_thread[thread].append((start, end, tag))

    def done(self):
        for rows in self.by_thread.values():
            rows.sort(key=lambda row: row[:2])
        return self

    def find(self, thread, t):
        rows = self.by_thread.get(thread)
        if not rows:
            return None
        i = bisect.bisect_right(rows, (t, float("inf"), "")) - 1
        if i >= 0 and rows[i][0] <= t <= rows[i][1]:
            return rows[i]
        return None

    def find_any(self, t):
        for thread in self.by_thread:
            hit = self.find(thread, t)
            if hit is not None:
                return hit
        return None


def traced_slice(system, pre_s: float, slice_s: float) -> Slice:
    """Run the loop traced (module doc) and read the slice."""
    from torch.profiler import ProfilerActivity, profile

    on_card = system.engine.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    marker = torch.zeros(1, device=system.engine.device)
    with profile(activities=acts) as prof:
        system.run(pre_s, record=False)
        with _instrumented(system) as timed:
            ref = torch.cuda.Event(enable_timing=True) if on_card else None
            with torch.profiler.record_function("portbench.marker"):
                if ref is not None:
                    ref.record()
                marker.add_(1.0)
            with torch.profiler.record_function("portbench.slice"):
                system.run(slice_s, record=False)
    replays = []
    if timed is not None:
        torch.cuda.synchronize()
        replays = [(ref.elapsed_time(a) * 1e6, a.elapsed_time(b) * 1e6)
                   for a, b in timed.pairs]
    return _read(prof, replays)


def _read(prof, replays) -> Slice:
    cuda = torch.autograd.DeviceType.CUDA
    device, launches = [], {}
    spans = {n: _Spans() for n in _RANGES}
    attention = _Spans()
    marker_range = slice_range = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append(e)
            continue
        if "LaunchKernel" in name or "GraphLaunch" in name:
            launches[e.correlation_id()] = (e.start_thread_id(),
                                            e.start_ns(), name)
        elif name == "portbench.slice":
            slice_range = (e.start_ns(), e.end_ns())
        elif name == "portbench.marker":
            marker_range = (e.start_thread_id(), e.start_ns(), e.end_ns())
        elif name.startswith("portbench."):
            base, _, tag = name.partition(":")
            tag = tuple(int(x) for x in tag.split(",")) if tag else None
            if base in spans:
                spans[base].add(e.start_thread_id(), e.start_ns(),
                                e.end_ns(), tag)
            elif base == "portbench.attention":
                attention.add(e.start_thread_id(), e.start_ns(), e.end_ns(),
                              tag)
    for s in (*spans.values(), attention):
        s.done()
    if slice_range is None:
        raise RuntimeError("the trace holds no portbench.slice range")
    lo, hi = slice_range
    in_graph = {c for c, (_, _, n) in launches.items() if "GraphLaunch" in n}
    graph_traced = any(e.correlation_id() in in_graph for e in device)
    intervals = []
    per_call = {"attention": defaultdict(float), "wkv": defaultdict(float)}
    by_name = defaultdict(float)
    mark_start = None
    for e in device:
        s = e.start_ns()
        end = s + e.duration_ns()
        launch = launches.get(e.correlation_id())
        if marker_range is not None and launch is not None \
                and launch[0] == marker_range[0] \
                and marker_range[1] <= launch[1] <= marker_range[2]:
            mark_start = s
        if s < lo or end > hi:
            continue
        intervals.append((s, end))
        by_name[e.name()[:120]] += e.duration_ns() / 1e9
        if launch is not None:
            hit = attention.find(launch[0], launch[1])
            if hit is not None:
                per_call["attention"][hit[0], hit[2]] += e.duration_ns() / 1e9
            hit = spans["portbench.prefill"].find(launch[0], launch[1])
            if hit is not None and _WKV.search(e.name()):
                per_call["wkv"][hit[0], hit[2]] += e.duration_ns() / 1e9
    if replays and not graph_traced:
        if mark_start is None:
            raise RuntimeError("the trace lost the marker kernel: the "
                               "replays cannot be placed on its clock")
        for off, dur in replays:
            intervals.append((mark_start + off, mark_start + off + dur))
        by_name["decode graph replay (CUDA events)"] += sum(
            dur for _, dur in replays) / 1e9
    busy = _union(intervals, lo, hi)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps[_host_at(spans, (s + e) / 2)] += (e - s) / 1e9
    # every attention call in the slice; every prefill that ran wkv kernels
    out_calls = {"attention": [], "wkv": []}
    for rows in attention.by_thread.values():
        out_calls["attention"] += [
            (tag, per_call["attention"].get((start, tag), 0.0))
            for start, end, tag in rows if lo <= start and end <= hi]
    for rows in spans["portbench.prefill"].by_thread.values():
        out_calls["wkv"] += [
            (tag, per_call["wkv"][start, tag]) for start, end, tag in rows
            if lo <= start and end <= hi and (start, tag) in per_call["wkv"]]
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return Slice(window_s=(hi - lo) / 1e9, busy_s=busy_s, calls=out_calls,
                 device_ops=top(by_name), idle_gaps=top(gaps))


def _host_at(spans: dict, t: float) -> str:
    """The innermost of the benchmark's host ranges around time ``t``."""
    for name in _RANGES:  # prefill, decode, argmax sit inside the bus or not
        if spans[name].find_any(t) is not None:
            return "host in " + name.split(".", 1)[1]
    return "host in the loop"
