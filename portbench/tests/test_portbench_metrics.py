"""The metric arithmetic (rates over the window, p90 over all requests,
the FLOP formulas) and the registry's finding of new files by name."""
import json
import shutil

import numpy as np
import pytest
import torch

from portbench.harness import work
from portbench.harness.main import Run, port_config, run_cell
from portbench.harness.registry import PORTBENCH, Cell, load_bench
from portbench.harness.serve import Req, Timing
from portbench.harness.traffic import Mix
from portbench.tests.portbench_tiny import CELLS, MIX, ROOT, TINY, one_thread, \
    tiny_cell


def _run(timing, requests=(), model=None):
    cell = tiny_cell("rwkv6-3b.chat")
    return Run(model=model or cell.model, reference=cell.reference,
               mix=Mix.from_dict({**cell.mix, **MIX}), timing=timing,
               requests=list(requests), setup_s=12.5, on_card=True)


def _read(name, run):
    return tiny_cell("rwkv6-3b.chat").reader(name)(run)


def test_rates_cover_the_whole_window():
    timing = Timing(t0=10.0, t1=12.0,
                    prefills=[(10.0, 10.1, 1000), (10.5, 10.6, 3000)],
                    ticks=[(10.1, 10.2, 4, np.full(4, 100)),
                           (10.2, 10.3, 3, np.full(3, 100))])
    run = _run(timing)
    assert _read("prompt_tok_s", run) == pytest.approx(4000 / 2.0)
    assert _read("output_tok_s", run) == pytest.approx((2 + 7) / 2.0)
    assert _read("setup_s", run) == 12.5
    assert _read("prefill_ms_per_ktok.prompt", run) == pytest.approx(200 / 4)
    assert _read("decode_tick_ms", run) == pytest.approx(100.0)


def test_tails_take_every_request_of_the_window():
    reqs = []
    for i in range(20):  # first tokens 1..20 ms after their publish
        r = Req(i, 0, np.zeros(4, np.int32), 5, 10.0 + i * 0.01)
        r.t_first = r.t_publish + (i + 1) * 1e-3
        r.t_last = r.t_first + 4 * (i + 1) * 1e-3  # 5 tokens
        r.t_done = r.t_last + 1e-3
        r.tokens = [0] * 5
        reqs.append(r)
    early = Req(99, 0, np.zeros(4, np.int32), 5, 0.0)  # before the window
    early.t_first, early.t_last, early.t_done = 1.0, 1.1, 1.2
    early.tokens = [0] * 5
    run = _run(Timing(t0=10.0, t1=20.0), reqs + [early])
    assert _read("ttft_p90_ms", run) == pytest.approx(
        np.percentile(np.arange(1, 21), 90))
    assert _read("tpot_p90_ms", run) == pytest.approx(
        np.percentile(np.arange(1, 21), 90))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "phi4-mini-3.8b"])
def test_the_counted_weights_are_the_models(arch):
    """The weights a token multiplies, with the embedding, the head and
    the vectors, are the program's parameter count at full size."""
    from repro_torch.models import model as M

    m = json.loads((PORTBENCH / "configs" / f"{arch}.json").read_text())
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    vectors = (13 * L + 1) * D if m["reference"] == "rwkv6" \
        else (2 * L + 1) * D
    tables = V * D * (1 if m["tie_embeddings"] else 2)
    ref = tiny_cell(CELLS[m["reference"]]).reference
    assert ref.matmul_params(m) + vectors + tables == M.param_count(
        port_config(m)) == m["parameters"]


@pytest.mark.parametrize("family", sorted(TINY))
def test_prefill_flops_against_the_program_counter(family):
    """The program's own counter over a prefill counts the formula's FLOPs;
    the dense attention there computes whole blocks, the formula the
    causal pairs only."""
    from repro_torch.models import model as M
    from repro_torch.roofline.counters import analyze_step

    cell = tiny_cell(CELLS[family])
    model = {**cell.model, **TINY[family], "dtype": "float32"}
    cfg = port_config(model)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    S = 40
    with one_thread(), torch.no_grad():
        got = analyze_step(M.prefill, params, cfg,
                           torch.zeros((1, S), dtype=torch.long),
                           max_len=S)["flops"]
    want = work.prefill_flops(cell.reference, model, S)
    if family == "dense":  # one block of S keys for every query
        L, H, hd = model["num_layers"], model["num_heads"], model["head_dim"]
        want += L * 4.0 * hd * H * (S * S - S * (S + 1) / 2)
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("family", sorted(TINY))
def test_mfu_counts_each_token_at_its_context(family):
    """The whole step's FLOPs: every weight twice a token, attention at
    each token's own context (dense), the wkv update (rwkv6), the head at
    each decoded token and at each prefill's last position."""
    cell = tiny_cell(CELLS[family])
    m = {**cell.model, **TINY[family]}
    L, D, F, V = m["num_layers"], m["d_model"], m["d_ff"], m["vocab_size"]
    H, hd = m["num_heads"], m["head_dim"]
    if family == "dense":
        KV = m["num_kv_heads"]
        P = L * (2 * D * H * hd + 2 * D * KV * hd + 3 * D * F)
        per_key = L * 4.0 * hd * H
        fixed = 2.0 * P
    else:
        R, Rd = m["rwkv_lora_dim"], m["rwkv_decay_lora_dim"]
        P = L * (6 * D * D + 2 * D * F + 10 * R * D + 2 * D * Rd)
        per_key = 0.0
        fixed = 2.0 * P + L * H * (5.0 * hd * hd + 6.0 * hd)
    head = 2.0 * V * D
    S, ctx = 7, np.array([3, 10, 10, 64])
    want_prefill = S * fixed + per_key * S * (S + 1) / 2 + head
    want_decode = 4 * (fixed + head) + per_key * ctx.sum()
    assert work.prefill_flops(cell.reference, m, S) == pytest.approx(
        want_prefill, rel=1e-12)
    assert work.decode_flops(cell.reference, m, ctx) == pytest.approx(
        want_decode, rel=1e-12)
    timing = Timing(t0=0.0, t1=2.0, prefills=[(0.0, 0.1, S)],
                    ticks=[(0.1, 0.2, 2, ctx[:2]), (0.2, 0.3, 2, ctx[2:])])
    run = Run(model=m, reference=cell.reference, mix=None, timing=timing,
              requests=[], setup_s=1.0, on_card=True)
    assert cell.reader("mfu.output")(run) == pytest.approx(
        100 * (want_prefill + want_decode) / (2.0 * work.PEAK["bf16_flops"]),
        rel=1e-12)


@pytest.mark.parametrize("shape", [(1, 1, 1, 16), (1, 200, 40, 64),
                                   (2, 65, 3, 16)])
def test_wkv_formula_is_the_programs(shape):
    from repro_torch.roofline import work as program_work

    assert work.wkv_work(*shape) == tuple(
        float(x) for x in program_work.wkv_chunk_work(*shape))


@pytest.mark.parametrize("S", [1, 5, 64])
def test_attention_counts_the_causal_pairs(S):
    B, H, KV, D = 2, 4, 2, 8
    pairs = sum(q + 1 for q in range(S))
    flops, nbytes = work.attention_work(B, S, H, KV, D,
                                        work.DTYPE_BYTES["bfloat16"])
    assert flops == 2 * 2 * D * H * B * pairs  # QKᵀ and PV, 2 a product
    assert nbytes == 2 * B * S * D * (2 * H + 2 * KV)


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a cell and a per-layer metric added as new
    files and entries are found and run with no other file edited."""
    root = tmp_path / "checkout"
    pb = root / "portbench"
    shutil.copytree(PORTBENCH, pb, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    config = json.loads((pb / "configs" / "rwkv6-3b.json").read_text())
    config["name"] = "rwkv6-small"
    (pb / "configs" / "rwkv6-small.json").write_text(json.dumps(
        {**config, **TINY["rwkv6"]}))
    (pb / "traffic" / "tiny.json").write_text(json.dumps(
        {**json.loads((pb / "traffic" / "chat.json").read_text()), **MIX,
         "name": "tiny"}))
    (pb / "cells" / "rwkv6-small.tiny.json").write_text(json.dumps(
        {"max_logit_gap": {"limit": 1.0}}))
    (pb / "metrics" / "prefills_seen.py").write_text(
        "def read(run):\n    return len(run.timing.prefills)\n")
    bench = load_bench(ROOT)
    bench["configs"].append({"name": "rwkv6-small", "source": "test",
                             "file": "portbench/configs/rwkv6-small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "rwkv6-small.tiny",
                               "config": "rwkv6-small", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "prefills_seen", "unit": "prefills",
                               "better": "higher", "source": "host_clock",
                               "layer": "serve.engine prefill",
                               "moves": "ttft_p90_ms",
                               "workloads": ["rwkv6-small.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell(load_bench(root), "rwkv6-small.tiny", root, pb)
    assert cell.model["name"] == "rwkv6-small"
    assert cell.mix["name"] == "tiny"
    assert [m["name"] for m in cell.per_layer] == ["prefills_seen"]
    with one_thread():
        result, _, _ = run_cell("rwkv6-small.tiny", 3, 0.5, True, root=root,
                                device="cpu", pb=pb, pre_s=0.1, slice_s=0.2)
    assert result["metrics"]["prefills_seen"]["value"] > 0
    assert result["correct"]
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == []


def test_the_wkv_kernels_are_found_by_their_names():
    """Every kernel of the program's wkv source, as the trace names it,
    and nothing else, counts as wkv device time (``wkv_roofline``)."""
    import re

    from portbench.harness.trace import _WKV

    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
           "wkv_chunk.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s*)?(\w+)\s*\(", src)
    assert len(names) == 3
    for name in names:
        assert _WKV.search(f"void (anonymous namespace)::{name}<64>(float "
                           f"const*, float const*, int)")
    for other in ("void at::native::elementwise_kernel<128, 2>",
                  "nvjet_tst_64x16_64x16_4x2_h_bz_NNT", "xwkv_a"):
        assert not _WKV.search(other)


@pytest.mark.parametrize("mix", ["chat", "longprompt"])
def test_primers_open_the_window_in_the_steady_state(mix):
    """The primers ask for the residual of the block's output lengths: as
    many requests finish a tick at the start as on average after."""
    from portbench.harness import traffic

    m = Mix.from_dict(json.loads((PORTBENCH / "traffic" /
                                  f"{mix}.json").read_text()))
    lengths = traffic.at_quantiles(m.output_tokens, m.block)
    left = traffic.residuals(m, 4096)
    # a renewal process's residual: mean E[L(L+1)] / (2 E[L])
    want = (lengths * (lengths + 1)).mean() / (2 * lengths.mean())
    assert left.mean() == pytest.approx(want, rel=0.01)
    assert 1 <= left.min() and left.max() <= lengths.max()
    # handed out in an order of the seed's, not the shortest to slot 0
    got = [n for _, n in traffic.primers(m, 1000, 2**31 + 5)]
    assert sorted(got) == sorted(traffic.residuals(m, m.clients))
    assert got != sorted(got)
