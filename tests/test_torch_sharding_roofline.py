"""The port's sharding policy and roofline: copies of
tests/test_sharding_roofline.py's policy cases and ``derive_terms`` on the
H100's ``HW``; the port's ``spec_for`` against ``repro.sharding.spec_for``
on every leaf of every arch; the eager counters in place of the HLO walk;
each kernel wrapper counted once by its work formula."""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import sharding as rshd
from repro.configs import get_config as r_get_config
from repro.models import model as RM
from repro.train import TrainConfig as RTrainConfig
from repro.train import train_state_defs as r_train_state_defs
from repro_torch import sharding as shd
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.models.params import tree_defs
from repro_torch.roofline import (HW, Counter, analyze_step,
                                  collective_traffic, derive_terms, work)
from repro_torch.train import TrainConfig, train_state_defs
from repro_torch.wsi import jpeg as P
from repro_torch.wsi.entropy import _device_lut, pack_scans

SRC = str(Path(__file__).resolve().parents[1] / "src")


# --------------------------------------------------------------------------
# spec_for policy (pure logic — fake mesh via a stub)
# --------------------------------------------------------------------------
class _FakeMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        import numpy as _np
        self.devices = _np.empty(tuple(sizes.values()))


def _spec(shape, logical, sizes):
    return tuple(shd.spec_for(shape, logical, _FakeMesh(sizes)))


def test_batch_claims_pod_and_data():
    assert _spec((256, 4096), ("batch", "seq"),
                 {"pod": 2, "data": 16, "model": 16}) \
        == (("pod", "data"), "model")


def test_heads_fallback_when_indivisible():
    # gemma: 8 q heads on a 16-way model axis → seq takes the model axis
    spec = _spec((32, 4096, 8, 256), ("batch", "seq", "heads", "head_dim"),
                 {"data": 16, "model": 16})
    assert spec == ("data", "model")  # batch→data, seq→model, heads/dim open


def test_indivisible_batch_stays_replicated():
    spec = _spec((2, 4096, 8, 256), ("batch", "seq", "heads", "head_dim"),
                 {"data": 16, "model": 16})
    assert spec == (None, "model")


def test_heads_claim_model_when_divisible():
    spec = _spec((32, 4096, 32, 128), ("batch", "seq", "heads", "head_dim"),
                 {"data": 16, "model": 16})
    assert spec[2] == "model"


def test_weights_get_2d_fsdp_tp():
    spec = _spec((4096, 16384), ("embed", "mlp"), {"data": 16, "model": 16})
    assert spec == ("data", "model")


def test_each_mesh_axis_claimed_once():
    spec = _spec((4096, 4096), ("embed", "embed"), {"data": 16, "model": 16})
    assert tuple(spec) in ((("data",), ()), ("data",), ("data", None))


def test_constrain_rank_mismatch_raises():
    from repro_torch.launch.mesh import make_local_mesh
    with shd.set_mesh(make_local_mesh("cpu")):
        with pytest.raises(ValueError):
            shd.constrain(np.zeros((2, 2)), "batch")


def test_constrain_is_a_no_op_without_a_mesh_or_a_dtensor():
    from repro_torch.launch.mesh import make_local_mesh
    x = torch.ones(4, 8)
    assert shd.constrain(x, "batch", "embed") is x
    with shd.set_mesh(make_local_mesh("cpu")):
        assert shd.constrain(x, "batch", "embed") is x


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 8)

    spec = shd.spec_for((64, 1024, 4096), ("batch", "seq", "embed"), _Mesh)
    assert spec == (("pod", "data"), "model")
    assert shd.placements(spec, _Mesh) == (Shard(0), Shard(0), Shard(1))
    assert shd.placements((), _Mesh) == (Replicate(),) * 3


# --------------------------------------------------------------------------
# the port's policy equals the reference's on every leaf of every arch
# --------------------------------------------------------------------------
def _port_specs(defs, mesh, policy):
    return {"/".join(p): shd.spec_for(d.shape, d.logical, mesh, policy)
            for p, d in tree_defs(defs)}


def _ref_specs(defs, mesh, policy):
    flat = jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=lambda x: hasattr(x, "logical"))[0]
    return {"/".join(k.key for k in path):
            tuple(rshd.spec_for(d.shape, d.logical, mesh, policy))
            for path, d in flat}


@pytest.mark.parametrize("sizes", [{"data": 16, "model": 16},
                                   {"pod": 2, "data": 16, "model": 16}],
                         ids=["single", "multi"])
@pytest.mark.parametrize("policy", ["train", "serve_replicated"])
def test_spec_for_equals_the_reference(sizes, policy):
    mesh = _FakeMesh(sizes)
    B, S = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    for arch in list_archs():
        cfg, rcfg = get_config(arch), r_get_config(arch)
        trees = [(M.model_defs(cfg), RM.model_defs(rcfg)),
                 (M.cache_defs(cfg, B, S), RM.cache_defs(rcfg, B, S)),
                 (train_state_defs(cfg, TrainConfig()),
                  r_train_state_defs(rcfg, RTrainConfig()))]
        for port, repro in trees:
            assert _port_specs(port, mesh, policy) == \
                _ref_specs(repro, mesh, policy), arch


# --------------------------------------------------------------------------
# the three terms on the H100
# --------------------------------------------------------------------------
def test_derive_terms_dominance():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes, hw.peak_f32_flops) == \
        (989e12, 3.35e12, 80e9, 67e12)
    r = derive_terms(flops_per_device=989e12, bytes_per_device=1e9,
                     collective_bytes_per_device=0, chips=256,
                     model_flops_total=989e12 * 256 * 0.5)
    assert r["dominant"] == "compute_s"
    assert abs(r["mfu_bound"] - 0.5) < 1e-6
    r2 = derive_terms(flops_per_device=1e9, bytes_per_device=3.35e12,
                      collective_bytes_per_device=0, chips=256,
                      model_flops_total=1e9)
    assert r2["dominant"] == "memory_s" and r2["bound_s"] == 1.0
    r3 = derive_terms(flops_per_device=1e9, bytes_per_device=1e9,
                      collective_bytes_per_device=450e9, chips=8,
                      model_flops_total=1e9)
    assert r3["dominant"] == "collective_s" and r3["bound_s"] == 1.0


def test_derive_terms_charges_f32_flops_at_the_f32_peak():
    hw = HW()
    r = derive_terms(flops_per_device=989e12 + 67e12, bytes_per_device=1e9,
                     collective_bytes_per_device=0, chips=1,
                     model_flops_total=1e12, f32_flops_per_device=67e12)
    assert r["compute_s"] == 2.0 and r["dominant"] == "compute_s"
    ref = derive_terms(flops_per_device=989e12, bytes_per_device=1e9,
                       collective_bytes_per_device=0, chips=1,
                       model_flops_total=1e12)
    assert ref["compute_s"] == 989e12 / hw.peak_flops


# --------------------------------------------------------------------------
# the counters (in place of the HLO walk's cases)
# --------------------------------------------------------------------------
def test_matmul_flops_and_bytes():
    x, w = torch.ones(32, 64), torch.ones(64, 48)
    r = analyze_step(torch.mm, x, w)
    assert r["flops"] == 2 * 32 * 64 * 48
    assert r["bytes"] == (32 * 64 + 64 * 48 + 32 * 48) * 4
    assert r["ops"] == {"aten.mm": [1, 2.0 * 32 * 64 * 48,
                                    (32 * 64 + 64 * 48 + 32 * 48) * 4.0,
                                    2.0 * 32 * 64 * 48]}
    assert r["temp_bytes"] == 32 * 48 * 4


@pytest.mark.parametrize("dtype,f32", [(torch.float32, True),
                                       (torch.bfloat16, False)])
def test_matmul_flops_by_rate(dtype, f32):
    """A float32 product counts at the float32 rate, a bf16 one at the
    tensor cores' (``flops_f32`` 0), in the totals and the op table."""
    x, w = torch.ones(32, 64, dtype=dtype), torch.ones(64, 48, dtype=dtype)
    r = analyze_step(torch.mm, x, w)
    want = 2 * 32 * 64 * 48 if f32 else 0
    assert r["flops_f32"] == want and r["ops"]["aten.mm"][3] == want
    assert r["flops"] == 2 * 32 * 64 * 48


def test_python_loop_counted_once_per_iteration():
    """The layers run in a Python loop: each iteration dispatches its own
    ops, so 12 iterations count 12 matmuls (the HLO walk needed trip
    counts for a scan)."""
    def f(x, w):
        for _ in range(12):
            x = torch.tanh(x @ w)
        return x

    r = analyze_step(f, torch.ones(32, 64), torch.ones(64, 64))
    assert r["flops"] == 2 * 32 * 64 * 64 * 12
    assert r["ops"]["aten.mm"][0] == 12 and r["ops"]["aten.tanh"][0] == 12


def test_einsum_and_views():
    """einsum counts the matmul it lowers to; a view moves nothing."""
    a, b = torch.ones(4, 8, 16), torch.ones(16, 32)
    r = analyze_step(lambda: torch.einsum("bsd,de->bse", a, b).reshape(-1))
    assert r["flops"] == 2 * 4 * 8 * 16 * 32
    views = [k for k in r["ops"] if k in ("aten.view", "aten._unsafe_view",
                                          "aten.reshape")]
    assert all(r["ops"][k][2] == 0 for k in views)


def test_collective_traffic_ring_accounting():
    assert collective_traffic("all-gather", 800.0, 8) == 700.0
    assert collective_traffic("all-reduce", 800.0, 8) == 1400.0
    assert collective_traffic("reduce-scatter", 100.0, 8) == 700.0
    assert collective_traffic("all-to-all", 800.0, 8) == 700.0
    assert collective_traffic("collective-permute", 800.0, 8) == 800.0
    assert collective_traffic("all-gather", 800.0, 1) == 0.0


def test_dtensor_all_gather_counted_in_subprocess():
    """A sharded DTensor matmul on a fake 8-rank mesh: the all-gather the
    redistribution issues counts the ring formula's bytes."""
    prog = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import torch
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch.mesh import make_fake_mesh
        from repro_torch.roofline import Counter, collective_traffic
        mesh = make_fake_mesh((8,), ("data",))
        x = DTensor.from_local(torch.ones(8, 256), mesh, [Shard(0)],
                               run_check=False)
        w = DTensor.from_local(torch.ones(256, 128), mesh, [Replicate()],
                               run_check=False)
        c = Counter()
        with c:
            y = x.redistribute(mesh, [Replicate()]) @ w
        assert tuple(y.shape) == (64, 128), y.shape
        want = collective_traffic("all-gather", 64 * 256 * 4, 8)
        assert c.by_kind == {"all-gather": want}, dict(c.by_kind)
        assert c.ops["aten.mm"][1] == 2 * 64 * 256 * 128, c.ops
        print("ALLGATHER-OK", want)
    """) % SRC
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300)
    assert "ALLGATHER-OK" in out.stdout, out.stderr[-2000:]


# --------------------------------------------------------------------------
# each kernel wrapper: its formula once, none of its plain version's ops
# --------------------------------------------------------------------------
def _entropy_args():
    rng = np.random.default_rng(13)
    jpgs = P.encode_tiles_batch(
        rng.integers(0, 256, size=(2, 8, 16, 3)).astype(np.uint8),
        device="cpu")
    scans, H, W = P._scans(jpgs)
    return (*(torch.from_numpy(a) for a in pack_scans(scans)),
            _device_lut(torch.device("cpu")), H, W)


def _kernel_calls():
    g = torch.Generator().manual_seed(5)
    tiles = torch.randint(0, 256, (2, 3, 16, 16), generator=g).float()
    coef = ops.jpeg_transform(tiles)
    img = torch.randint(0, 256, (3, 16, 24), generator=g).float()
    plane = torch.randn(16, 24, generator=g) * 50
    B, S, H, K = 1, 40, 2, 16
    r, k, v = (torch.randn(B, S, H, K, generator=g) for _ in range(3))
    logw = -torch.rand(B, S, H, K, generator=g)
    u, st = torch.randn(H, K, generator=g), torch.zeros(B, H, K, K)
    ent = _entropy_args()
    return {
        "jpeg_transform": (lambda: ops.jpeg_transform(tiles),
                           work.jpeg_transform_work(tiles.shape)),
        "jpeg_inverse": (lambda: ops.jpeg_inverse(coef),
                         work.jpeg_inverse_work(coef.shape)),
        "downsample2x2": (lambda: ops.downsample2x2(img),
                          work.downsample2x2_work(img.shape)),
        "rgb2ycbcr": (lambda: ops.rgb2ycbcr(img),
                      work.rgb2ycbcr_work(img.shape)),
        "dct8x8_quant": (lambda: ops.dct8x8_quant(plane),
                         work.dct8x8_quant_work(plane.shape)),
        "entropy_decode": (lambda: ops.entropy_decode(*ent),
                           work.entropy_decode_work(
                               ent[1].numel(), ent[4], ent[5],
                               ent[0].numel(), ent[3].numel())),
        "wkv_chunk": (lambda: ops.wkv_chunk(r, k, v, logw, u, st),
                      work.wkv_chunk_work(B, S, H, K)),
    }


@pytest.mark.parametrize("name", ["jpeg_transform", "jpeg_inverse",
                                  "downsample2x2", "rgb2ycbcr",
                                  "dct8x8_quant", "entropy_decode",
                                  "wkv_chunk"])
def test_kernel_counted_once_by_its_formula(name):
    call, (flops, nbytes) = _kernel_calls()[name]
    r = analyze_step(call)
    assert r["ops"] == {f"kernel.{name}": [1, flops, nbytes, flops]}
    assert (r["flops"], r["flops_f32"], r["bytes"]) == (flops, flops,
                                                        nbytes)
    # outside a counter the wrapper runs as before
    plain = call()
    again = call()
    first = plain[0] if isinstance(plain, tuple) else plain
    second = again[0] if isinstance(again, tuple) else again
    assert torch.equal(first, second)


def test_wkv_gradient_counted_as_aten_ops():
    """Under grad ``wkv_chunk`` goes through ``WkvChunk`` on every device:
    its forward is counted by the formula once, its backward (the plain
    chunked form's autograd) as aten ops."""
    g = torch.Generator().manual_seed(6)
    B, S, H, K = 1, 64, 2, 16
    xs = [torch.randn(B, S, H, K, generator=g).requires_grad_()
          for _ in range(3)]
    logw = (-torch.rand(B, S, H, K, generator=g)).requires_grad_()
    u = torch.randn(H, K, generator=g).requires_grad_()
    st = torch.zeros(B, H, K, K).requires_grad_()

    def step():
        out, fin = ops.wkv_chunk(*xs, logw, u, st)
        return torch.autograd.grad((out.sum() + fin.sum()),
                                   [*xs, logw, u, st])

    r = analyze_step(step)
    assert r["ops"]["kernel.wkv_chunk"][0] == 1
    assert r["ops"]["aten.bmm"][0] > 0  # the backward's einsums
    want = torch.autograd.grad(
        sum(t.sum() for t in ref.wkv_chunked_ref(*xs, logw, u, st)),
        [*xs, logw, u, st])
    for a, b in zip(r["out"], want):
        assert torch.equal(a, b)


def test_counter_tracks_live_storage():
    def f():
        a = torch.ones(1000)        # 4000 B, held
        b = torch.ones(2000)        # 8000 B, freed below
        del b
        c = torch.ones(500)         # 2000 B
        return a, c

    r = analyze_step(f)
    assert r["temp_bytes"] == 12000
    c = Counter()
    with c:
        x = torch.ones(10)
        x.add_(1)                   # in place: nothing new allocated
    assert c.peak == 40
