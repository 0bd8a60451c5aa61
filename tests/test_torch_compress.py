"""The port's int8 error-feedback compression (``repro_torch.comms``)
against ``repro.comms.compress`` on the same seeded numpy inputs.

``int8_quantize``'s codes and scale, ``int8_dequantize`` and
``ef_compress`` equal the reference's (the same float32 operations, and
``torch.round`` rounds half to even as ``jnp.round``). ``compressed_psum``
runs over an 8-process ``gloo`` group and is held to the reference's
``shard_map`` over 8 host devices (equal) and to the exact sum within the
reference's bound, ``err < 0.1·scale + 0.2``. (The reference's own
quantization cases are copied in ``tests/test_torch_train_checkpoint.py``.)
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import compress as J
from repro_torch.comms import compress as P

from _torch_gloo_psum import rows
from _torch_train import one_torch_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"


def _x(seed: int, shape=(64, 64), scale: float = 3.0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, scale, shape).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_dequantize_equal_reference(seed):
    x = _x(seed)
    jq, js = J.int8_quantize(jnp.asarray(x))
    q, s = P.int8_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    assert np.array_equal(P.int8_dequantize(q, s).numpy(),
                          np.asarray(J.int8_dequantize(jq, js)))


def test_round_half_to_even_as_reference():
    """Values that land on .5 after scaling by 127/max round to even."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5], np.float32)
    jq, _ = J.int8_quantize(jnp.asarray(x))
    q, _ = P.int8_quantize(torch.from_numpy(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


def test_ef_compress_equals_reference_over_steps():
    """Five steps of error feedback on a two-leaf tree (one bf16 leaf)."""
    shapes = {"a": (32, 16), "b": (40,)}
    ef_j = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    ef_p = P.ef_init({k: torch.zeros(s) for k, s in shapes.items()})
    for step in range(5):
        g = {k: _x(10 * step + i, s, 1.0) for i, (k, s) in
             enumerate(sorted(shapes.items()))}
        gj = {"a": jnp.asarray(g["a"]), "b": jnp.asarray(g["b"],
                                                         jnp.bfloat16)}
        gp = {"a": torch.from_numpy(g["a"]),
              "b": torch.from_numpy(g["b"]).to(torch.bfloat16)}
        out_j, ef_j = J.ef_compress(gj, ef_j)
        out_p, ef_p2 = P.ef_compress(gp, ef_p)
        assert ef_p2 is ef_p  # the residual is written in place
        for k in shapes:
            assert out_p[k].dtype == gp[k].dtype
            assert np.array_equal(out_p[k].float().numpy(),
                                  np.asarray(out_j[k], np.float32)), k
            assert np.array_equal(ef_p[k].numpy(), np.asarray(ef_j[k])), k


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compressed_psum_over_gloo_matches_reference(tmp_path):
    n = 8
    out = tmp_path / "psum.npy"
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    run = subprocess.run(
        [sys.executable, str(TESTS / "_torch_gloo_psum.py"), str(n),
         str(_free_port()), str(out)], env=env, capture_output=True,
        text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-2000:]
    got = np.load(out)
    prog = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import sys
        sys.path.insert(0, %r)
        sys.path.insert(0, %r)
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from jax.experimental.shard_map import shard_map
        from repro.comms.compress import compressed_psum
        from repro.launch.mesh import _axis_types_kwargs
        from _torch_gloo_psum import rows
        mesh = jax.make_mesh((8,), ("data",), **_axis_types_kwargs(1))
        f = shard_map(lambda v: compressed_psum(v[0], "data"),
                      mesh=mesh, in_specs=P("data", None), out_specs=P())
        np.save(%r, np.asarray(f(jnp.asarray(rows(8)))))
    """) % (str(SRC), str(TESTS), str(tmp_path / "ref.npy"))
    ref = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert np.array_equal(got, np.load(tmp_path / "ref.npy"))
    exact = rows(n).sum(0)
    err = float(np.abs(got - exact).max())
    scale = float(np.abs(exact).max())
    assert err < 0.1 * scale + 0.2, (err, scale)
