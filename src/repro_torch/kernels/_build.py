"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C entry point and is compiled on
first use into its own shared library under ``build/kernels/`` at the repo
root::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so <name>.cu

The file name carries a hash of the source, of every header in ``csrc/``
(``*.cuh``, which the sources may include) and of the flags, so an edited
source or header is rebuilt and a stale library is never loaded.
``-fmad=false`` keeps nvcc from contracting a multiply and an add into one
FMA: the kernels must round exactly where their plain versions do. ``--use_fast_math`` is
never used. All sources build in parallel, one nvcc each.

Nothing here runs at import time: ``nvcc`` and the ``ctypes`` load happen
inside :func:`library`, which the wrappers in ``ops.py`` call only when
they launch a kernel on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_all", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
#: C signature of each kernel's entry point: (symbol, argtypes)
_ENTRIES = {
    "downsample2x2": ("downsample2x2_q_launch",
                      [_P, _P, _I64, _I64, _I64, _P]),
    "jpeg_transform": ("jpeg_transform_launch",
                       [_P, _P, _I64, _I64, _I64, _P, _P]),
    "jpeg_inverse": ("jpeg_inverse_launch",
                     [_P, _P, _I64, _I64, _I64, _P, _P]),
    "rgb2ycbcr": ("rgb2ycbcr_launch", [_P, _P, _I64, _I64, _P]),
    "dct8x8_quant": ("dct8x8_quant_launch", [_P, _P, _I64, _I64, _P, _P]),
    "entropy_decode": ("entropy_decode_launch",
                       [_P, _I64, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                        _I64, _P, _P]),
    "wkv_chunk": ("wkv_chunk_launch",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                   _I64, _P]),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (on PATH or under "
                           "/usr/local/cuda/bin)")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@lru_cache(maxsize=None)
def build_all() -> dict[str, str]:
    """Compile every kernel whose library is missing, all nvccs at once.

    Returns ``{name: compiler output}`` (ptxas' register and shared-memory
    report for each kernel built in this call). Raises ``RuntimeError``
    with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in _ENTRIES:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        jobs[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (so, tmp, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, so)  # atomic: a concurrent builder sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@lru_cache(maxsize=None)
def library(name: str):
    """The ctypes entry point of kernel ``name``, built on first use."""
    build_all()
    symbol, argtypes = _ENTRIES[name]
    fn = getattr(ctypes.CDLL(str(_target(name))), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
