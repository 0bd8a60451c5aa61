"""What the reference forwards share: the leaf rules, the weight readers
and the float32 settings."""
from __future__ import annotations

import contextlib
import dataclasses

import torch

__all__ = ["Leaf", "PLAIN", "FLOAT8", "Precision", "float32_exact", "rms"]


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter tensor: its path in the program's tree, its shape and
    how it is drawn: ``normal`` N(0, a²), ``uniform`` U(a, b), ``const``
    filled with ``a``."""

    path: tuple[str, ...]
    shape: tuple[int, ...]
    init: str
    a: float = 0.0
    b: float = 0.0

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


def _to_fp8(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """How the reference reads its operands: ``w`` a stored weight matrix,
    ``x`` an activation entering a matrix product, both to float32."""

    def __init__(self, w, x):
        self.w, self.x = w, x


#: the reference: float32 throughout
PLAIN = Precision(w=lambda t: t.float(), x=lambda t: t)

#: the control, the precision below bf16: every product of a weight
#: matrix with float8 e4m3 operands, the weight with one scale, each
#: activation row with its own, back in float32 (the attention's own
#: products, float32 in the serving program, stay float32)
FLOAT8 = Precision(
    w=lambda t: _to_fp8(t.float(), t.float().abs().amax().clamp(
        min=1e-12) / 448.0),
    x=lambda t: _to_fp8(t, t.abs().amax(-1, keepdim=True).clamp(
        min=1e-12) / 448.0))


@contextlib.contextmanager
def float32_exact():
    """Float32 matrix products without TF32 for the block inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm of the last axis, scaled by ``w``."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w
