"""Distributed-communication helpers: gradient compression, collective
utils (a copy of ``repro.comms``)."""
from repro_torch.comms.compress import (  # noqa: F401
    compressed_psum,
    ef_compress,
    ef_init,
    int8_dequantize,
    int8_quantize,
)
