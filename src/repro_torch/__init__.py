"""PyTorch/CUDA port of ``repro``: slide → DICOM conversion on an NVIDIA H100.

Imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``. Entry
points run on ``cuda`` unless the caller asks for the CPU.
"""
