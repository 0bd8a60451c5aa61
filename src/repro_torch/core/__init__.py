"""The port's copy of ``repro.core``: only ``clock`` so far (the spine
slice, ROADMAP A4, copies the rest)."""
