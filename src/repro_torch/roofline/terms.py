"""Three-term roofline derivation for an NVIDIA H100, a copy of
``repro.roofline.terms`` with the card's figures in :class:`HW`.

    compute term    = FLOPs_total   / (chips × peak_FLOP/s)
    memory term     = bytes_total   / (chips × HBM_bw)
    collective term = link_bytes/device / link_bw

The compute term charges the FLOPs that run at the float32 rate (a
float32 product, a ported kernel's formula: ``f32_flops_per_device``) at
``peak_f32_flops`` and the rest at the bf16 peak; with none it is the
reference's formula.

The counters (:mod:`repro_torch.roofline.counters`) count per device, so
totals are per-device × chips (the division by chips then cancels; the
formula is kept as the reference writes it).
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "derive_terms"]


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense rates without
    sparsity, at the 700 W limit)."""

    name: str = "h100-sxm5-80gb"
    peak_flops: float = 989e12  # bf16 tensor cores / card
    hbm_bw: float = 3.35e12  # bytes/s / card
    link_bw: float = 450e9  # bytes/s / card, NVLink 4, each direction
    hbm_bytes: float = 80e9  # capacity / card
    peak_f32_flops: float = 67e12  # float32 outside the tensor cores


def derive_terms(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    chips: int,
    model_flops_total: float,
    f32_flops_per_device: float = 0.0,
    hw: HW = HW(),
) -> dict:
    compute_s = ((flops_per_device - f32_flops_per_device) / hw.peak_flops
                 + f32_flops_per_device / hw.peak_f32_flops)
    memory_s = bytes_per_device / hw.hbm_bw
    collective_s = collective_bytes_per_device / hw.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound_s = terms[dominant]
    model_compute_s = model_flops_total / (chips * hw.peak_flops)
    return {
        **terms,
        "dominant": dominant,
        "bound_s": bound_s,
        "hlo_flops_total": flops_per_device * chips,
        "hlo_bytes_total": bytes_per_device * chips,
        "model_flops_total": model_flops_total,
        # fraction of the counted compute that is "useful" model math
        "useful_flops_ratio": (
            model_flops_total / (flops_per_device * chips)
            if flops_per_device else 0.0
        ),
        # end-to-end MFU upper bound implied by the counted program
        "mfu_bound": model_compute_s / bound_s if bound_s else 0.0,
        "chips": chips,
    }
