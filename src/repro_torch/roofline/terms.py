"""Three-term roofline (the port's copy of ``repro.roofline.terms``): the
hardware constants a cost model prices with, and the compute, memory and
interconnect times of one step.

``H100`` is the card the port runs on, from the NVIDIA H100 SXM5 data
sheet: dense bf16 tensor-core peak, HBM3 bandwidth and NVLink 4 bandwidth
per direction; ``hbm_bytes`` follows the ``H200`` entry's convention (the
marketed size in GiB). ``H200`` is the reference's entry for the paper's
fp8 deployment. These are data-sheet peaks, not measurements on a card."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per chip
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link
    hbm_bytes: float


H100 = Hardware("h100-sxm5-bf16", peak_flops=989e12, hbm_bw=3.35e12,
                ici_bw=450e9, hbm_bytes=80 * 2 ** 30)

H200 = Hardware("h200-fp8", peak_flops=1979e12, hbm_bw=4.8e12,
                ici_bw=450e9, hbm_bytes=141 * 2 ** 30)


def roofline_terms(flops_per_dev, hbm_bytes_per_dev, coll_bytes_per_dev,
                   hw: Hardware = H100):
    """The three times (seconds) + dominant term."""
    t_c = flops_per_dev / hw.peak_flops
    t_m = hbm_bytes_per_dev / hw.hbm_bw
    t_x = coll_bytes_per_dev / hw.ici_bw
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
    bound = max(t_c, t_m, t_x)
    return {
        "t_compute": t_c, "t_memory": t_m, "t_collective": t_x,
        "dominant": dom[1], "t_bound": bound,
        "roofline_fraction": (t_c / bound if bound > 0 else 0.0),
    }
