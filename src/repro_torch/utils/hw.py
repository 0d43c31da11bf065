"""Hardware constants for the TPU v5e target and roofline helpers.

The container is CPU-only; these constants parameterize
  * the roofline analysis over the compiled dry-run artifacts, and
  * the analytic T_fwd / T_swap cost model that the InferCept scheduler and
    the discrete-event simulator share (the paper obtains the same mappings
    by offline profiling on A100).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    hbm_bandwidth: float        # bytes/s per chip
    hbm_bytes: float            # HBM capacity per chip
    ici_link_bandwidth: float   # bytes/s per ICI link
    host_link_bandwidth: float  # bytes/s chip<->host (PCIe share), for swap


TPU_V5E = ChipSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    hbm_bytes=16e9,
    ici_link_bandwidth=50e9,
    # v5e hosts attach 4 chips per PCIe-gen4 host; ~8 GB/s effective per chip
    # is a conservative swap-path figure (the paper's A100 PCIe4 x16 ~= 25GB/s
    # shared). This number only shapes T_swap; it is configurable.
    host_link_bandwidth=8e9,
)

# The paper's evaluation hardware, used by the simulator to reproduce the
# paper's own numbers (A100-80GB SXM).
A100 = ChipSpec(
    name="a100",
    peak_flops_bf16=312e12,
    hbm_bandwidth=2.0e12,
    hbm_bytes=80e9,
    ici_link_bandwidth=300e9,   # NVLink per direction, aggregate approx
    host_link_bandwidth=25e9,   # PCIe gen4 x16
)

CHIPS = {c.name: c for c in (TPU_V5E, A100)}

# The port's target card, NVIDIA H100 SXM5 80GB. Every figure is a
# data-sheet peak, not a measurement on this port:
H100 = ChipSpec(
    name="h100",
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5: dense BF16 tensor core
    peak_flops_bf16=989e12,
    # same data sheet: HBM3 memory bandwidth, SXM5
    hbm_bandwidth=3.35e12,
    # same data sheet: GPU memory, SXM5
    hbm_bytes=80e9,
    # same data sheet: NVLink 900 GB/s bidirectional, i.e. 450 GB/s each way
    ici_link_bandwidth=450e9,
    # same data sheet: PCIe Gen5 x16, 128 GB/s bidirectional = 64 GB/s each
    # way; not measured on this port's swap path, only shapes T_swap
    host_link_bandwidth=64e9,
)
CHIPS[H100.name] = H100


def dtype_bytes(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1,
            "float8_e4m3": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
            "int32": 4}[str(dtype)]
