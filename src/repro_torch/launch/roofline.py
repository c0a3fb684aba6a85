"""Roofline terms of a dry-run cell on the H100 (port of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds, each per device:
    compute    = FLOPs            / peak bf16 FLOP/s
    memory     = bytes            / HBM bytes/s
    collective = collective bytes / NVLink bytes/s (one direction)

The counts come from ``launch/op_cost.py`` (a traced step, per device);
the rates are the H100's from ``kernels/cost.py`` (the data sheet: 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s a GPU a
direction). The collective term assumes that every device of a mesh
shares one NVLink domain: NVIDIA's NVLink Switch System joins up to 256
H100s at that rate, the 16 x 16 mesh. On 8-GPU nodes joined by 400 Gb/s
InfiniBand (50 GB/s a GPU a direction) an axis wider than 8 crosses nodes
and its collectives may take up to 9x the term; the 2 x 16 x 16 mesh's
512 devices exceed one domain, so its ``pod`` axis crosses one. The term
is a lower bound there. The memory and collective terms follow DTensor's
plans, which differ between torch releases (``dryrun.PLAN_DEPENDENT``).
``roofline_fraction`` and ``useful_ratio`` keep the reference's
definitions: the model's ideal compute time over the dominant term, and
the model's FLOPs (6 N D train, 2 N D serve) over the step's.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

from repro_torch.kernels.cost import (BF16_FLOPS, HBM_BYTES_PER_S,
                                      NVLINK_SEND_BYTES_PER_S)

PEAK_FLOPS = BF16_FLOPS
HBM_BW = HBM_BYTES_PER_S
LINK_BW = NVLINK_SEND_BYTES_PER_S

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def collective_stats(breakdown: dict) -> dict:
    """Per-collective-kind {count, bytes} of a traced step's breakdown
    (``op_cost.Report.collective_breakdown``), every kind present."""
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}
    for k, v in breakdown.items():
        out[k] = {"count": v["count"], "bytes": v["bytes"]}
    return out


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float            # fused lower bound
    collective_bytes_per_device: float
    collective_breakdown: dict
    model_flops_global: float          # 6*N*D (train) / 2*N*D (serve)
    bytes_per_device_ub: float = 0.0   # unfused op-level upper bound
    bytes_by_op: Optional[dict] = None
    compute_s: float = 0.0
    memory_s: float = 0.0
    memory_ub_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0          # MODEL_FLOPS / traced FLOPs (global)
    memory_per_device: Optional[dict] = None

    def finish(self) -> "RooflineTerms":
        self.compute_s = self.flops_per_device / PEAK_FLOPS
        self.memory_s = self.bytes_per_device / HBM_BW
        self.memory_ub_s = self.bytes_per_device_ub / HBM_BW
        self.collective_s = self.collective_bytes_per_device / LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        traced_global = self.flops_per_device * self.chips
        self.useful_ratio = (self.model_flops_global / traced_global
                             if traced_global else 0.0)
        return self

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """How close the dominant term's time is to the pure-compute ideal
        of the model FLOPs: the headline score."""
        ideal = self.model_flops_global / (self.chips * PEAK_FLOPS)
        return ideal / self.bound_time_s if self.bound_time_s else 0.0

    def as_dict(self) -> dict:
        d = asdict(self)
        d["bound_time_s"] = self.bound_time_s
        d["roofline_fraction"] = self.roofline_fraction
        return d


def model_flops(n_params_active: int, tokens_per_step: int,
                kind: str) -> float:
    """6*N*D for training, 2*N*D for forward-only (prefill/decode)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens_per_step
