"""Simulation runtime: the paper's failure pipeline with real numerics (the
port of ``repro.simrt``)."""
from repro_torch.simrt.runtime import (CostModel, RunResult, SimRuntime,
                                       TimeBreakdown)

__all__ = ["SimRuntime", "CostModel", "RunResult", "TimeBreakdown"]
