"""The yardstick: one NVIDIA H100 SXM's published peaks (data sheet, dense
rates, 700 W) and the least time a piece of work can take on it. A frozen
copy of the bound that `chip_smoke.py` computes from `launch/mesh.py`, kept
here so that a change to the program cannot move it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12, "int32": 67e12}


def bound_s(bytes_moved: float, ops: float = 0.0, kind: str = "bf16") -> float:
    """Seconds the work needs at least: the larger of its bytes over the HBM
    rate and its operations over the peak rate of `kind`."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def share_pct(bound: float, measured: float):
    """bound / measured in percent, or None where nothing was measured."""
    if not measured or measured <= 0:
        return None
    return 100.0 * bound / measured
