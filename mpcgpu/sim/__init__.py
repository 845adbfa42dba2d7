"""Closed-loop MPC simulation (plant stepping, warm-start shifting, tracking)."""

from mpcgpu.sim.mpc import MPCStats, simulate_mpc

__all__ = ["MPCStats", "simulate_mpc"]
