"""Runtime configuration for the solver stack.

The reference encodes every knob as a compile-time ``#define``
(include/common/settings.cuh:1-199).  Here the same knobs are runtime
dataclasses; anything that affects traced shapes or loop bounds is a static
field of the jitted functions (hashable, frozen dataclasses).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class CostConfig:
    """Tracking-cost weights (settings.cuh:84-94, iiwa_eepos_plant.cuh:240-401)."""

    qd_cost: float = 1e-4           # QD_COST
    r_cost: float = 1e-4            # R_COST (reference uses 1e-3 when N==64)
    # cost mode: "ee" = end-effector xyz tracking (iiwa_eepos_plant.cuh, the
    # active reference build); "joint" = joint-state reference tracking
    # (iiwa_plant.cuh, the reference's inactive variant). In joint mode the
    # goal array is the (N, nx) state reference and q_cost weighs positions.
    mode: str = "ee"
    q_cost: float = 1.0             # Q_COST (joint mode only)
    # penalize qd absolutely instead of relative to the reference
    # (ABSOLUTE_QD_PENALTY, settings.cuh:79; joint mode only — ee mode is
    # always absolute, iiwa_eepos_plant.cuh:263)
    absolute_qd_penalty: bool = False
    # Evaluate the terminal cost gradient/Hessian at the last state x_{N-1}.
    # The reference evaluates it at x_{N-2} (iiwa_eepos_plant.cuh:399 passes
    # s_xux, i.e. knot N-2's state, to the terminal block); set False to
    # replicate that behavior bit-for-bit.
    terminal_at_last_state: bool = True

    @staticmethod
    def for_knots(knot_points: int) -> "CostConfig":
        # settings.cuh:84-90: R_COST = .001 iff KNOT_POINTS == 64 else .0001
        return CostConfig(r_cost=1e-3 if knot_points == 64 else 1e-4)


@_frozen
class PCGConfig:
    """PCG solver knobs (pcg_config<T>, mpcsim.cuh:213-217; settings.cuh:123-144)."""

    max_iter: int = 173
    exit_tol: float = 1e-5
    # 'stair' = symmetric-stair preconditioner (pcg/linsys_setup.cuh:9-137),
    # 'jacobi' = block-diagonal only, 'none' = identity, 'stair2' = stair
    # plus the next Neumann term (block-pentadiagonal, unconditionally SPD;
    # XLA PCG path only — measured workload-neutral at operating tolerances,
    # see PARITY.md preconditioner-variant study / benchmarks/precond_study.py).
    preconditioner: str = "stair"
    # Exit test metric. 'eta' (default) exits on |r . P^{-1} r| < exit_tol —
    # THE reference/GBD-PCG semantics (re-derived round 5, SURVEY.md C17):
    # the reference kernel's only scalar reductions are p.Sp and eta
    # (d_v_temp / d_eta_new_temp, pcg/sqp.cuh:120-125), and its warm-up tol
    # of 1e-11 (mpcsim.cuh:224) is reachable only by eta in f32.  The
    # reference tolerance tables (track_iiwa_pcg.cu:46-73) therefore
    # transfer under 'eta'.  'rnorm' exits on ||r||_2 < exit_tol — an
    # absolute residual criterion kept as a research variant; at the
    # reference tolerances it sits ORDERS OF MAGNITUDE below the f32
    # attainable residual floor on this problem scaling (measured
    # 3.5e-3..0.1 at N=64, tools/diagnose_rnorm.py) and is therefore always
    # cap-bound — the round-4 "cap-bound pathology" was this mis-inferred
    # criterion, not a solver defect.
    exit_criterion: str = "eta"
    # Per-SQP-iteration forcing tolerance (Eisenstat-Walker style; the
    # reference always solves at the fixed exit_tol).  'fixed' = exit_tol
    # every iteration.  'ew' = the first linear solve runs at
    # exit_tol * ew_boost0 and the tolerance tightens every successful
    # iteration by min(ew_decay, merit_ratio^ew_alpha) — the merit-ratio
    # term tracks fast nonlinear progress, the geometric ew_decay floor
    # guarantees the target tolerance is reached even when the merit
    # plateaus (it converges to a nonzero tracking cost, unlike a root-
    # finding residual); a line-search failure drops straight to the target
    # tolerance.  Early SQP iterations don't pay for residual accuracy the
    # outer linearization error would waste anyway.
    forcing: str = "fixed"
    ew_boost0: float = 100.0
    ew_alpha: float = 1.5
    ew_decay: float = 0.1

    @staticmethod
    def tuned_max_iter(knot_points: int) -> int:
        # settings.cuh:124-144 ("values found using experiments")
        return {32: 173, 64: 167, 128: 167, 256: 118, 512: 67}.get(knot_points, 200)


@_frozen
class SQPConfig:
    """SQP outer-loop knobs (settings.cuh:147-196, pcg/sqp.cuh:51-67)."""

    max_iter: int = 20              # SQP_MAX_ITER (timing mode)
    max_time_us: Optional[float] = 2000.0   # SQP_MAX_TIME_US; None = no wall cap
    num_alphas: int = 8             # pcg/sqp.cuh:52, alpha_i = -1/2^i
    mu: float = 10.0                # l1 merit penalty (pcg/sqp.cuh:51)
    rho_min: float = 1e-3           # RHO_MIN
    rho_factor: float = 1.2         # RHO_FACTOR
    rho_max: float = 10.0           # RHO_MAX
    rho_reset: float = 1e-3


@_frozen
class SimConfig:
    """Closed-loop MPC simulator knobs (mpcsim.cuh:146-426, settings.cuh:56-72)."""

    simulation_period_us: float = 2000.0    # SIMULATION_PERIOD (const-freq mode)
    const_update_freq: bool = True          # CONST_UPDATE_FREQ
    shift_threshold_frac: float = 1.0       # SHIFT_THRESHOLD = frac * timestep
    sim_step_time: float = 2e-4             # plant substep (integrator.cuh:304)
    max_control_updates: int = 100000
    # Warm-up solve count (REMOVE_JITTERS, mpcsim.cuh:222-242).  The
    # reference defaults to 100 discarded solves — partly masking its
    # per-call cudaMalloc and first-launch latency.  Here one warm call is
    # always made to compile the program (jit caches it), so the default is
    # 0 extra; set 100 to replicate the reference protocol exactly (the
    # drivers expose --remove-jitters).
    remove_jitters: int = 0
    # stream the measured state every control step
    # (LIVE_PRINT_PATH, settings.cuh:20-26, mpcsim.cuh:256-262)
    live_print_path: bool = False
    # when True, enforce SQP_MAX_TIME_US (sqpTimecheck, pcg/sqp.cuh:161-169).
    time_budget_mode: bool = False
    # 'ondevice' (default): one-time calibration measures the per-SQP-
    # iteration device latency and converts max_time_us into a TRACED
    # iteration cap inside the jitted while_loop — zero extra host round
    # trips per control step. 'host': chunked 1-iteration solves with host
    # wall-clock checks between them (stage-accurate but round-trip-bound).
    time_budget_impl: str = "ondevice"
