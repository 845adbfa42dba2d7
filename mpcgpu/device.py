"""Where the program runs, and which linear solver that allows.

This is the only module that looks at the platform.  Its rules:

* On ``gpu`` the default linear solver is ``"pcg_pallas"``, the whole-solve
  PCG kernel (``ops/pcg_pallas.py``), for the 3-band preconditioners it
  supports and horizons up to ``KERNEL_MAX_KNOTS``; ``"pcg"`` (the
  ``lax.while_loop`` PCG) otherwise.  The kernel streams S and Pinv through
  one SM every iteration, so its time grows with N, while the XLA loop's is
  set by a host round trip per iteration and hardly depends on N; on an
  H100 the kernel's SQP iteration is faster up to N = 256 and slower at
  N = 512 (PERF.md).
* On ``cpu`` the default is ``"pcg"``.
* An explicit kernel request on a platform that cannot compile it raises.
  Nothing falls back to another solver, and nothing runs in the Pallas
  interpreter: ``interpret=`` is a parameter of the kernel wrapper alone,
  which only tests set.
* Any other platform raises.
"""

from __future__ import annotations

import jax

PLATFORMS = ("gpu", "cpu")
# linsys values that name a GPU kernel
KERNEL_LINSYS = ("pcg_pallas",)
# preconditioners whose Pinv is block-tridiagonal (the kernel's stencil)
THREE_BAND_PRECONDITIONERS = ("stair", "jacobi", "none")
# longest horizon at which the kernel beat the XLA loop on the H100
KERNEL_MAX_KNOTS = 256


def platform() -> str:
    """The platform of the default device: "gpu" or "cpu"."""
    p = jax.devices()[0].platform
    if p not in PLATFORMS:
        raise RuntimeError(f"unsupported platform {p!r}; this program runs "
                           f"on {' or '.join(PLATFORMS)}")
    return p


def default_linsys(preconditioner: str, knots: int) -> str:
    if (platform() == "gpu" and preconditioner in THREE_BAND_PRECONDITIONERS
            and knots <= KERNEL_MAX_KNOTS):
        return "pcg_pallas"
    return "pcg"


def resolve_linsys(linsys: str, preconditioner: str, knots: int) -> str:
    """Turn ``"auto"`` into the platform's default for this preconditioner
    and horizon, and check a kernel request against the platform and the
    preconditioner."""
    if linsys == "auto":
        return default_linsys(preconditioner, knots)
    if linsys in KERNEL_LINSYS:
        if platform() != "gpu":
            raise ValueError(
                f"linsys={linsys!r} is a GPU kernel and this process runs on "
                f"{platform()!r}; use linsys='pcg' or 'auto'")
        if preconditioner not in THREE_BAND_PRECONDITIONERS:
            raise ValueError(
                f"linsys={linsys!r} supports the 3-band preconditioners "
                f"{THREE_BAND_PRECONDITIONERS}, not {preconditioner!r}; use "
                f"linsys='pcg' or 'auto'")
    return linsys
