"""Float32 matmul-precision enforcement.

On an NVIDIA GPU, XLA's DEFAULT matmul precision lets float32 contractions
run on the tensor cores in TF32, which keeps a 10-bit mantissa (about three
decimal digits).  For this solver that is catastrophic: the Schur complement
and stair preconditioner blocks of a cond ~1e5-1e7 system come out wrong at
the 1e-3 level, CG stalls, and "converged" solutions carry large true
residuals.  Every public compute entry point is wrapped so all einsums and
matmuls trace with HIGHEST (full f32) precision — the reference's CUDA
arithmetic is genuine fp32 (settings.cuh:41-49), so this is also the
parity-correct choice.  The blocks are tiny (14x14), so the tensor cores
would buy nothing here anyway.

The precision is resolved when an operation is traced, so a wrapped entry
point covers everything traced inside it: its ``vmap`` and ``shard_map``
bodies, the closed-loop scans that call it, and nested jitted functions.
The PCG kernel (``ops/pcg_pallas.py``) uses no ``dot`` at all.
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Trace fn under jax.default_matmul_precision('highest')."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
