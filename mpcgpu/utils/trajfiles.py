"""Loaders for the reference trajectory fixtures (examples/trajfiles/, C19).

File formats (readCSVToVecVec, include/utils/experiment.cuh:144-170):
  * ``{s}_{g}_traj.csv``: rows of 21 = 14 state + 7 control per knot;
  * ``{s}_{g}_eepos.traj``: rows of 6 = ee [xyz, rpy] goal per knot.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_DEFAULT_DIR = Path("/root/reference/examples/trajfiles")
_LOCAL_DIR = Path(__file__).resolve().parent.parent.parent / "data" / "trajfiles"


def trajfile_dir() -> Path:
    """Preference: $MPCGPU_TRAJDIR > recorded reference traces (when the
    reference checkout is present) > generated standalone fixtures
    (data/trajfiles, produced by tools/make_trajfiles.py)."""
    env = os.environ.get("MPCGPU_TRAJDIR")
    if env:
        return Path(env)
    if _DEFAULT_DIR.is_dir():
        return _DEFAULT_DIR
    return _LOCAL_DIR


def _find(fname: str) -> Path:
    """Resolve per FILE, falling through from the reference checkout to the
    generated standalone fixtures when absent (the reference ships only the
    0_0 eepos trace, track_iiwa_pcg.cu:177; the generated fixture set in
    data/trajfiles covers the full 5x5 grid).  $MPCGPU_TRAJDIR, when
    set, is authoritative: a missing file there is an error, never a silent
    fall-through to a same-named fixture elsewhere."""
    env = os.environ.get("MPCGPU_TRAJDIR")
    if env:
        p = Path(env) / fname
        if not p.is_file():
            raise FileNotFoundError(
                f"{p} not found; $MPCGPU_TRAJDIR is set and treated as "
                f"authoritative (unset it to fall back to the bundled "
                f"fixtures)")
        return p
    for d in (_DEFAULT_DIR, _LOCAL_DIR):
        p = d / fname
        if p.is_file():
            return p
    return _DEFAULT_DIR / fname  # let the loader raise with the preferred path


def load_xu_traj(name: str = "0_0", dtype=np.float64) -> np.ndarray:
    """(steps, 21) state+control trace."""
    return np.loadtxt(_find(f"{name}_traj.csv"), delimiter=",", dtype=dtype)


def load_eepos_traj(name: str = "0_0", dtype=np.float64) -> np.ndarray:
    """(steps, 6) end-effector goal trace [xyz, rpy]."""
    return np.loadtxt(_find(f"{name}_eepos.traj"), delimiter=",", dtype=dtype)
