#!/usr/bin/env python3
"""Extract the Kuka IIWA-14 robot model *data* from the reference GRiD codegen header.

The reference (``/root/reference/include/dynamics/iiwa/iiwa_eepos_grid.cuh``,
generated by the GRiD code generator from the public iiwa14 URDF) bakes the
robot model into two artifacts:

  * ``init_XImats`` (iiwa_eepos_grid.cuh:909): 728 floats =
      [0:252]    7 x (6x6 col-major) spatial motion transforms X_k   (static part)
      [252:504]  7 x (6x6 col-major) spatial inertias I_k            (fully static)
      [504:616]  7 x (4x4 col-major) homogeneous transforms Xhom_k   (static part)
      [616:728]  7 x (4x4 col-major) dXhom_k/dq_k                    (static part)
  * ``load_update_XImats_helpers`` / ``load_update_XmatsHom_helpers``
    (iiwa_eepos_grid.cuh:1770, :1917): per-q updates of the form
      M[flat_idx] = coef * sin(q_j)   or   coef * cos(q_j)
    plus a final copy of the 3x3 top-left rotation block into the bottom-right
    block of each 6x6 X matrix (iiwa_eepos_grid.cuh:1839-1843).

Every entry of X_k(q) / Xhom_k(q) is therefore affine in (sin q_k, cos q_k):

    X_k(q) = Xc_k + sin(q_k) * Xs_k + cos(q_k) * Xcos_k

This script parses those numeric constants (model *data*, not code) and emits
``mpcgpu/models/_iiwa14_data.py`` with the stacked constant tensors, from
which the JAX dynamics are built. Run:

    python tools/extract_grid_model.py
"""

import re
import sys
from pathlib import Path

import numpy as np

REF = Path("/root/reference/include/dynamics/iiwa/iiwa_eepos_grid.cuh")
OUT = Path(__file__).resolve().parent.parent / "mpcgpu" / "models" / "_iiwa14_data.py"

NQ = 7


def _find_function_body(src: str, signature_marker: str, start_hint: int = 0) -> str:
    """Return the brace-delimited body of the function whose def contains marker."""
    i = src.index(signature_marker, start_hint)
    j = src.index("{", i)
    depth = 0
    for k in range(j, len(src)):
        if src[k] == "{":
            depth += 1
        elif src[k] == "}":
            depth -= 1
            if depth == 0:
                return src[j : k + 1]
    raise ValueError(f"unbalanced braces after {signature_marker!r}")


def parse_base(src: str) -> np.ndarray:
    body = _find_function_body(src, "T* init_XImats()")
    base = np.zeros(728, dtype=np.float64)
    seen = np.zeros(728, dtype=bool)
    for m in re.finditer(
        r"h_XImats\[(\d+)\]\s*=\s*static_cast<T>\(([-+0-9.eE]+)\);", body
    ):
        idx, val = int(m.group(1)), float(m.group(2))
        base[idx] = val
        seen[idx] = True
    if not seen.all():
        missing = np.flatnonzero(~seen)
        raise ValueError(f"init_XImats missing {len(missing)} entries, e.g. {missing[:5]}")
    return base


_TERM = re.compile(
    r"^\s*(?P<sign>-?)\s*(?:(?P<coef>[0-9.eE+]+)\s*\*\s*)?s_temp\[(?P<tidx>\d+)\]\s*$"
)


def parse_updates(body: str, lhs_name: str):
    """Parse `lhs[idx] = static_cast<T>(expr);` where expr = (+-)coef*s_temp[t].

    Returns list of (flat_idx, joint, trig, coef) with trig in {"sin","cos"}.
    """
    out = []
    for m in re.finditer(
        rf"{lhs_name}\[(\d+)\]\s*=\s*static_cast<T>\((.*?)\);", body
    ):
        idx = int(m.group(1))
        expr = m.group(2).strip()
        t = _TERM.match(expr)
        if not t:
            raise ValueError(f"unparsed update expr for {lhs_name}[{idx}]: {expr!r}")
        coef = float(t.group("coef")) if t.group("coef") else 1.0
        if t.group("sign") == "-":
            coef = -coef
        tidx = int(t.group("tidx"))
        joint, trig = (tidx, "sin") if tidx < NQ else (tidx - NQ, "cos")
        out.append((idx, joint, trig, coef))
    return out


def build_affine(base_slice, updates, nmat, dim, local_offset=0):
    """Build (const, sin, cos) stacked [nmat, dim, dim] col-major matrices."""
    Xc = np.zeros((nmat, dim, dim))
    Xs = np.zeros((nmat, dim, dim))
    Xco = np.zeros((nmat, dim, dim))
    sz = dim * dim
    for k in range(nmat):
        Xc[k] = base_slice[k * sz : (k + 1) * sz].reshape(dim, dim, order="F")
    for idx, joint, trig, coef in updates:
        idx -= local_offset
        k, rem = divmod(idx, sz)
        c, r = divmod(rem, dim)
        if joint != k:
            raise ValueError(f"update for matrix {k} driven by joint {joint}")
        Xc[k, r, c] = 0.0  # dynamic entry: static part is replaced each call
        (Xs if trig == "sin" else Xco)[k, r, c] = coef
    return Xc, Xs, Xco


def main() -> None:
    src = REF.read_text()
    base = parse_base(src)

    xi_body = _find_function_body(
        src, "void load_update_XImats_helpers(T *s_XImats, const T *s_q"
    )
    x_updates = parse_updates(xi_body, "s_XImats")

    # the 3-arg hom updater contains both Xhom and dXhom updates
    hom_body = _find_function_body(
        src, "void load_update_XmatsHom_helpers(T *s_XmatsHom, T *s_dXmatsHom"
    )
    h_updates = parse_updates(hom_body, "s_XmatsHom")
    dh_updates = parse_updates(hom_body, "s_dXmatsHom")

    Xc, Xs, Xco = build_affine(base[:252], x_updates, NQ, 6)
    # reference copies the updated 3x3 top-left rotation into the bottom-right
    # block of every X (iiwa_eepos_grid.cuh:1839-1843); the copy is linear so it
    # applies to each affine component independently.
    for M in (Xc, Xs, Xco):
        M[:, 3:6, 3:6] = M[:, 0:3, 0:3]

    Imats = np.stack(
        [base[252 + k * 36 : 252 + (k + 1) * 36].reshape(6, 6, order="F") for k in range(NQ)]
    )

    Hc, Hs, Hco = build_affine(base[504:616], h_updates, NQ, 4)
    dHc, dHs, dHco = build_affine(base[616:728], dh_updates, NQ, 4, local_offset=0)

    # sanity: dXhom must equal d/dq Xhom  (derivative of affine form)
    assert np.allclose(dHc, 0), "static part of dXhom expected to vanish"
    assert np.allclose(dHs, -Hco), "dXhom sin coef must be -cos coef of Xhom"
    assert np.allclose(dHco, Hs), "dXhom cos coef must be +sin coef of Xhom"
    # sanity: inertias symmetric
    assert np.allclose(Imats, np.swapaxes(Imats, 1, 2), atol=1e-12)

    def fmt(name, arr):
        flat = ", ".join(repr(float(v)) for v in arr.ravel())
        return (
            f"{name} = _np.array([{flat}], dtype=_np.float64).reshape{arr.shape}\n"
        )

    with OUT.open("w") as f:
        f.write(
            '"""IIWA-14 model constants extracted from the reference GRiD codegen header.\n\n'
            "Generated by tools/extract_grid_model.py from\n"
            "/root/reference/include/dynamics/iiwa/iiwa_eepos_grid.cuh (init_XImats :909,\n"
            "load_update_XImats_helpers :1770, load_update_XmatsHom_helpers :1917).\n"
            "These are robot model *parameters* (from the public iiwa14 URDF), stored as\n"
            "the affine-in-(sin q, cos q) decomposition  X_k(q) = XC[k] + sin(q_k)*XS[k]\n"
            "+ cos(q_k)*XCOS[k]; likewise HOM* for the 4x4 homogeneous transforms.\n"
            '"""\n\nimport numpy as _np\n\nNQ = 7\n\n'
        )
        f.write(fmt("XC", Xc))
        f.write(fmt("XS", Xs))
        f.write(fmt("XCOS", Xco))
        f.write(fmt("IMATS", Imats))
        f.write(fmt("HOMC", Hc))
        f.write(fmt("HOMS", Hs))
        f.write(fmt("HOMCOS", Hco))
    n_upd = len(x_updates) + len(h_updates) + len(dh_updates)
    print(f"wrote {OUT} ({n_upd} dynamic entries parsed)")


if __name__ == "__main__":
    sys.exit(main())
