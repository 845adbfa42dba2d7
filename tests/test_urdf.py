"""URDF loader (models/urdf.py): the reference's URDF -> GRiD -> baked-header
onboarding workflow, replaced by runtime loading into RobotModel tensors.

Oracles are independent of the loader's internals:
  * exact tensor round-trip against the programmatic chain builder;
  * FK against a plain numpy product-of-homogeneous-transforms oracle that
    consumes the raw URDF parameters (validates the arbitrary-axis frame
    bookkeeping end to end);
  * two URDF descriptions of the SAME physical robot (y-axis joint vs
    rpy-rotated z-axis joint) must produce identical joint-space dynamics;
  * fixed-link mass lumping against a hand-computed parallel-axis model.
"""

import numpy as np
import jax
import jax.numpy as jnp

from mpcgpu.models import dynamics
from mpcgpu.models.chain import planar_arm
from mpcgpu.models.urdf import _rpy_matrix, load_urdf

jax.config.update("jax_enable_x64", True)


def _link(name, mass=None, com="0 0 0", inertia=None, rpy="0 0 0"):
    if mass is None:
        return f'<link name="{name}"/>'
    ixx, iyy, izz, ixy, ixz, iyz = inertia
    return f"""<link name="{name}"><inertial>
      <origin xyz="{com}" rpy="{rpy}"/><mass value="{mass}"/>
      <inertia ixx="{ixx}" iyy="{iyy}" izz="{izz}" ixy="{ixy}" ixz="{ixz}" iyz="{iyz}"/>
    </inertial></link>"""


def _joint(name, jtype, parent, child, xyz="0 0 0", rpy="0 0 0",
           axis="0 0 1"):
    ax = f'<axis xyz="{axis}"/>' if jtype != "fixed" else ""
    return f"""<joint name="{name}" type="{jtype}">
      <origin xyz="{xyz}" rpy="{rpy}"/>{ax}
      <parent link="{parent}"/><child link="{child}"/></joint>"""


def _robot(*parts):
    return '<robot name="test">' + "".join(parts) + "</robot>"


def _planar_urdf(nq=3, L=0.5, m=1.0):
    rod = (1e-4, m * L * L / 12.0, m * L * L / 12.0, 0.0, 0.0, 0.0)
    parts = [_link("base")]
    for k in range(nq):
        parts.append(_link(f"l{k}", m, f"{L/2} 0 0", rod))
        parts.append(_joint(f"j{k}", "revolute", "base" if k == 0 else f"l{k-1}",
                            f"l{k}", xyz="0 0 0" if k == 0 else f"{L} 0 0"))
    parts.append(_link("tool"))
    parts.append(_joint("jee", "fixed", f"l{nq-1}", "tool", xyz=f"{L} 0 0"))
    return _robot(*parts)


def test_roundtrip_planar_arm():
    """z-axis URDF == the programmatic builder, tensor for tensor."""
    nq, L, m = 3, 0.5, 1.0
    got = load_urdf(_planar_urdf(nq, L, m), dtype=jnp.float64)
    want = planar_arm(nq=nq, link_len=L, link_mass=m, dtype=jnp.float64)
    for f in ("xc", "xs", "xcos", "inertia", "hc", "hs", "hcos"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            atol=1e-14, err_msg=f)


def _fk_oracle(joints, q):
    """numpy FK straight from URDF (origin, axis) params: T = prod over
    joints of origin-hom @ rot(axis, q)."""
    T = np.eye(4)
    qi = 0
    for j in joints:
        O = np.eye(4)
        O[:3, :3] = _rpy_matrix(j.get("rpy", np.zeros(3)))
        O[:3, 3] = j.get("xyz", np.zeros(3))
        T = T @ O
        if j["type"] != "fixed":
            a = np.asarray(j["axis"], float)
            a = a / np.linalg.norm(a)
            ax = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                           [-a[1], a[0], 0]])
            R = (np.eye(3) + np.sin(q[qi]) * ax
                 + (1 - np.cos(q[qi])) * ax @ ax)
            J = np.eye(4)
            J[:3, :3] = R
            T = T @ J
            qi += 1
    return T


def test_fk_arbitrary_axes_vs_numpy_oracle():
    """Joints about x, -z, and a skew axis, with origin rotations and a
    trailing fixed tool joint: fk must match the straight numpy product."""
    rod = (1e-3, 2e-2, 2e-2, 0.0, 0.0, 0.0)
    joints = [
        dict(type="revolute", axis=[1, 0, 0], xyz=[0.0, 0.0, 0.3],
             rpy=[0.0, 0.0, 0.0]),
        dict(type="revolute", axis=[0, 0, -1], xyz=[0.1, 0.0, 0.2],
             rpy=[0.2, -0.3, 0.1]),
        dict(type="revolute", axis=[1, 1, 1], xyz=[0.0, 0.2, 0.1],
             rpy=[0.0, 0.4, 0.0]),
        dict(type="fixed", xyz=[0.0, 0.0, 0.15], rpy=[0.1, 0.0, 0.5]),
    ]
    parts = [_link("base")]
    prev = "base"
    for k, j in enumerate(joints):
        name = f"l{k}"
        parts.append(_link(name, 1.0, "0.05 0 0", rod) if j["type"] != "fixed"
                     else _link(name))
        parts.append(_joint(
            f"j{k}", j["type"], prev, name,
            xyz=" ".join(map(str, j["xyz"])), rpy=" ".join(map(str, j["rpy"])),
            axis=" ".join(map(str, j.get("axis", [0, 0, 1])))))
        prev = name
    model = load_urdf(_robot(*parts), dtype=jnp.float64)
    assert model.nq == 3

    rng = np.random.default_rng(7)
    for _ in range(4):
        q = rng.uniform(-2.0, 2.0, size=3)
        T = _fk_oracle(joints, q)
        got_hom = np.asarray(dynamics.fk_ee_hom(model, jnp.asarray(q)))
        np.testing.assert_allclose(got_hom, T, atol=1e-12)
        got = np.asarray(dynamics.fk_ee_xyz(model, jnp.asarray(q)))
        np.testing.assert_allclose(got, T[:3, 3], atol=1e-12)


def test_axis_vs_rpy_equivalent_dynamics():
    """The same physical robot written two ways — joint 2 about the y axis
    vs a z-axis joint in a frame pre-rotated by rpy=(-pi/2,0,0) with all
    downstream quantities re-expressed — must have identical joint-space
    dynamics and FK."""
    m, L = 1.4, 0.6
    rod = (1e-3, m * L * L / 12.0, m * L * L / 12.0, 0.0, 0.0, 0.0)
    # variant A: joint 2 about +y in the link-1 frame, link-2 com along x
    a = _robot(
        _link("base"),
        _link("l1", m, f"{L/2} 0 0", rod),
        _joint("j1", "revolute", "base", "l1"),
        _link("l2", m, f"{L/2} 0 0", rod),
        _joint("j2", "revolute", "l1", "l2", xyz=f"{L} 0 0", axis="0 1 0"),
        _link("tool"),
        _joint("jee", "fixed", "l2", "tool", xyz=f"{L} 0 0"),
    )
    # variant B: same joint as +z in a frame rotated by Rx(-pi/2); a point
    # with coords v in the A-frame has coords Rx(-pi/2)^T v = Rx(pi/2) v
    # in the B child frame: com (L/2,0,0) -> (L/2,0,0) (on the x axis, which
    # Rx leaves fixed); rod inertia diag(ixx,iyy,izz) -> diag(ixx,izz,iyy);
    # tool offset (L,0,0) -> (L,0,0).
    rodB = (1e-3, rod[2], rod[1], 0.0, 0.0, 0.0)
    b = _robot(
        _link("base"),
        _link("l1", m, f"{L/2} 0 0", rod),
        _joint("j1", "revolute", "base", "l1"),
        _link("l2", m, f"{L/2} 0 0", rodB),
        _joint("j2", "revolute", "l1", "l2", xyz=f"{L} 0 0",
               rpy=f"{-np.pi/2} 0 0", axis="0 0 1"),
        _link("tool"),
        _joint("jee", "fixed", "l2", "tool", xyz=f"{L} 0 0"),
    )
    ma = load_urdf(a, dtype=jnp.float64)
    mb = load_urdf(b, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    for _ in range(3):
        q = jnp.asarray(rng.uniform(-1.5, 1.5, 2))
        qd = jnp.asarray(rng.uniform(-1.0, 1.0, 2))
        qdd = jnp.asarray(rng.uniform(-1.0, 1.0, 2))
        np.testing.assert_allclose(
            np.asarray(dynamics.fk_ee_xyz(ma, q)),
            np.asarray(dynamics.fk_ee_xyz(mb, q)), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(dynamics.mass_matrix(ma, q)),
            np.asarray(dynamics.mass_matrix(mb, q)), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(dynamics.rnea(ma, q, qd, qdd)),
            np.asarray(dynamics.rnea(mb, q, qd, qdd)), atol=1e-12)


def test_fixed_link_mass_lumping():
    """A massive fixed tool link must lump into the last movable link:
    identical dynamics to a single link with the parallel-axis-combined
    inertial."""
    m1, mt, L, d = 2.0, 0.5, 0.5, 0.2
    I1 = np.diag([1e-3, 3e-2, 3e-2])
    It = np.diag([2e-3, 2e-3, 2e-3])
    c1 = np.array([L / 2, 0.0, 0.0])
    ct = np.array([0.05, 0.0, 0.0])          # tool com in tool frame
    # combined inertial of link+tool in the link frame (tool frame =
    # translation by d along x, no rotation)
    ct_in1 = np.array([d, 0.0, 0.0]) + ct
    mc = m1 + mt
    cc = (m1 * c1 + mt * ct_in1) / mc
    def _pa(I, m, r):                        # parallel-axis to point r away
        return I + m * ((r @ r) * np.eye(3) - np.outer(r, r))
    Ic = _pa(I1, m1, c1 - cc) + _pa(It, mt, ct_in1 - cc)

    def tup(I):
        return (I[0, 0], I[1, 1], I[2, 2], I[0, 1], I[0, 2], I[1, 2])

    with_tool = _robot(
        _link("base"),
        _link("l1", m1, f"{c1[0]} 0 0", tup(I1)),
        _joint("j1", "revolute", "base", "l1"),
        _link("tool", mt, f"{ct[0]} 0 0", tup(It)),
        _joint("jt", "fixed", "l1", "tool", xyz=f"{d} 0 0"),
    )
    lumped = _robot(
        _link("base"),
        _link("l1", mc, f"{cc[0]} {cc[1]} {cc[2]}", tup(Ic)),
        _joint("j1", "revolute", "base", "l1"),
    )
    ma = load_urdf(with_tool, dtype=jnp.float64)
    mb = load_urdf(lumped, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(ma.inertia), np.asarray(mb.inertia),
                               atol=1e-12)
    q = jnp.asarray([0.7])
    qd = jnp.asarray([-0.4])
    np.testing.assert_allclose(
        np.asarray(dynamics.rnea(ma, q, qd, jnp.asarray([0.3]))),
        np.asarray(dynamics.rnea(mb, q, qd, jnp.asarray([0.3]))), atol=1e-12)
    # and the ee lands at the tool frame origin
    np.testing.assert_allclose(
        np.asarray(dynamics.fk_ee_xyz(ma, q)),
        [d * np.cos(0.7), d * np.sin(0.7), 0.0], atol=1e-12)


def test_urdf_model_through_solver():
    """A URDF-loaded robot runs the full SQP stack (joint-space cost)."""
    from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
    from mpcgpu.solver.sqp import sqp_solve

    model = load_urdf(_planar_urdf(3), dtype=jnp.float32)
    N, nx, nu = 16, 6, 3
    dtype = jnp.float32
    q_goal = jnp.asarray([0.5, -0.3, 0.8], dtype)
    xu = jnp.zeros((N, nx + nu), dtype)
    xs = xu[0, :nx]
    goal = jnp.zeros((N, 6), dtype).at[:, :3].set(q_goal)
    lam = jnp.zeros((N, nx), dtype)
    cost = CostConfig(mode="joint", q_cost=1.0, qd_cost=1e-2, r_cost=1e-4)
    res = sqp_solve(model, cost, SQPConfig(max_iter=4),
                    PCGConfig(max_iter=60, exit_tol=1e-7),
                    xu, lam, xs, goal, 1e-3, 1.0 / 32.0)
    assert np.isfinite(float(res.merit))
    assert int(res.sqp_iters) >= 1
    # the plan moves the joints toward the goal
    q_end = np.asarray(res.xu[-1, :3])
    assert np.linalg.norm(q_end - np.asarray(q_goal)) < np.linalg.norm(
        np.asarray(q_goal))


def test_export_import_roundtrip_iiwa14():
    """export_urdf(iiwa14()) -> load_urdf reproduces the PRODUCTION model:
    every RobotModel tensor (including the baked ee transform and the real
    90-degree inter-joint frame rotations) and the recorded-trace dynamics."""
    from mpcgpu.models import iiwa14
    from mpcgpu.models.urdf import export_urdf

    want = iiwa14(dtype=jnp.float64)
    text = export_urdf(want, name="iiwa14")
    got = load_urdf(text, dtype=jnp.float64)
    assert got.nq == 7
    for f in ("xc", "xs", "xcos", "inertia", "hc", "hs", "hcos"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            atol=1e-12, err_msg=f)

    rng = np.random.default_rng(11)
    q = jnp.asarray(rng.uniform(-2, 2, 7))
    qd = jnp.asarray(rng.uniform(-1, 1, 7))
    np.testing.assert_allclose(np.asarray(dynamics.fk_ee(got, q)),
                               np.asarray(dynamics.fk_ee(want, q)), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(dynamics.rnea(got, q, qd, qd)),
        np.asarray(dynamics.rnea(want, q, qd, qd)), atol=1e-10)


def test_ee_link_with_downstream_movable_joint_rejected():
    """ee_link followed by a movable joint has no fixed offset from the last
    joint frame; must raise, not silently return the chain tip."""
    import pytest

    with pytest.raises(ValueError, match="downstream"):
        load_urdf(_planar_urdf(3), ee_link="l0")
    with pytest.raises(ValueError, match="downstream"):
        load_urdf(_planar_urdf(3), ee_link="l1")


def test_ee_link_last_movable_and_trailing_fixed_ok():
    """The documented-supported ee_link placements: the last movable link
    (frame origin = last joint origin) and the trailing fixed chain tip."""
    m_last = load_urdf(_planar_urdf(3, L=0.5), ee_link="l2", dtype=jnp.float64)
    m_tool = load_urdf(_planar_urdf(3, L=0.5), ee_link="tool", dtype=jnp.float64)
    q = jnp.zeros(3, jnp.float64)
    # at q=0 the planar chain lies along x: joint-2 origin at x=2L=1.0,
    # tool at x=3L=1.5
    np.testing.assert_allclose(np.asarray(dynamics.fk_ee(m_last, q))[:3],
                               [1.0, 0.0, 0.0], atol=1e-14)
    np.testing.assert_allclose(np.asarray(dynamics.fk_ee(m_tool, q))[:3],
                               [1.5, 0.0, 0.0], atol=1e-14)
