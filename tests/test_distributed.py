"""Two-process jax.distributed CPU test of parallel/distributed.py.

The multi-host/host-aligned-mesh path (initialize_distributed +
make_host_aligned_mesh) previously had zero executions anywhere; this spawns
two REAL processes wired through jax.distributed.initialize on localhost and
runs one knot-sharded PCG solve across them (the multi-host layout of
SURVEY.md section 5: knot axis within a host, instance axis across hosts).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
import numpy as np

# each process contributes 2 virtual CPU devices
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
import jax
jax.config.update("jax_platforms", "cpu")

from mpcgpu.parallel.distributed import (initialize_distributed,
                                             make_host_aligned_mesh)

coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
initialize_distributed(coordinator_address=coord, num_processes=nproc,
                       process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 2 * nproc

# knot axis = the 2 local devices of each host; instance axis spans hosts
mesh = make_host_aligned_mesh(n_knot_per_host=2)
assert mesh.shape["knot"] == 2 and mesh.shape["instance"] == nproc

# one sharded PCG solve on a small SPD block-tridiagonal system, identical
# on every process (globally-replicated inputs -> globally-identical result)
from jax.sharding import Mesh
from mpcgpu.parallel.pcg_sharded import pcg_solve_sharded

N, n = 8, 4
rng = np.random.default_rng(0)
theta = np.zeros((N, n, n)); phi = np.zeros((N, n, n))
for k in range(N):
    A = rng.standard_normal((n, n))
    theta[k] = A @ A.T + 4.0 * np.eye(n)
    if k > 0:
        phi[k] = 0.1 * rng.standard_normal((n, n))
S = np.zeros((N, 3, n, n))
S[:, 1] = theta; S[:, 0] = phi
S[:-1, 2] = np.swapaxes(phi[1:], -1, -2)
D = np.linalg.inv(theta)
Pinv = np.zeros_like(S); Pinv[:, 1] = D
gamma = rng.standard_normal((N, n))

import jax.numpy as jnp
knot_mesh = Mesh(np.asarray(jax.devices()).reshape(-1), axis_names=("knot",))
out = pcg_solve_sharded(
    jnp.asarray(S, jnp.float32), jnp.asarray(Pinv, jnp.float32),
    jnp.asarray(gamma, jnp.float32), jnp.zeros((N, n), jnp.float32),
    knot_mesh, max_iter=100, exit_tol=1e-10)
# dense oracle
dense = np.zeros((N * n, N * n))
for k in range(N):
    dense[k*n:(k+1)*n, k*n:(k+1)*n] = theta[k]
    if k > 0:
        dense[k*n:(k+1)*n, (k-1)*n:k*n] = phi[k]
        dense[(k-1)*n:k*n, k*n:(k+1)*n] = phi[k].T
ref = np.linalg.solve(dense, gamma.ravel()).reshape(N, n)
# the global result spans both processes; check the locally-addressable
# shards against the matching rows of the dense oracle
for shard in out.lam.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data), ref[shard.index],
                               atol=1e-4)

# the classic method (two halo exchanges and two dependent reductions per
# CG iteration, against the default pipelined method's one of each) across
# REAL process boundaries: same answer (L = 2 rows per device)
out2 = pcg_solve_sharded(
    jnp.asarray(S, jnp.float32), jnp.asarray(Pinv, jnp.float32),
    jnp.asarray(gamma, jnp.float32), jnp.zeros((N, n), jnp.float32),
    knot_mesh, max_iter=100, exit_tol=1e-10, method="classic")
for shard in out2.lam.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data), ref[shard.index],
                               atol=1e-4)
print(f"proc {pid}: distributed pcg ok, iters={int(out.iters)} "
      f"classic_iters={int(out2.iters)}", flush=True)
"""


def test_two_process_distributed_pcg(tmp_path):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    # the distributed coordinator must not inherit this test process's
    # forced single-platform config beyond what the worker sets itself
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    procs = [
        subprocess.Popen([sys.executable, str(script), coord, "2", str(pid)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         env=env, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "distributed pcg ok" in out, out
