"""Multi-process process-group smoke test (SURVEY.md §7 step 6).

Exercises parallel/distributed.py:initialize_cluster for real: two OS
processes form a jax.distributed process group over the CPU backend, build
the global mesh with graph_mesh(), and run one psum across processes.
This is the one subsystem a single-process pytest can never execute —
every other distributed test uses the in-process 8-device CPU mesh.

The reference has no analogue (strictly single-GPU, SURVEY.md §2.6).
"""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["DGNN_REPO"])
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=1")
import jax
jax.config.update("jax_platforms", "cpu")

from dgnn.parallel.distributed import graph_mesh, initialize_cluster

initialize_cluster(coordinator_address=os.environ["DGNN_COORD"],
                   num_processes=2,
                   process_id=int(os.environ["DGNN_PID"]))
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 2, jax.device_count()

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

mesh = graph_mesh()
assert mesh.size == 2

# one global array sharded across the two processes; psum it
local = jnp.full((1, 4), float(jax.process_index() + 1))
glob = jax.make_array_from_single_device_arrays(
    (2, 4), NamedSharding(mesh, P("graph", None)),
    [jax.device_put(local, jax.local_devices()[0])])


@jax.jit
@shard_map(mesh=mesh, in_specs=P("graph", None), out_specs=P("graph", None))
def f(x):
    return jax.lax.psum(x, "graph")


out = f(glob)
vals = np.asarray(out.addressable_shards[0].data)
assert np.all(vals == 3.0), vals  # 1 + 2 from both processes
print(f"OK process {jax.process_index()} sum {float(vals[0, 0])}",
      flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cluster():
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = []
    for pid in range(2):
        env = dict(env_base, DGNN_REPO=REPO,
                   DGNN_COORD=f"127.0.0.1:{port}", DGNN_PID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{err[-2000:]}"
        assert "OK process" in out, out
