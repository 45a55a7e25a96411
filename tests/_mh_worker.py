"""Worker process for test_multiprocess.py: one of N jax.distributed
processes driving the multi-host pipeline end-to-end with UNEQUAL
per-process contributions.

Scenarios:
  interp       — distribute_queries -> sharded_interpolate_at ->
                 collect_results; process p contributes 5 + 4*p queries.
  interp_zero  — same, but with a ZERO-contribution process (p == 1
                 passes b_local = 0, exercising distribute_queries'
                 empty-block filler path).
  trace        — distribute_queries of circle seed points ->
                 sharded_trace -> collect_results on TraceResult fields.

Invoked as:
    python tests/_mh_worker.py <coordinator> <num_procs> <proc_id> \
        <outfile> [scenario]
"""

import os
import sys

coordinator, num_procs, proc_id, outfile = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
)
scenario = sys.argv[5] if len(sys.argv) > 5 else "interp"

# Force CPU with 2 local virtual devices BEFORE jax initializes
# (both the env var and the config update, so that a preset
# JAX_PLATFORMS or a GPU on the host cannot win)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

jax.distributed.initialize(
    coordinator_address=coordinator,
    num_processes=num_procs,
    process_id=proc_id,
)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import interpolate_unstructured_tpu as iu  # noqa: E402
from interpolate_unstructured_tpu.parallel import sharding as sh  # noqa: E402
from interpolate_unstructured_tpu.utils import meshgen  # noqa: E402

assert jax.process_count() == num_procs
assert len(jax.devices()) == 2 * num_procs, jax.devices()

mesh = sh.make_mesh()

if scenario in ("interp", "interp_zero"):
    # Identical grid built in every process (deterministic construction)
    points, cells, neighbors = meshgen.tet_box_mesh(4, 4, 4)
    grid = iu.build_grid(
        points, cells, neighbors, "tetra",
        point_data={"Polynomial": points.sum(axis=1) + 1.0},
        locate_mode="walk",
    )
    grid = sh.replicate_grid(grid, mesh)

    # Unequal contributions that also force per-process padding:
    # process p contributes 5 + 4*p queries (5, 9, ...), padded to the
    # 2-device multiple (6, 10, ...) inside distribute_queries.  In
    # the interp_zero scenario process 1 contributes NOTHING — its
    # shards are pure filler (parallel/sharding.py's empty-block path).
    rng = np.random.default_rng(100 + proc_id)
    b_local = 5 + 4 * proc_id
    if scenario == "interp_zero" and proc_id == 1:
        b_local = 0
    r_local = rng.random((b_local, 3))

    r_global, local_b = sh.distribute_queries(r_local, mesh)
    assert local_b == b_local

    f = sh.sharded_interpolate_at(mesh)
    vals, ic, found = f(grid, r_global, jnp.asarray([0]))

    vals_np = sh.collect_results(vals, local_b)
    found_np = sh.collect_results(found, local_b)

    np.savez(
        outfile,
        vals=vals_np,
        found=found_np,
        r_local=r_local,
        proc_id=np.asarray([proc_id]),
    )
    print(f"worker {proc_id}: collected {vals_np.shape} ok", flush=True)

elif scenario == "trace":
    # 2-D triangle mesh with the circular field v = (-(y-1), x-1):
    # seeds on the radius-0.5 circle around (1, 1) trace closed orbits
    points, cells, neighbors = meshgen.triangle_rect_mesh(4, 4)
    pts = np.asarray(points)
    grid = iu.build_grid(
        points, cells, neighbors, "triangle",
        point_data={
            "vx": -(pts[:, 1] - 1.0),
            "vy": pts[:, 0] - 1.0,
        },
    )
    grid = sh.replicate_grid(grid, mesh)

    # unequal seed counts per process (3, 5, 7, ...)
    b_local = 3 + 2 * proc_id
    angles = (
        2 * np.pi * (proc_id * 97 + np.arange(b_local)) / 31.0
    )
    y_local = np.stack(
        [1.0 + 0.5 * np.cos(angles), 1.0 + 0.5 * np.sin(angles)], axis=1
    )

    y_global, local_b = sh.distribute_queries(y_local, mesh)
    assert local_b == b_local

    tracer = sh.sharded_trace(
        mesh, min_dx=1e-5, max_dx=0.05, max_steps=60,
        rtol=1e-6, atol=1e-8,
    )
    res = tracer(grid, y_global, jnp.asarray([0, 1]))

    y_np = sh.collect_results(res.y, local_b)
    nsteps_np = sh.collect_results(res.n_steps, local_b)
    bm_np = sh.collect_results(res.boundary_material, local_b)

    np.savez(
        outfile,
        y=y_np,
        n_steps=nsteps_np,
        boundary_material=bm_np,
        y_local=y_local,
        proc_id=np.asarray([proc_id]),
    )
    print(f"worker {proc_id}: traced {y_np.shape} ok", flush=True)

else:
    raise SystemExit(f"unknown scenario {scenario!r}")
