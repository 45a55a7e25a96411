"""Full benchmark suite — the five configs of BASELINE.md.

1. triangle.vtu     — 2D scalar interpolation at scattered points
2. quad.vtu         — bilinear quad interpolation + cell-data lookup
3. tetra.vtu        — 3D tet barycentric multi-variable interpolation
4. synthetic ~1M-cell tet mesh, 10M random cold queries (bin-seeded walk)
5. field-line tracing on a tet mesh (warm-start coherent walks)

Run:  python benchmarks/bench_suite.py [--small]
Emits one JSON line per config on stdout.

Timing: each measured call ends in ``jax.block_until_ready``; the best
of several warm calls is kept.  Runs only on a GPU: without one it stops
with a "no GPU" error.  Every line names the device (platform,
device_kind, count) and the card's name and power limit.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The bundled fixtures (tests/data/make_fixtures.py)
FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
    "data",
)
DEVICE = {}  # set by main(): JAX device description + card info


def best_time(fn, *args, reps=3):
    """Best wall time of ``fn(*args)`` over ``reps`` warm calls, each
    ending in ``block_until_ready``; returns (seconds, last result).
    Grids are jit ARGUMENTS, never closures (closed-over arrays would
    be embedded in the program as constants)."""
    import jax

    out = jax.block_until_ready(fn(*args))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def emit(name, value, unit, **extra):
    print(json.dumps({"config": name, "value": value, "unit": unit,
                      **DEVICE, **extra}))


DTYPE = None  # set by main(); None = default (float32)
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "bench")


def load_fixture_grid(name, tmpdir, **kw):
    import shutil

    from interpolate_unstructured_tpu import read_grid

    src = os.path.join(FIXTURE_DIR, name)
    dst = os.path.join(tmpdir, name)
    shutil.copy(src, dst)
    return read_grid(dst, dtype=DTYPE, **kw)


def bench_fixture_interpolation(name, n_queries, tmpdir, multi=False):
    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import (
        add_point_data,
        get_point_data_index,
        interpolate_at,
    )

    grid = load_fixture_grid(name, tmpdir)
    ivar = get_point_data_index(grid, "Polynomial")
    i_vars = [ivar]
    if multi:
        pts = np.asarray(grid.points)
        grid, i2 = add_point_data(grid, "vx", pts[:, 0])
        grid, i3 = add_point_data(grid, "vy", pts[:, 1])
        i_vars = [ivar, i2, i3]
    rng = np.random.default_rng(0)
    rmin, rmax = np.asarray(grid.rmin), np.asarray(grid.rmax)
    r = jnp.asarray(
        rmin + rng.random((n_queries, 3)) * (rmax - rmin), grid.dtype
    )
    iv = jnp.asarray(i_vars)

    dt, _ = best_time(
        jax.jit(lambda g, r: interpolate_at(g, r, list(i_vars))), grid, r
    )
    emit(
        f"{name} interpolate x{len(i_vars)}",
        n_queries / dt,
        "queries/s",
        seconds=dt,
    )


def bench_quad_cell_data(n_queries, tmpdir):
    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import add_cell_data, get_cell_scalar_at

    grid = load_fixture_grid("quad.vtu", tmpdir)
    grid, icd = add_cell_data(
        grid, "rho", np.arange(grid.n_cells, dtype=float)
    )
    rng = np.random.default_rng(1)
    rmin, rmax = np.asarray(grid.rmin), np.asarray(grid.rmax)
    r = jnp.asarray(
        rmin + rng.random((n_queries, 3)) * (rmax - rmin), grid.dtype
    )

    dt, _ = best_time(
        jax.jit(lambda g, r: get_cell_scalar_at(g, r, icd, fill_value=0.0)),
        grid, r,
    )
    emit("quad.vtu cell-data lookup", n_queries / dt, "queries/s", seconds=dt)


def make_tet_grid(n_side, cache=True):
    """Build (or reload) the synthetic tet grid; large grids round-trip
    through save_grid/load_grid so repeated suite runs skip the
    minutes-long host preprocessing (and prove the checkpoint path)."""
    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import build_grid
    from interpolate_unstructured_tpu.io.checkpoint import load_grid, save_grid
    from interpolate_unstructured_tpu.utils import meshgen

    tag = "f64" if DTYPE == jnp.float64 else "f32"
    fn = os.path.join(CACHE_DIR, f"tet{n_side}_{tag}.binda")
    if cache and os.path.exists(fn):
        return load_grid(fn, resave_on_rebuild=True)
    points, cells, neighbors = meshgen.tet_box_mesh(n_side, n_side, n_side)
    grid = build_grid(
        points,
        cells,
        neighbors,
        "tetra",
        point_data={"Polynomial": points.sum(axis=1) + 1.0},
        locate_mode="walk",
        dtype=DTYPE,
    )
    if cache and n_side >= 24:
        os.makedirs(CACHE_DIR, exist_ok=True)
        save_grid(grid, fn)
    return grid


def bench_large_tet(n_side, n_queries):
    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import interpolate_scalar_at

    t0 = time.perf_counter()
    grid = make_tet_grid(n_side)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)
    r = jnp.asarray(rng.random((n_queries, 3)), grid.dtype)

    dt, _ = best_time(
        jax.jit(lambda g, r: interpolate_scalar_at(g, r, 0, fill_value=0.0)),
        grid, r,
    )
    emit(
        f"synthetic tet {grid.n_cells} cells, {n_queries} cold queries",
        n_queries / dt,
        "queries/s",
        seconds=dt,
        build_seconds=build_s,
        n_cells=grid.n_cells,
    )


def bench_trace_tet(n_side, n_traj, max_steps=256):
    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import add_point_data
    from interpolate_unstructured_tpu.trace import (
        build_trace_table,
        integrate_along_field,
    )
    from interpolate_unstructured_tpu.utils.serial_oracle import serial_trace

    grid = make_tet_grid(n_side)
    pts = np.asarray(grid.points)
    # Helical field around the box axis.  fuse=False: the tracer reads
    # the field through its own fused trace table, so extending the
    # multi-GB candidate rows to these variables would be pure cost.
    cx = pts[:, :2] - 0.5
    grid, ivx = add_point_data(grid, "vx", -cx[:, 1], fuse=False)
    grid, ivy = add_point_data(grid, "vy", cx[:, 0], fuse=False)
    grid, ivz = add_point_data(grid, "vz", np.full(grid.n_points, 0.25),
                               fuse=False)
    rng = np.random.default_rng(3)
    y0 = jnp.asarray(
        0.3 + 0.4 * rng.random((n_traj, 3)), grid.dtype
    )

    def run(g, tt, y0):
        return integrate_along_field(
            g,
            y0,
            (ivx, ivy, ivz),
            nvar=0,
            min_dx=1e-4,
            max_dx=0.05,
            max_steps=max_steps,
            rtol=1e-3,
            atol=1e-3,
            trace_table=tt,
        )

    # The fused per-cell trace table (244 MB at the 1M-cell scale) is
    # prebuilt ONCE and passed in: assembled inline it is re-gathered
    # every call.  Repeated traces over one field are the reference's
    # own usage model (benchmark/test_trace_field reuse the grid).
    ttable = build_trace_table(grid, jnp.asarray((ivx, ivy, ivz)))
    ttable_mb = ttable.nbytes / 2**20

    dt, res = best_time(jax.jit(run), grid, ttable, y0)
    total_pts = int(np.asarray(res.n_steps).clip(max=max_steps).sum())

    # Single-core compiled denominator: the same bundle through the C++
    # reference-algorithm oracle, amortized over a subset when the
    # bundle is large.
    ns = min(n_traj, 256)
    fld = np.stack(
        [-cx[:, 1], cx[:, 0], np.full(grid.n_points, 0.25)], axis=1
    )
    t0 = time.perf_counter()
    _, _, s_steps, _ = serial_trace(
        np.asarray(grid.points), np.asarray(grid.cells),
        np.asarray(grid.neighbors), fld, np.asarray(y0[:ns]),
        min_dx=1e-4, max_dx=0.05, max_steps=max_steps, rtol=1e-3,
        atol=1e-3,
    )
    serial_rate = float(s_steps.clip(max=max_steps).sum()) / (
        time.perf_counter() - t0
    )

    emit(
        f"trace {n_traj} field lines, tet mesh {grid.n_cells} cells",
        total_pts / dt,
        "accepted_steps/s",
        seconds=dt,
        mean_steps=total_pts / n_traj,
        trace_table_mb=round(ttable_mb, 1),
        serial_steps_per_s=serial_rate,
        speedup_vs_serial=(total_pts / dt) / serial_rate,
    )


def main():
    global DTYPE
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="quick shapes")
    ap.add_argument(
        "--f64", action="store_true",
        help="run every config in float64 (enables jax x64; the large "
        "config shrinks to bound the doubled table memory)",
    )
    args = ap.parse_args()

    if args.f64:
        import jax

        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        DTYPE = jnp.float64

    from interpolate_unstructured_tpu.utils.cache import enable_compile_cache
    from interpolate_unstructured_tpu.utils.device import (
        card_info,
        require_gpu,
    )

    DEVICE.update(device=require_gpu(), card=card_info())
    enable_compile_cache()

    import tempfile

    tmpdir = tempfile.mkdtemp()

    nq = 100_000 if args.small else 1_000_000
    bench_fixture_interpolation("triangle.vtu", nq, tmpdir)
    bench_fixture_interpolation("quad.vtu", nq, tmpdir)
    bench_fixture_interpolation("tetra.vtu", nq, tmpdir, multi=True)
    bench_quad_cell_data(nq, tmpdir)
    if args.small:
        bench_large_tet(12, 100_000)
        bench_trace_tet(8, 64)
    elif args.f64:
        # f64 doubles every table: the suite uses a smaller mesh to
        # keep its runtime bounded (labels carry the true sizes).
        bench_large_tet(35, 4_000_000)
        bench_trace_tet(16, 1024)
    else:
        bench_large_tet(55, 10_000_000)  # ~1M cells, 10M queries
        bench_trace_tet(16, 1024)
        bench_trace_tet(16, 65536)  # throughput regime
        # tracer at the ~1M-cell scale: the trace table is ~256 MB
        bench_trace_tet(55, 1024)
        bench_trace_tet(55, 65536)


if __name__ == "__main__":
    main()
