"""Run the main path once on the GPU at real size and check every result.

    python chip_smoke.py               # one GPU: phases 1-7
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

The quickest proof that the system starts on the card.  It drives the
public entry points (build_grid -> save_grid/load_grid ->
interpolate_scalar_at cold and warm, integrate_along_field,
interpolate_at_acc, parallel.sharding) on the 998,250-tet mesh with
10M-query batches, the size of the repository's large-mesh protocol,
and compares each result with the repository's plain references: the
serial C++ oracle (native/serial_oracle.cc) in float64, linear
exactness, and the committed float64 goldens.

Phases (one line each; any failed check stops the script non-zero):

1. large-mesh cold path: build, checkpoint round trip, 10M cold
   queries, oracle check on 10k of them;
2. warm walk on advected points (reference protocol);
3. small-mesh brute force (the 8-cell reference mesh, 1M queries);
4. tracer: 1,024 lines x 256 steps against the oracle and the helix
   invariant;
5. accurate (df32) mode on 1M queries against float64 truth;
6. a float64 grid (native f64 on the card) and the committed goldens;
7. the ``gpu``-marked tests (pytest child, run before this process
   touches the card).

With ``--four-cards`` only the sharded path runs: cold and warm
``sharded_interpolate_at``, ``sharded_get_cell_scalar_at`` and
``sharded_trace`` on a 4-device mesh, each against the same call on one
device.

One process holds the card at a time: the pytest child runs to its end
before this process first touches the GPU.  Data comes from fixed
seeds; nothing is downloaded.  Without a GPU the script stops non-zero
and prints no result line.  The last line is the JSON result
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "smoke_out")  # listed in .gitignore
N_SIDE = 55  # tet_box_mesh(55, 55, 55): 998,250 tets
N_COLD = 10_000_000
N_ORACLE = 10_000
F32_TOL = 5e-5  # ~10 ulp of O(1) f32 arithmetic + int16 row fuzz
ACC_TOL = 1e-10
F64_TOL = 1e-12
# Tracer vs the f64 oracle.  Both run the same RK23 controller with
# rtol = atol = 1e-3; on this smooth (globally linear) field every step
# sits far below the error threshold, so both take the same steps and
# differ by f32 rounding.  A point may differ by at most one step's
# error budget, atol + rtol * max|y| (coordinates <= 1 here): 2e-3.
# Step counts may differ by a few shrink-retry steps at the wall, where
# the f32 walk's arrival band flips arrived/exited (as in
# tests/test_serial_oracle.py); the final exit points then still agree
# to that budget.
TRACE_RTOL = TRACE_ATOL = 1e-3
TRACE_TOL = TRACE_ATOL + TRACE_RTOL * 1.0
TRACE_STEP_SLACK = 8


class SmokeFailure(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(line):
    print(line, flush=True)


def best_time(fn, *args, reps=3):
    """Best wall time of ``fn(*args)`` over warm calls ending in
    ``block_until_ready``; returns (seconds, result)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def run_gpu_tests():
    """Phase 7, run first: the ``gpu``-marked tests in a child process
    (this process has not touched the card yet).  Returns its summary."""
    xml = os.path.join(OUT, "pytest_gpu.xml")
    log = os.path.join(REPO, "chiprun_out", "pytest_gpu.log")
    os.makedirs(os.path.dirname(log), exist_ok=True)
    with open(log, "w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "tests", "-q", "-m", "gpu",
             "-p", "no:cacheprovider", f"--junitxml={xml}"],
            cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
            env=dict(os.environ, IU_TEST_DEVICE="gpu"),
        ).returncode
    suite = ET.parse(xml).getroot()
    if suite.tag != "testsuite":
        suite = suite.find("testsuite")
    n = {k: int(suite.get(k, 0))
         for k in ("tests", "failures", "errors", "skipped")}
    return rc, n, log


def card_line():
    from interpolate_unstructured_tpu.utils.device import card_info

    return card_info()


def build_large(tmp):
    """Phase-1 grid: built, saved, reloaded."""
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import build_grid, load_grid, save_grid
    from interpolate_unstructured_tpu.utils import meshgen

    t0 = time.perf_counter()
    points, cells, neighbors = meshgen.tet_box_mesh(N_SIDE, N_SIDE, N_SIDE)
    grid = build_grid(
        points, cells, neighbors, "tetra",
        point_data={"Polynomial": points.sum(axis=1) + 1.0},
        locate_mode="walk", dtype=jnp.float32,
    )
    t_build = time.perf_counter() - t0
    path = os.path.join(tmp, f"tet{N_SIDE}_f32.binda")
    save_grid(grid, path)
    del grid
    t0 = time.perf_counter()
    grid = load_grid(path)
    t_load = time.perf_counter() - t0
    return grid, (points, cells, neighbors), t_build, t_load


def queries(n, seed, lo=0.1, hi=0.9):
    """Uniform queries in the unit box shrunk by 10% per side (the
    reference protocol's sampling box), generated on the device."""
    import jax
    import jax.numpy as jnp

    u = jax.random.uniform(jax.random.key(seed), (n, 3), jnp.float32)
    return lo + (hi - lo) * u


def boundary_margins(grid, r, cells):
    """f64 inside-margins of queries ``r`` (n, 3) in ``cells`` (n,)."""
    n = np.asarray(grid.face_normals, np.float64)[cells]
    off = np.asarray(grid.face_offsets, np.float64)[cells]
    return (off - np.einsum("bkd,bd->bk", n, r)).min(axis=1)


def phase_large_cold(grid, mesh_np, t_build, t_load):
    import jax

    from interpolate_unstructured_tpu import interpolate_scalar_at
    from interpolate_unstructured_tpu.utils import serial_oracle

    r = queries(N_COLD, seed=1)
    cold = jax.jit(lambda g, q: interpolate_scalar_at(g, q, 0))
    t0 = time.perf_counter()
    compiled = cold.lower(grid, r).compile()
    t_compile = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    say(
        "phase 1 memory_analysis (10M-query step): "
        + ("unavailable" if mem is None else
           f"arguments={mem.argument_size_in_bytes} "
           f"outputs={mem.output_size_in_bytes} "
           f"temps={mem.temp_size_in_bytes} "
           f"generated_code={mem.generated_code_size_in_bytes}")
    )
    t_cold, (vals, ic, found) = best_time(compiled, grid, r)
    r_np = np.asarray(r, np.float64)
    vals = np.asarray(vals, np.float64)
    ic = np.asarray(ic)
    found = np.asarray(found)
    check(found.all(), f"phase 1: {int((~found).sum())} queries not found")
    err = float(np.abs(vals - (r_np.sum(axis=1) + 1.0)).max())
    check(err < F32_TOL, f"phase 1: linear exactness {err:.3e}")

    # serial C++ oracle in f64 on a subset (a failed build raises)
    points, cells, neighbors = mesh_np
    sub = slice(0, N_ORACLE)
    t0 = time.perf_counter()
    v_o, ic_o, f_o = serial_oracle.serial_query(
        points, cells, neighbors, points.sum(axis=1) + 1.0, r_np[sub],
        cell_type="tetra",
    )
    t_oracle = time.perf_counter() - t0
    check((f_o == found[sub]).all(), "phase 1: found differs from oracle")
    differ = np.nonzero(ic[sub] != ic_o)[0]
    tol = grid.config.eps_inside + grid.cand_qeps
    if differ.size:
        rq = r_np[sub][differ]
        m_j = boundary_margins(grid, rq, ic[sub][differ])
        m_o = boundary_margins(grid, rq, ic_o[differ])
        on_face = (np.abs(m_j) <= tol) & (np.abs(m_o) <= tol)
        check(on_face.all(),
              f"phase 1: {int((~on_face).sum())} cells differ from the "
              "oracle away from shared faces")
    v_err = float(np.abs(vals[sub] - v_o).max())
    check(v_err < F32_TOL, f"phase 1: values vs oracle {v_err:.3e}")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    say(
        f"phase 1 large-mesh cold: ok  cells={grid.n_cells} "
        f"queries={N_COLD} found=all max_err={err:.3e} (< {F32_TOL}) "
        f"oracle[{N_ORACLE}]: found agree, cells differ on shared faces "
        f"only ({differ.size}, |margin| <= {tol:.2e}), "
        f"max_value_diff={v_err:.3e} (< {F32_TOL}) | build={t_build:.1f}s "
        f"load={t_load:.1f}s compile={t_compile:.1f}s "
        f"cold_call={t_cold:.4f}s ({N_COLD / t_cold:.4e} q/s) "
        f"oracle={t_oracle:.1f}s peak_bytes_in_use={peak}"
    )
    return r, ic


def phase_warm(grid, r, ic_cold):
    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import get_cell, interpolate_scalar_at

    # bench.py's reference protocol: advect by 0.01 * domain * velocity
    vel = jax.random.uniform(jax.random.key(2), r.shape, jnp.float32)
    r_adv = r + 0.01 * 1.0 * vel
    warm = jax.jit(lambda g, q, c: interpolate_scalar_at(g, q, 0, guess=c))
    t_warm, (vals, ic_w, found) = best_time(
        warm, grid, r_adv, jnp.asarray(ic_cold)
    )
    ic_c, found_c = jax.jit(get_cell)(grid, r_adv)
    found = np.asarray(found)
    check(found.all(), f"phase 2: {int((~found).sum())} warm queries lost")
    same = np.asarray(ic_w) == np.asarray(ic_c)
    check(same.all(),
          f"phase 2: {int((~same).sum())} warm cells differ from cold")
    err = float(np.abs(
        np.asarray(vals, np.float64)
        - (np.asarray(r_adv, np.float64).sum(axis=1) + 1.0)
    ).max())
    check(err < F32_TOL, f"phase 2: linear exactness {err:.3e}")
    moved = float((np.asarray(ic_w) != np.asarray(ic_cold)).mean())
    say(
        f"phase 2 warm walk: ok  queries={r.shape[0]} found=all "
        f"cells == cold locate of advected points, max_err={err:.3e} "
        f"(< {F32_TOL}), cells changed={moved:.3f} | "
        f"warm_call={t_warm:.4f}s ({r.shape[0] / t_warm:.4e} q/s)"
    )


def phase_small_bruteforce():
    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import build_grid, interpolate_scalar_at
    from interpolate_unstructured_tpu.utils import meshgen

    points, cells, neighbors = meshgen.triangle_rect_mesh(2, 2)
    grid = build_grid(
        points, cells, neighbors, "triangle",
        point_data={"Polynomial": points.sum(axis=1) + 1.0},
        dtype=jnp.float32,
    )
    check(grid.locate_mode == "bruteforce", "phase 3: not brute force")
    rng = np.random.default_rng(2024)
    lo, hi = np.array([0.2, 0.2, 0.0]), np.array([1.8, 1.8, 0.0])
    r = jnp.asarray(lo + rng.random((1_000_000, 3)) * (hi - lo),
                    jnp.float32)
    f = jax.jit(lambda g, q: interpolate_scalar_at(g, q, 0))
    t, (vals, _, found) = best_time(f, grid, r)
    check(bool(np.asarray(found).all()), "phase 3: queries not found")
    err = float(np.abs(
        np.asarray(vals, np.float64)
        - (np.asarray(r, np.float64).sum(axis=1) + 1.0)
    ).max())
    check(err < F32_TOL, f"phase 3: linear exactness {err:.3e}")
    say(
        f"phase 3 small-mesh brute force: ok  cells={grid.n_cells} "
        f"queries=1000000 found=all max_err={err:.3e} (< {F32_TOL}) | "
        f"call={t:.5f}s ({1e6 / t:.4e} q/s)"
    )


def phase_tracer(grid, mesh_np):
    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import (
        add_point_data,
        build_trace_table,
        integrate_along_field,
    )
    from interpolate_unstructured_tpu.utils import serial_oracle

    points, cells, neighbors = mesh_np
    cx = points[:, :2] - 0.5
    fld = np.stack([-cx[:, 1], cx[:, 0], np.full(len(points), 0.25)], 1)
    g, ivx = add_point_data(grid, "vx", fld[:, 0], fuse=False)
    g, ivy = add_point_data(g, "vy", fld[:, 1], fuse=False)
    g, ivz = add_point_data(g, "vz", fld[:, 2], fuse=False)
    n_traj, max_steps = 1024, 256
    rng = np.random.default_rng(3)
    y0 = (0.3 + 0.4 * rng.random((n_traj, 3))).astype(np.float32)
    table = build_trace_table(g, jnp.asarray((ivx, ivy, ivz)))
    kw = dict(min_dx=1e-4, max_dx=0.05, max_steps=max_steps,
              rtol=TRACE_RTOL, atol=TRACE_ATOL)
    run = jax.jit(lambda gg, tt, y: integrate_along_field(
        gg, y, (ivx, ivy, ivz), trace_table=tt, **kw))
    t, res = best_time(run, g, table, jnp.asarray(y0))
    y = np.asarray(res.y, np.float64)
    n = np.asarray(res.n_steps)
    bm = np.asarray(res.boundary_material)
    n_pts = int(np.minimum(n, max_steps).sum())

    n_cmp = 64
    oy, _, ons, obm = serial_oracle.serial_trace(
        points, cells, neighbors, fld, y0[:n_cmp].astype(np.float64), **kw
    )
    check((bm[:n_cmp] == obm).all(), "phase 4: boundary codes differ")
    dn = np.abs(n[:n_cmp].astype(int) - ons.astype(int))
    check(dn.max() <= TRACE_STEP_SLACK, f"phase 4: step counts differ {dn.max()}")
    worst = 0.0
    for t_i in range(n_cmp):
        nj = min(int(n[t_i]), max_steps)
        no = min(int(ons[t_i]), max_steps)
        common = max(min(nj, no) - 2, 0)
        d = np.abs(y[t_i, :common] - oy[t_i, :common]).max(initial=0.0)
        d_end = np.abs(y[t_i, nj - 1] - oy[t_i, no - 1]).max()
        worst = max(worst, d, d_end)
    check(worst <= TRACE_TOL, f"phase 4: trajectories differ {worst:.3e}")

    # helix invariant: the field is linear, so interpolation is exact
    # and any radius drift is the integrator's, within one step budget
    # (atol + rtol per component, sqrt(2) for the 2-D radius) per step
    drift = 0.0
    budget_ok = True
    for t_i in range(n_traj):
        nb = min(int(n[t_i]), max_steps)
        rad = np.hypot(y[t_i, :nb, 0] - 0.5, y[t_i, :nb, 1] - 0.5)
        d = float(np.abs(rad - rad[0]).max())
        drift = max(drift, d)
        budget_ok &= d <= nb * np.sqrt(2.0) * TRACE_TOL
    check(budget_ok, "phase 4: helix radius drift beyond the budget")
    say(
        f"phase 4 tracer: ok  lines={n_traj} max_steps={max_steps} "
        f"accepted_points={n_pts} oracle[{n_cmp}]: boundary codes equal, "
        f"|dn_steps|<={int(dn.max())} (<= {TRACE_STEP_SLACK}), "
        f"max_point_diff={worst:.3e} (<= {TRACE_TOL:.0e}); "
        f"max_radius_drift={drift:.3e} | call={t:.3f}s "
        f"({n_pts / t:.4e} accepted steps/s)"
    )


def phase_accurate(grid, r):
    import jax

    from interpolate_unstructured_tpu import (
        interpolate_at_acc,
        prepare_accurate,
    )

    check(grid.points_lo is not None, "phase 5: grid lacks f64 residuals")
    t0 = time.perf_counter()
    g = prepare_accurate(grid)
    check(g.cand_df_table is not None, "phase 5: no df-plane table")
    jax.block_until_ready(g.cand_df_table)
    t_prep = time.perf_counter() - t0
    r1 = r[:1_000_000]
    f = jax.jit(lambda gg, q: interpolate_at_acc(gg, q, (0,)))
    t, (vh, vl, found, _) = best_time(f, g, r1)
    check(bool(np.asarray(found).all()), "phase 5: queries not found")
    got = np.asarray(vh, np.float64) + np.asarray(vl, np.float64)
    truth = np.asarray(r1, np.float64).sum(axis=1) + 1.0
    err = float(np.abs(got[:, 0] - truth).max())
    check(err <= ACC_TOL, f"phase 5: accurate mode error {err:.3e}")
    say(
        f"phase 5 accurate mode: ok  queries=1000000 found=all "
        f"max_err={err:.3e} (<= {ACC_TOL}) | prepare={t_prep:.1f}s "
        f"call={t:.4f}s ({1e6 / t:.4e} q/s)"
    )


def phase_f64():
    import shutil

    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import (
        add_point_data,
        build_grid,
        interpolate_at,
        interpolate_scalar_at,
        read_grid,
    )
    from interpolate_unstructured_tpu.utils import meshgen

    # x64 only inside this scope: the f32 phases ran with it off
    with jax.enable_x64(True):
        points, cells, neighbors = meshgen.tet_box_mesh(30, 30, 30)
        grid = build_grid(
            points, cells, neighbors, "tetra",
            point_data={"Polynomial": points.sum(axis=1) + 1.0},
            locate_mode="walk", dtype=jnp.float64,
        )
        rng = np.random.default_rng(6)
        r = jnp.asarray(rng.random((1_000_000, 3)), jnp.float64)
        f = jax.jit(lambda g, q: interpolate_scalar_at(g, q, 0))
        t, (vals, _, found) = best_time(f, grid, r)
        check(bool(np.asarray(found).all()), "phase 6: queries not found")
        check(vals.dtype == jnp.float64, "phase 6: not float64")
        err = float(np.abs(
            np.asarray(vals) - (np.asarray(r).sum(axis=1) + 1.0)
        ).max())
        check(err < F64_TOL, f"phase 6: linear exactness {err:.3e}")

        goldens = np.load(os.path.join(REPO, "tests", "data", "goldens.npz"))
        fix = os.path.join(OUT, "fixtures")
        os.makedirs(fix, exist_ok=True)
        worst = 0.0
        for tag in ("triangle", "quad", "tetra"):
            shutil.copy(os.path.join(REPO, "tests", "data", f"{tag}.vtu"),
                        fix)
            g = read_grid(os.path.join(fix, f"{tag}.vtu"),
                          dtype=jnp.float64)
            if tag == "quad":
                qp = np.asarray(g.points)
                g, _ = add_point_data(
                    g, "NonlinearXY",
                    np.sin(qp[:, 0]) * np.cos(qp[:, 1]) + qp[:, 0] * qp[:, 1],
                )
            names = tuple(str(s) for s in goldens[f"{tag}/var_names"])
            check(g.point_data_names == names, f"phase 6: {tag} variables")
            v, _, fd = interpolate_at(
                g, jnp.asarray(goldens[f"{tag}/r"]),
                jnp.arange(g.n_point_data),
            )
            check(bool(np.asarray(fd).all()), f"phase 6: {tag} not found")
            want = goldens[f"{tag}/values"]
            rel = np.abs(np.asarray(v) - want) / np.maximum(np.abs(want), 1.0)
            worst = max(worst, float(rel.max()))
        check(worst < F64_TOL, f"phase 6: goldens drifted {worst:.3e}")
    say(
        f"phase 6 float64 grid: ok  cells={grid.n_cells} queries=1000000 "
        f"found=all max_err={err:.3e} (< {F64_TOL}); goldens "
        f"(triangle, quad, tetra) max_rel_diff={worst:.3e} (< {F64_TOL}) | "
        f"call={t:.4f}s ({1e6 / t:.4e} q/s)"
    )


def four_cards(dev):
    """Sharded queries and tracing on a 4-device mesh vs one device."""
    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import (
        add_cell_data,
        add_point_data,
        build_trace_table,
        get_cell_scalar_at,
        integrate_along_field,
        interpolate_at,
    )
    from interpolate_unstructured_tpu.parallel import sharding

    check(dev["count"] >= 4, f"--four-cards: only {dev['count']} devices")
    devices = jax.devices()[:4]
    grid, mesh_np, _, _ = build_large(OUT)
    points = mesh_np[0]
    grid, i_rho = add_cell_data(
        grid, "rho", np.arange(grid.n_cells, dtype=np.float64)
    )
    cx = points[:, :2] - 0.5
    grid, ivx = add_point_data(grid, "vx", -cx[:, 1], fuse=False)
    grid, ivy = add_point_data(grid, "vy", cx[:, 0], fuse=False)
    grid, ivz = add_point_data(grid, "vz", np.full(len(points), 0.25),
                               fuse=False)
    one = jax.device_put(grid, devices[0])
    mesh = sharding.make_mesh(devices)
    rep = sharding.replicate_grid(grid, mesh)
    del grid

    def on_four(x):
        check(len(x.sharding.device_set) == 4,
              f"--four-cards: output on {len(x.sharding.device_set)} devices")

    def same_cells(a, b, what):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"--four-cards: {what} differ from one device")

    def close(a, b, what):
        d = float(np.abs(np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)).max())
        check(d <= 1e-6, f"--four-cards: {what} differ by {d:.3e}")
        return d

    r = jax.device_put(queries(N_COLD, seed=1), devices[0])
    vel = jax.random.uniform(jax.random.key(2), r.shape, jnp.float32)
    r_adv = r + 0.01 * vel
    r_sh, b = sharding.shard_batch(r, mesh)
    r_adv_sh, _ = sharding.shard_batch(r_adv, mesh)
    check(b == N_COLD, "--four-cards: padded batch")

    fi = sharding.sharded_interpolate_at(mesh)
    t_cold4, (v4, ic4, f4) = best_time(fi, rep, r_sh, [0])
    t_cold1, (v1, ic1, f1) = best_time(
        jax.jit(lambda g, q: interpolate_at(g, q, [0])), one, r)
    for x in (v4, ic4, f4):
        on_four(x)
    same_cells(ic4, ic1, "cold cells")
    same_cells(f4, f1, "cold found")
    d_cold = close(v4, v1, "cold values")

    t_warm4, (w4, jc4, g4) = best_time(fi, rep, r_adv_sh, [0], ic4)
    t_warm1, (w1, jc1, g1) = best_time(
        jax.jit(lambda g, q, c: interpolate_at(g, q, [0], guess=c)),
        one, r_adv, ic1)
    for x in (w4, jc4, g4):
        on_four(x)
    same_cells(jc4, jc1, "warm cells")
    same_cells(g4, g1, "warm found")
    d_warm = close(w4, w1, "warm values")

    fc = sharding.sharded_get_cell_scalar_at(mesh)
    t_cd4, (c4, kc4, h4) = best_time(fc, rep, r_sh, i_rho)
    t_cd1, (c1, kc1, h1) = best_time(
        jax.jit(lambda g, q: get_cell_scalar_at(g, q, i_rho)), one, r)
    for x in (c4, kc4, h4):
        on_four(x)
    same_cells(kc4, kc1, "cell-data cells")
    same_cells(h4, h1, "cell-data found")
    d_cd = close(c4, c1, "cell data")

    n_traj = 1024
    rng = np.random.default_rng(3)
    y0 = jnp.asarray(0.3 + 0.4 * rng.random((n_traj, 3)), jnp.float32)
    kw = dict(nvar=0, min_dx=1e-4, max_dx=0.05, max_steps=256,
              rtol=TRACE_RTOL, atol=TRACE_ATOL)
    i_field = jnp.asarray((ivx, ivy, ivz))
    tt_rep = jax.device_put(build_trace_table(one, i_field),
                            jax.sharding.NamedSharding(
                                mesh, jax.sharding.PartitionSpec()))
    tt_one = build_trace_table(one, i_field)
    y0_sh, _ = sharding.shard_batch(y0, mesh)
    ft = sharding.sharded_trace(mesh, **kw)
    t_tr4, res4 = best_time(ft, rep, y0_sh, i_field, tt_rep)
    t_tr1, res1 = best_time(
        jax.jit(lambda g, y, tt: integrate_along_field(
            g, y, (ivx, ivy, ivz), trace_table=tt, **kw)),
        one, jax.device_put(y0, devices[0]), tt_one)
    on_four(res4.y)
    same_cells(res4.n_steps, res1.n_steps, "trace step counts")
    same_cells(res4.boundary_material, res1.boundary_material,
               "trace boundary codes")
    d_tr = close(res4.y, res1.y, "trajectories")
    say(
        "four-cards sharded: ok  mesh=4 devices (1-D 'data' axis), grid "
        f"replicated ({rep.n_cells} cells), outputs span 4 devices; vs one "
        "device: cells and found equal, max value diff cold="
        f"{d_cold:.2e} warm={d_warm:.2e} cell_data={d_cd:.2e} "
        f"trace={d_tr:.2e} (<= 1e-6) | seconds 4-dev/1-dev: "
        f"cold {t_cold4:.4f}/{t_cold1:.4f} warm {t_warm4:.4f}/{t_warm1:.4f} "
        f"cell_data {t_cd4:.4f}/{t_cd1:.4f} trace {t_tr4:.3f}/{t_tr1:.3f}"
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    import interpolate_unstructured_tpu  # noqa: F401  (fails outside the repo)

    os.makedirs(OUT, exist_ok=True)
    card = card_line()  # nvidia-smi, no JAX: fails without a card
    gpu_tests = None if args.four_cards else run_gpu_tests()

    from interpolate_unstructured_tpu.utils.cache import enable_compile_cache
    from interpolate_unstructured_tpu.utils.device import require_gpu

    dev = require_gpu()  # first touch of the card in this process
    enable_compile_cache()
    say(f"device: platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']} | card: {card}")

    if args.four_cards:
        four_cards(dev)
        dev["count"] = 4
    else:
        grid, mesh_np, t_build, t_load = build_large(OUT)
        r, ic = phase_large_cold(grid, mesh_np, t_build, t_load)
        phase_warm(grid, r, ic)
        phase_small_bruteforce()
        phase_tracer(grid, mesh_np)
        phase_accurate(grid, r)
        del grid, r, ic
        phase_f64()
        rc, n, log = gpu_tests
        check(rc == 0 and n["failures"] == n["errors"] == 0,
              f"phase 7: gpu tests failed (rc={rc}, {n}); see {log}")
        check(n["tests"] >= 1 and n["skipped"] == 0,
              f"phase 7: gpu tests did not run on the card ({n}); see {log}")
        say(f"phase 7 gpu-marked tests: ok  {n['tests']} passed, "
            f"0 skipped (pytest -m gpu, log {os.path.relpath(log, REPO)})")

    say(f"card: {card}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
