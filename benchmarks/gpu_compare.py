"""Kernel-or-XLA decisions, measured on the card.

    python benchmarks/gpu_compare.py [--out chiprun_out/gpu_compare]

1. The candidate probe on the large-mesh cold path (10M uniform cold
   queries on the 998,250-tet grid): the Triton-route Pallas kernel
   (ops/pallas_cand.py) against the XLA probe (ops.locate.
   _probe_rows_xla), end to end in the order XLA, kernel, kernel, XLA,
   plus one profiler trace of each.
2. The brute-force locate (ops.interp._interpolate_bruteforce) against
   the candidate path on the 8-cell reference mesh and a ~1,000-cell
   triangle mesh, 1M queries each.
3. Profiler traces of the plain XLA paths that serve the warm walk,
   the tracer rounds and accurate mode.

Every time ends in ``block_until_ready`` (best of several warm calls).
Device times come from ``jax.profiler`` traces (kept under ``--traces``):
the summed durations of the kernels on the GPU's stream lines, by
kernel name.  Runs only on a GPU.  Prints one line per measurement and
writes them as JSON to ``<out>/gpu_compare.json``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (shared query generator and timer)

best_time = chip_smoke.best_time


def device_op_times(trace_dir, top=8):
    """Reduce a profiler trace to device time: the summed duration of
    every event on the GPU planes' stream lines, total and by name."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    by_name = collections.Counter()
    lines = collections.Counter()
    for path in paths:
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if "stream" not in line.name.lower():
                    continue
                for ev in line.events:
                    by_name[ev.name] += ev.duration_ns
                    lines[line.name] += ev.duration_ns
    return {
        "device_ns": sum(by_name.values()),
        "lines": dict(lines),
        "top_ops_ns": dict(by_name.most_common(top)),
    }


def traced(fn, args, out_dir):
    import jax

    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(out_dir):
        jax.block_until_ready(fn(*args))
    return device_op_times(out_dir)


@contextlib.contextmanager
def xla_probe():
    """Trace the candidate path with the XLA probe instead of the
    kernel (the kernel choice is made at trace time)."""
    from interpolate_unstructured_tpu.ops import pallas_cand

    saved = pallas_cand.supported
    pallas_cand.supported = lambda grid, platform: False
    try:
        yield
    finally:
        pallas_cand.supported = saved


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "gpu_compare"))
    ap.add_argument("--traces", default=os.path.join(REPO, "smoke_out",
                                                     "traces"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    import jax
    import jax.numpy as jnp

    from interpolate_unstructured_tpu import (
        add_point_data,
        build_grid,
        build_trace_table,
        integrate_along_field,
        interpolate_at_acc,
        interpolate_scalar_at,
        prepare_accurate,
    )
    from interpolate_unstructured_tpu.utils import meshgen
    from interpolate_unstructured_tpu.utils.cache import enable_compile_cache
    from interpolate_unstructured_tpu.utils.device import (
        card_info,
        require_gpu,
    )

    dev = require_gpu()
    card = card_info()
    enable_compile_cache()
    results = {"device": dev, "card": card}
    print(f"device: {dev} | card: {card}", flush=True)

    def report(key, value):
        results[key] = value
        print(f"{key}: {json.dumps(value)}", flush=True)

    # ---- 1. candidate probe: kernel vs XLA --------------------------------
    n = chip_smoke.N_SIDE
    points, cells, neighbors = meshgen.tet_box_mesh(n, n, n)
    grid = build_grid(
        points, cells, neighbors, "tetra",
        point_data={"Polynomial": points.sum(axis=1) + 1.0},
        locate_mode="walk", dtype=jnp.float32,
    )
    r = chip_smoke.queries(chip_smoke.N_COLD, seed=1)

    # two function objects: jit caches traces per function, and the
    # kernel choice is made while tracing
    def cold_kernel(g, q):
        return interpolate_scalar_at(g, q, 0)

    def cold_xla(g, q):
        return interpolate_scalar_at(g, q, 0)

    kernel = jax.jit(cold_kernel).lower(grid, r).compile()
    with xla_probe():
        xla = jax.jit(cold_xla).lower(grid, r).compile()
    report("kernel_in_hlo", {
        k: "cand_probe" in f.as_text()
        for k, f in (("kernel", kernel), ("xla", xla))
    })
    vk, ick, fk = jax.block_until_ready(kernel(grid, r))
    vx, icx, fx = jax.block_until_ready(xla(grid, r))
    report("probe_agreement", {
        "found_equal": bool(np.array_equal(np.asarray(fk), np.asarray(fx))),
        "cells_equal_share": float(
            (np.asarray(ick) == np.asarray(icx)).mean()),
        "max_value_diff": float(np.abs(np.asarray(vk) - np.asarray(vx)).max()),
    })
    order = [("xla", xla), ("kernel", kernel), ("kernel", kernel),
             ("xla", xla)]
    times = collections.defaultdict(list)
    for name, fn in order:
        times[name].append(best_time(fn, grid, r, reps=5)[0])
    report("cold_10M_seconds", dict(times))
    report("cold_10M_trace_xla",
           traced(xla, (grid, r), os.path.join(args.traces, "trace_xla")))
    report("cold_10M_trace_kernel",
           traced(kernel, (grid, r), os.path.join(args.traces, "trace_kernel")))

    # ---- 3. XLA paths of the removed kernels ------------------------------
    vel = jax.random.uniform(jax.random.key(2), r.shape, jnp.float32)
    r_adv = r + 0.01 * vel
    warm = jax.jit(lambda g, q, c: interpolate_scalar_at(g, q, 0, guess=c))
    report("warm_10M_seconds", best_time(warm, grid, r_adv, ick)[0])
    report("warm_10M_trace", traced(warm, (grid, r_adv, ick),
                                    os.path.join(args.traces, "trace_warm")))

    cx = points[:, :2] - 0.5
    g2, ivx = add_point_data(grid, "vx", -cx[:, 1], fuse=False)
    g2, ivy = add_point_data(g2, "vy", cx[:, 0], fuse=False)
    g2, ivz = add_point_data(g2, "vz", np.full(len(points), 0.25),
                             fuse=False)
    rng = np.random.default_rng(3)
    y0 = jnp.asarray(0.3 + 0.4 * rng.random((1024, 3)), jnp.float32)
    table = build_trace_table(g2, jnp.asarray((ivx, ivy, ivz)))
    tracer = jax.jit(lambda g, tt, y: integrate_along_field(
        g, y, (ivx, ivy, ivz), min_dx=1e-4, max_dx=0.05, max_steps=256,
        rtol=1e-3, atol=1e-3, trace_table=tt))
    t_tr, res = best_time(tracer, g2, table, y0)
    report("trace_1024x256", {
        "seconds": t_tr,
        "accepted_points": int(np.minimum(np.asarray(res.n_steps), 256).sum()),
        "rk_iterations_max": int(np.asarray(res.n_iterations).max()),
    })
    report("trace_1024x256_trace", traced(
        tracer, (g2, table, y0), os.path.join(args.traces, "trace_tracer")))
    del g2, table

    ga = prepare_accurate(grid)
    acc = jax.jit(lambda g, q: interpolate_at_acc(g, q, (0,)))
    report("accurate_1M_seconds", best_time(acc, ga, r[:1_000_000])[0])
    report("accurate_1M_trace", traced(
        acc, (ga, r[:1_000_000]), os.path.join(args.traces, "trace_acc")))
    del ga, grid

    # ---- 2. brute force vs candidate path ---------------------------------
    for nx in (2, 22):
        p, c, nb = meshgen.triangle_rect_mesh(nx, nx)
        rq = jnp.asarray(
            np.random.default_rng(4).random((1_000_000, 3)) * [2, 2, 0],
            jnp.float32)
        row = {}
        for mode in ("bruteforce", "walk"):
            g = build_grid(p, c, nb, "triangle",
                           point_data={"Polynomial": p.sum(axis=1) + 1.0},
                           locate_mode=mode, dtype=jnp.float32)
            f = jax.jit(lambda gg, q: interpolate_scalar_at(gg, q, 0))
            t, (v, _, fd) = best_time(f, g, rq, reps=5)
            row[mode] = {"seconds": t, "found": bool(np.asarray(fd).all())}
            row[mode + "_trace"] = traced(
                f, (g, rq), os.path.join(args.traces, f"trace_{mode}_{len(c)}"))
        report(f"bruteforce_vs_candidates_{len(c)}_cells_1M", row)

    with open(os.path.join(args.out, "gpu_compare.json"), "w") as f:
        json.dump(results, f, indent=1)
    print("gpu_compare done", flush=True)


if __name__ == "__main__":
    main()
