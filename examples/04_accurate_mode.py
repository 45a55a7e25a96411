"""Accurate mode: float64-grade interpolation from float32 storage.

The compensated-f32 path stores each value as an exact (hi, lo) float32 pair and runs
error-free-transform arithmetic, recovering ~1e-12 accuracy from pure
f32 storage and compute.  This example builds an f32 grid whose
coordinates and data genuinely need the residuals (scaled by pi,
random O(1) data), then compares plain f32, accurate-mode, and the
exact values.

Run with `python examples/04_accurate_mode.py`.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

import interpolate_unstructured_tpu as iu
from interpolate_unstructured_tpu.io.convert import get_cell_neighbors


def main():
    rng = np.random.default_rng(0)
    n = 24
    xs = np.linspace(0.0, np.pi, n + 1)
    px, py = np.meshgrid(xs, xs, indexing="ij")
    points = np.column_stack([px.ravel(), py.ravel(), np.zeros(px.size)])
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (i * (n + 1) + j).ravel()
    v10, v01 = v00 + (n + 1), v00 + 1
    v11 = v10 + 1
    cells = np.concatenate(
        [np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)]
    )
    neighbors = get_cell_neighbors(cells, points, n_points_face=2)

    # float64 data with O(1) inter-vertex jumps: the f32 representation
    # alone loses ~1e-7
    data = rng.standard_normal(len(points))
    grid = iu.build_grid(
        points, cells, neighbors, "triangle",
        point_data={"rough": data}, dtype=jnp.float32,
    )
    grid = iu.prepare_accurate(grid)

    r64 = rng.uniform(0.1, np.pi - 0.1, size=(10_000, 3)) * [1, 1, 0]
    r32 = jnp.asarray(r64, jnp.float32)

    # Plain f32 path
    v32, ic, found = iu.interpolate_scalar_at(grid, r32, 0)
    assert bool(found.all())

    # Accurate path: query split into (hi, lo) f32 pairs as well
    r_hi = r32
    r_lo = jnp.asarray(r64 - np.asarray(r_hi, np.float64), jnp.float32)
    vh, vl, found_a, ic_a = iu.interpolate_at_acc(grid, r64, (0,))
    v_acc = np.asarray(vh, np.float64) + np.asarray(vl, np.float64)

    # Exact reference: f64 barycentric interpolation on the same cells
    exact = _exact_interp(points, cells, data, r64, np.asarray(ic_a))

    err32 = np.abs(np.asarray(v32, np.float64) - exact).max()
    err_acc = np.abs(v_acc[:, 0] - exact).max()
    print(f"plain float32 max |err| : {err32:.3e}")
    print(f"accurate mode max |err| : {err_acc:.3e}")
    print(f"improvement             : {err32 / err_acc:.0f}x")


def _exact_interp(points, cells, data, r, ic):
    p = points[cells[ic]]  # (B, 3, 3)
    a = p[:, 1] - p[:, 0]
    b = p[:, 2] - p[:, 0]
    q = r - p[:, 0]
    det = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    w1 = (q[:, 0] * b[:, 1] - q[:, 1] * b[:, 0]) / det
    w2 = (a[:, 0] * q[:, 1] - a[:, 1] * q[:, 0]) / det
    w0 = 1.0 - w1 - w2
    d = data[cells[ic]]
    return w0 * d[:, 0] + w1 * d[:, 1] + w2 * d[:, 2]


if __name__ == "__main__":
    main()
