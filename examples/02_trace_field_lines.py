"""Field-line tracing: the reference's test_trace_field.f90 scenario.

A spiral field (vx, vy) = (-y + a*x, x + a*y) is attached to a
triangulated square; field lines spiral outward from the origin until
they leave the domain (boundary code -1).  A batch of seeds is traced
with the adaptive RK23 integrator, carrying one extra ODE variable
(arc length, d(length)/ds = 1) through the user callback — the
`integrate_sub_t` interface of the reference
(m_interp_unstructured.f90:61-74).

Run with `python examples/02_trace_field_lines.py`.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

import interpolate_unstructured_tpu as iu
from interpolate_unstructured_tpu.io.convert import get_cell_neighbors


def square_triangulation(lo, hi, n):
    xs = np.linspace(lo, hi, n + 1)
    px, py = np.meshgrid(xs, xs, indexing="ij")
    points = np.column_stack([px.ravel(), py.ravel(), np.zeros(px.size)])
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (i * (n + 1) + j).ravel()
    v10, v01 = v00 + (n + 1), v00 + 1
    v11 = v10 + 1
    cells = np.concatenate(
        [np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)]
    )
    return points, cells


def main():
    points, cells = square_triangulation(-2.0, 2.0, 48)
    neighbors = get_cell_neighbors(cells, points, n_points_face=2)
    grid = iu.build_grid(
        points,
        cells,
        neighbors,
        "triangle",
        point_data={
            "vx": -points[:, 1] + 0.1 * points[:, 0],
            "vy": points[:, 0] + 0.1 * points[:, 1],
        },
    )
    i_field = [
        iu.get_point_data_index(grid, "vx"),
        iu.get_point_data_index(grid, "vy"),
    ]

    # Seeds along the +x axis; third state entry = arc length, start 0.
    radii = np.linspace(0.5, 1.8, 8)
    y0 = jnp.asarray(np.column_stack([radii, 0 * radii, 0 * radii]))

    result = iu.integrate_along_field(
        grid,
        y0,
        i_field,
        nvar=1,
        sub_int=lambda field, y: jnp.ones((1,)),  # d(length)/ds = 1
        min_dx=1e-5,
        max_dx=0.1,
        max_steps=2000,
        rtol=1e-4,
        atol=1e-4,
    )

    # Inner seeds spiral for many turns before exiting; every line ends
    # at the domain boundary (code -1).
    for k, R in enumerate(radii):
        n = int(result.n_steps[k])
        x, y, length = (float(v) for v in result.y[k, n - 1])
        turns = length / (2 * np.pi * R)
        r_end = float(np.hypot(x, y))
        print(
            f"R0={R:5.2f}: {n:4d} accepted steps, arc length {length:7.3f} "
            f"(~{turns:5.2f} turns of the start circle), "
            f"|r_end|={r_end:5.3f}, "
            f"boundary_code={int(result.boundary_material[k])}"
        )

    # Export the grid (with the field) and the traced polylines for
    # side-by-side visualization.
    out = tempfile.mkdtemp(prefix="trace_example")
    iu.write_vtk(grid, os.path.join(out, "grid.vtu"))
    iu.write_trace_vtk(result, os.path.join(out, "lines.vtu"))
    print(f"wrote {out}/grid.vtu + {out}/lines.vtu")


if __name__ == "__main__":
    main()
