"""Write the bundled VTU test meshes into tests/data.

The five fixtures the tests read (conftest.test_data_dir), generated
from utils/meshgen.py and written with io/vtk.write_vtu (the VtuWriter
format: appended raw, Float32 points, Float64 point data):

* ``triangle.vtu``  — [0,2]^2 as 2x2 squares, 2 triangles each
  (9 points, 8 cells), the reference benchmark's mesh;
* ``quad.vtu``      — 3x3 points on [0,10]x[0,8], 4 quads, with the
  center point moved off the lattice so no quad is a parallelogram
  (the inverse-bilinear map is then genuinely nonlinear);
* ``tetra.vtu``     — [0,2]^3 as 2x2x2 cubes, 6 tets each (27 points,
  48 cells);
* ``tetra_cell.vtu`` — one tetrahedron;
* ``tetra_two_cell.vtu`` — two tetrahedra sharing a face.

Point data: ``Polynomial = x + y + z + 1`` on every mesh (linear, so
interpolation must reproduce it exactly) and ``DistanceToCenter``
(nonlinear) on triangle.vtu and tetra.vtu.  Every coordinate is exact
in float32, so the Float32 points lose nothing.

Run from the repo root:

    python tests/data/make_fixtures.py
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from interpolate_unstructured_tpu.io.vtk import write_vtu  # noqa: E402
from interpolate_unstructured_tpu.utils import meshgen  # noqa: E402


def _polynomial(points):
    return points.sum(axis=1) + 1.0


def _distance(points, center):
    return np.linalg.norm(points - np.asarray(center, float), axis=1)


def fixtures():
    """name -> (points, cells, cell_type, point_data)."""
    out = {}
    p, c, _ = meshgen.triangle_rect_mesh(2, 2)
    out["triangle.vtu"] = (p, c, "triangle", {
        "DistanceToCenter": _distance(p, (1.0, 1.0, 0.0)),
        "Polynomial": _polynomial(p),
    })

    p, c, _ = meshgen.quad_rect_mesh(2, 2, extent=(10.0, 8.0))
    center = np.argmin(np.linalg.norm(p - [5.0, 4.0, 0.0], axis=1))
    p[center] = [5.5, 3.75, 0.0]
    out["quad.vtu"] = (p, c, "quad", {"Polynomial": _polynomial(p)})

    p, c, _ = meshgen.tet_box_mesh(2, 2, 2, extent=(2.0, 2.0, 2.0))
    out["tetra.vtu"] = (p, c, "tetra", {
        "DistanceToCenter": _distance(p, (1.0, 1.0, 1.0)),
        "Polynomial": _polynomial(p),
    })

    p = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    out["tetra_cell.vtu"] = (
        p, np.array([[0, 1, 2, 3]]), "tetra",
        {"Polynomial": _polynomial(p)},
    )

    p = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], float
    )
    out["tetra_two_cell.vtu"] = (
        p, np.array([[0, 1, 2, 3], [1, 2, 3, 4]]), "tetra",
        {"Polynomial": _polynomial(p)},
    )
    return out


def main():
    for name, (points, cells, cell_type, point_data) in fixtures().items():
        write_vtu(
            os.path.join(HERE, name), points, cells, cell_type,
            point_data=point_data,
        )
        print(f"wrote {name}: {len(points)} points, {len(cells)} cells")


if __name__ == "__main__":
    main()
