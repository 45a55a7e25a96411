"""Generate the committed golden values in tests/data/goldens.npz.

Reference-grade pinning (VERDICT r2 item 5): interpolated values at 100
fixed query points per bundled mesh and a tet-mesh trace endpoint,
computed ONCE from the float64 CPU path and committed, so future
performance work is held to <=1e-12 drift (BASELINE.json contract; the
Fortran binaries cannot be built in this container — BASELINE.md — so
the f64 CPU path, which is analytically validated by the 1e-14
linear-exactness oracle and the quarter-circle trace golden, stands in
as the generator).

Each mesh's goldens cover every bundled point-data variable —
``DistanceToCenter`` is nonlinear, so the values pin the actual
weight computation, not just linear reproduction — plus a synthetic
nonlinear variable on the quad mesh (whose only bundled variable is
linear).  The trace golden is a helical field on tetra.vtu
(vx, vy, vz) = (-(y-1), x-1, 0.3): rotation about the axis
(1, 1, z) at radius 0.5, climbing to the z=2 boundary; the endpoint and
arc length are stored together with loose analytic cross-checks
(radius ~ 0.5, z_end = 2) applied at generation time.

Run from the repo root (regenerates the committed file):

    python tests/data/make_goldens.py
"""

import os
import shutil
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import interpolate_unstructured_tpu as iu  # noqa: E402
from interpolate_unstructured_tpu.trace import integrate_along_field  # noqa: E402

DATA_DIR = os.path.dirname(os.path.abspath(__file__))
N_POINTS = 100
SEED = 20260817


def load(tmp, name):
    """Read a bundled fixture (tests/data/make_fixtures.py) from a
    scratch copy: reading converts to .binda next to the input."""
    shutil.copy(os.path.join(DATA_DIR, name), os.path.join(tmp, name))
    return iu.read_grid(os.path.join(tmp, name))


def golden_points(grid, tag, out):
    """100 fixed in-mesh samples + all point-data variables (f64)."""
    rng = np.random.default_rng(SEED)
    rmin = np.asarray(grid.rmin)
    rmax = np.asarray(grid.rmax)
    r = rmin + rng.random((N_POINTS, 3)) * (rmax - rmin)
    r_dev = jnp.asarray(r)
    iv = jnp.arange(grid.n_point_data)
    vals, ic, found = iu.interpolate_at(grid, r_dev, iv)
    assert bool(found.all()), f"{tag}: golden points must be inside the mesh"
    assert grid.dtype == jnp.float64
    out[f"{tag}/r"] = r
    out[f"{tag}/values"] = np.asarray(vals)
    out[f"{tag}/var_names"] = np.asarray(grid.point_data_names)


def main():
    tmp = tempfile.mkdtemp(prefix="golden_gen")
    out = {}

    tri = load(tmp, "triangle.vtu")
    golden_points(tri, "triangle", out)

    quad = load(tmp, "quad.vtu")
    # Synthetic nonlinear variable: the bundled quad variable is linear
    # and would not pin the inverse-bilinear weights
    qp = np.asarray(quad.points)
    quad, _ = iu.add_point_data(
        quad, "NonlinearXY", np.sin(qp[:, 0]) * np.cos(qp[:, 1]) + qp[:, 0] * qp[:, 1]
    )
    golden_points(quad, "quad", out)

    tet = load(tmp, "tetra.vtu")
    golden_points(tet, "tetra", out)

    # --- tet-mesh trace golden (helix to the z=2 boundary) ---------------
    pts = np.asarray(tet.points)
    tet, ivx = iu.add_point_data(tet, "vx", -(pts[:, 1] - 1.0))
    tet, ivy = iu.add_point_data(tet, "vy", pts[:, 0] - 1.0)
    tet, ivz = iu.add_point_data(tet, "vz", np.full(tet.n_points, 0.3))
    y0 = jnp.asarray([[1.5, 1.0, 0.2, 0.0]])  # + arc-length variable
    res = integrate_along_field(
        tet, y0, (ivx, ivy, ivz), nvar=1,
        sub_int=lambda field, y: jnp.ones((1,), y.dtype),
        min_dx=1e-5, max_dx=0.1, max_steps=400, rtol=1e-6, atol=1e-6,
    )
    n = int(res.n_steps[0])
    assert n <= 400, "trace must reach the boundary"
    assert int(res.boundary_material[0]) == -1
    y_end = np.asarray(res.y[0, n - 1])
    # analytic cross-checks: radius ~0.5 about (1,1,z), ends at z=2
    rad = np.hypot(y_end[0] - 1.0, y_end[1] - 1.0)
    assert abs(rad - 0.5) < 0.05, rad
    assert abs(y_end[2] - 2.0) < 0.05, y_end
    out["tetra_trace/y0"] = np.asarray(y0)
    out["tetra_trace/y_end"] = y_end
    out["tetra_trace/n_steps"] = np.asarray([n])
    out["tetra_trace/params"] = np.asarray([1e-5, 0.1, 400, 1e-6, 1e-6])

    # --- mask-terminated trace golden (same helix, stopped by an ----------
    # icell material change at z >= 1 instead of the physical boundary;
    # m_interp_unstructured.f90:1055-1068, :1203-1215 semantics)
    centers = np.asarray(tet.points)[np.asarray(tet.cells)].mean(axis=1)
    material = (centers[:, 2] >= 1.0).astype(np.int32) * 7
    tet_m, imat = iu.add_icell_data(tet, "material", material)
    res_m = integrate_along_field(
        tet_m, y0, (ivx, ivy, ivz), nvar=1,
        sub_int=lambda field, y: jnp.ones((1,), y.dtype),
        i_icell_mask=imat, mask_value=0,
        min_dx=1e-5, max_dx=0.1, max_steps=400, rtol=1e-6, atol=1e-6,
    )
    n_m = int(res_m.n_steps[0])
    assert int(res_m.boundary_material[0]) == 7, res_m.boundary_material
    y_end_m = np.asarray(res_m.y[0, n_m - 1])
    # analytic cross-checks: still on the helix, stopped near z = 1
    rad_m = np.hypot(y_end_m[0] - 1.0, y_end_m[1] - 1.0)
    assert abs(rad_m - 0.5) < 0.05, rad_m
    assert 0.8 < y_end_m[2] < 1.2, y_end_m
    out["tetra_trace_mask/y_end"] = y_end_m
    out["tetra_trace_mask/n_steps"] = np.asarray([n_m])
    out["tetra_trace_mask/material"] = material

    dst = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens.npz")
    if os.path.exists(dst):
        # Never regenerate already-committed values: pinned keys stay
        # byte-identical, new keys are appended (drift in old keys is a
        # test failure, not a regeneration event).
        old = np.load(dst, allow_pickle=False)
        for k in old.files:
            if k in out:
                same = (
                    np.allclose(old[k], out[k], rtol=0, atol=1e-13)
                    if old[k].dtype.kind == "f"
                    else np.array_equal(old[k], out[k])
                )
                if not same:
                    print(f"NOTE: regenerated {k} differs from committed "
                          "value; keeping the committed one")
            out[k] = old[k]
    np.savez_compressed(dst, **out)
    print(f"wrote {dst}: {sorted(out)}")


if __name__ == "__main__":
    main()
