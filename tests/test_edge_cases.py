"""Edge cases: quad linear fallback, tracer buffer overflow,
axisymmetric clamping."""

import jax.numpy as jnp
import numpy as np
import pytest

import interpolate_unstructured_tpu as iu
from interpolate_unstructured_tpu.ops import interp
from interpolate_unstructured_tpu.trace import BM_NOT_REACHED, integrate_along_field
from interpolate_unstructured_tpu.utils import meshgen


def test_quad_parallelogram_linear_fallback():
    """For a parallelogram, the quadratic coefficient A = (b2 x b3)_z
    vanishes (b3 = 0) and the linear fallback solves mu exactly
    (m_interp_unstructured.f90:618-622)."""
    # Sheared parallelogram
    p = jnp.asarray(
        [[[0.0, 0.0, 0.0], [2.0, 0.5, 0.0], [3.0, 2.5, 0.0], [1.0, 2.0, 0.0]]]
    )
    # Point at parametric (lam, mu) = (0.25, 0.75)
    lam, mu = 0.25, 0.75
    b1 = p[0, 1] - p[0, 0]
    b2 = p[0, 3] - p[0, 0]
    r = (p[0, 0] + lam * b1 + mu * b2)[None, :]
    w = interp.quad_weights(p, r)
    expected = jnp.asarray(
        [[(1 - lam) * (1 - mu), lam * (1 - mu), lam * mu, (1 - lam) * mu]]
    )
    np.testing.assert_allclose(np.asarray(w), np.asarray(expected), atol=1e-13)
    # Weights reconstruct the point
    rec = (np.asarray(w)[0, :, None] * np.asarray(p)[0]).sum(0)
    np.testing.assert_allclose(rec, np.asarray(r)[0], atol=1e-13)


def test_trace_buffer_overflow_reports_not_reached(test_data_dir):
    grid = iu.read_grid(test_data_dir / "triangle.vtu")
    pts = np.asarray(grid.points)
    grid, ivx = iu.add_point_data(grid, "vx", -(pts[:, 1] - 1.0))
    grid, ivy = iu.add_point_data(grid, "vy", pts[:, 0] - 1.0)
    # Circle around the domain center: never reaches the boundary
    y0 = jnp.asarray([[1.3, 1.0]])
    res = integrate_along_field(
        grid, y0, (ivx, ivy), nvar=0,
        min_dx=1e-5, max_dx=0.05, max_steps=8, rtol=1e-3, atol=1e-3,
    )
    assert int(res.n_steps[0]) == 9  # max_steps + 1 (:1167-1168)
    assert int(res.boundary_material[0]) == BM_NOT_REACHED
    # All 8 stored points are valid (on the r=0.3 circle about (1,1))
    d = np.linalg.norm(np.asarray(res.y[0, :8, :2]) - 1.0, axis=1)
    np.testing.assert_allclose(d, 0.3, atol=5e-3)


def test_trace_axisymmetric_clamps_radius(test_data_dir):
    grid = iu.read_grid(test_data_dir / "triangle.vtu")
    pts = np.asarray(grid.points)
    # Field pointing in -x: drives r toward (and past) zero
    grid, ivx = iu.add_point_data(grid, "vx", np.full(grid.n_points, -1.0))
    grid, ivy = iu.add_point_data(grid, "vy", np.zeros(grid.n_points))
    y0 = jnp.asarray([[1.5, 1.0]])
    res = integrate_along_field(
        grid, y0, (ivx, ivy), nvar=0, axisymmetric=True,
        min_dx=1e-5, max_dx=0.2, max_steps=64, rtol=1e-3, atol=1e-3,
    )
    n = min(int(res.n_steps[0]), 64)
    ys = np.asarray(res.y[0, :n])
    assert (ys[:, 0] >= 1e-12 - 1e-18).all()  # first coord clamped


def test_negative_i_var_wraps_on_candidate_grid():
    """A negative i_var wraps python-style to the last variable in the
    generic path; the fused candidate fast path must not slice packed
    rows at negative role offsets (ADVICE r2)."""
    points, cells, neighbors = meshgen.tet_box_mesh(5, 5, 5)
    pd = {"Polynomial": points.sum(1) + 1, "X": points[:, 0]}
    g = iu.build_grid(points, cells, neighbors, "tetra",
                      point_data=pd, locate_mode="walk")
    assert g.cand_table is not None
    rng = np.random.default_rng(7)
    r = jnp.asarray(rng.random((256, 3)))
    v_neg, _, f = iu.interpolate_scalar_at(g, r, -1)
    v_pos, _, _ = iu.interpolate_scalar_at(g, r, 1)
    assert bool(f.all())
    np.testing.assert_allclose(np.asarray(v_neg), np.asarray(v_pos))


def test_degenerate_quad_finite_on_all_paths():
    """A fully collapsed quad must return finite weights from every
    kernel copy (the denom==0 guard must agree everywhere)."""
    p = jnp.zeros((1, 4, 3))
    r = jnp.zeros((1, 3))
    w = interp.quad_weights(p, r)
    assert np.isfinite(np.asarray(w)).all()
    from interpolate_unstructured_tpu.ops.locate import _quad_weights_c

    px = [p[:, v, 0] for v in range(4)]
    py = [p[:, v, 1] for v in range(4)]
    pz = [p[:, v, 2] for v in range(4)]
    wc = _quad_weights_c(px, py, pz, r[:, 0], r[:, 1], r[:, 2])
    assert all(np.isfinite(np.asarray(x)).all() for x in wc)


def test_bin_grid_shape_product_capped():
    """n_bins_target is a hard cap on prod(bin_shape) (ADVICE r2)."""
    from interpolate_unstructured_tpu.ops.geometry import _bin_grid_shape

    rng = np.random.default_rng(11)
    for _ in range(50):
        rmin = rng.uniform(-10, 0, 3)
        rmax = rmin + rng.uniform(1e-3, 100, 3)
        ndim = int(rng.integers(2, 4))
        target = int(rng.integers(1, 10**6))
        shape, _, _, _ = _bin_grid_shape(rmin, rmax, ndim, target)
        assert int(np.prod(shape)) <= target, (shape, target)


def test_walk_mode_multivar_matches_bruteforce():
    points, cells, neighbors = meshgen.tet_box_mesh(5, 5, 5)
    pd = {
        "Polynomial": points.sum(1) + 1,
        "X": points[:, 0],
        "YZ": points[:, 1] * 0.5 + points[:, 2],
    }
    g_w = iu.build_grid(points, cells, neighbors, "tetra",
                        point_data=pd, locate_mode="walk")
    g_b = iu.build_grid(points, cells, neighbors, "tetra",
                        point_data=pd, locate_mode="bruteforce")
    rng = np.random.default_rng(40)
    r = jnp.asarray(rng.random((500, 3)))
    iv = jnp.asarray([0, 1, 2])
    vw, icw, fw = iu.interpolate_at(g_w, r, iv)
    vb, icb, fb = iu.interpolate_at(g_b, r, iv)
    assert bool(fw.all()) and bool(fb.all())
    np.testing.assert_allclose(np.asarray(vw), np.asarray(vb), atol=1e-12)


def test_quad_near_parallelogram_f32_stable():
    """A float32 NEAR-parallelogram (b3 rounds to ~eps instead of 0):
    the naive (-B - sqrt(disc))/2A evaluation cancels catastrophically
    there (~17% weight error measured) while the reference's absolute
    |A| < 1e-20 fallback never fires in float32 — the stable qc/qq
    form must reproduce the root to full precision."""
    p0 = np.array([0.1, 0.2, 0.0])
    p1 = np.array([1.3, 0.25, 0.0])
    p3 = np.array([0.15, 1.7, 0.0])
    p2 = p1 + p3 - p0  # exact parallelogram in f64
    p32 = np.asarray([p0, p1, p2, p3], dtype=np.float32)[None]
    # b3 computed in f32 is now ~1e-7, not 0
    b3 = p32[0, 0] - p32[0, 1] - p32[0, 3] + p32[0, 2]
    assert 0 < np.abs(b3).max() < 1e-6

    lam, mu = 0.3, 0.6
    b1 = p32[0, 1] - p32[0, 0]
    b2 = p32[0, 3] - p32[0, 0]
    r = (p32[0, 0] + lam * b1 + mu * b2)[None].astype(np.float32)
    w = np.asarray(interp.quad_weights(jnp.asarray(p32), jnp.asarray(r)))
    expected = np.asarray(
        [[(1 - lam) * (1 - mu), lam * (1 - mu), lam * mu, (1 - lam) * mu]]
    )
    np.testing.assert_allclose(w, expected, atol=1e-5)
    rec = (w[0, :, None] * np.asarray(p32)[0]).sum(0)
    np.testing.assert_allclose(rec, r[0], atol=1e-5)


def test_quad_near_parallelogram_all_copies_agree():
    """The stable-root evaluation must hold in ALL three quad-kernel
    callers (interp, locate, interp_acc) — a drift in any one
    reintroduces the f32 cancellation bug on that path only."""
    from interpolate_unstructured_tpu.ops import interp_acc, locate

    p0 = np.array([0.1, 0.2, 0.0])
    p1 = np.array([1.3, 0.25, 0.0])
    p3 = np.array([0.15, 1.7, 0.0])
    p2 = p1 + p3 - p0
    p32 = np.asarray([p0, p1, p2, p3], dtype=np.float32)
    lam, mu = 0.3, 0.6
    b1, b2 = p32[1] - p32[0], p32[3] - p32[0]
    r = (p32[0] + lam * b1 + mu * b2).astype(np.float32)
    expected = np.asarray(
        [(1 - lam) * (1 - mu), lam * (1 - mu), lam * mu, (1 - lam) * mu]
    )

    f = jnp.asarray
    got = {}
    got["interp"] = np.asarray(
        interp.quad_weights(f(p32)[None], f(r)[None])
    )[0]
    got["locate"] = np.asarray(
        jnp.stack(
            locate._quad_weights_c(
                [f(p32[k, 0][None]) for k in range(4)],
                [f(p32[k, 1][None]) for k in range(4)],
                [f(p32[k, 2][None]) for k in range(4)],
                f(r[0][None]), f(r[1][None]), f(r[2][None]),
            )
        )
    )[:, 0]
    zero = lambda x: (f(np.float32(x)).reshape(()), jnp.zeros(()))
    q_df = [zero(r[d]) for d in range(3)]
    v_df = [[zero(p32[k, d]) for d in range(3)] for k in range(4)]
    w_df = interp_acc._weights_quad_df(q_df, v_df)
    got["interp_acc"] = np.asarray(
        [float(w[0]) + float(w[1]) for w in w_df]
    )

    for name, w in got.items():
        np.testing.assert_allclose(w, expected, atol=1e-5, err_msg=name)
