"""Linear-exactness oracle tests (SURVEY.md §4).

Barycentric / inverse-bilinear interpolation reproduces linear functions
exactly; each bundled mesh tiles its bounding box, so every uniform
sample lands in a cell and must interpolate ``x+y+z+1`` to <= 1e-14
(threshold: test_triangle.f90:23).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import interpolate_unstructured_tpu as iu
from conftest import sample_points

THRESHOLD = 1e-14
N_SAMPLES = 1000


def solution(r):
    return np.sum(r, axis=-1) + 1.0


def _check_linear_exactness(grid, seed):
    rng = np.random.default_rng(seed)
    ivar = iu.get_point_data_index(grid, "Polynomial")
    assert ivar >= 0
    r = sample_points(rng, grid.rmin, grid.rmax, N_SAMPLES)

    values, i_cell, found = iu.interpolate_scalar_at(grid, jnp.asarray(r), ivar)
    assert bool(found.all()), "mesh tiles its bbox; all samples must be found"
    diff = np.abs(np.asarray(values) - solution(r))
    assert diff.max() <= THRESHOLD, f"max diff {diff.max():.3e}"


def test_triangle_linear_exactness(triangle_grid):
    # VTU stores Polynomial = x+y+z+1 already (test_triangle.f90 path)
    _check_linear_exactness(triangle_grid, seed=0)


def test_quad_linear_exactness(quad_grid):
    _check_linear_exactness(quad_grid, seed=1)


def test_tetra_linear_exactness(tetra_grid):
    # The stored fixture data is float32; overwrite with the exact linear
    # function like test_tetra.f90:37-40 does
    ivar = iu.get_point_data_index(tetra_grid, "Polynomial")
    grid = iu.set_point_data(
        tetra_grid, ivar, solution(np.asarray(tetra_grid.points))
    )
    _check_linear_exactness(grid, seed=2)


def test_triangle_walk_mode_matches_bruteforce(test_data_dir):
    """Force the large-mesh path (bin seed + neighbor walk) on the small
    fixture and require identical results to brute force."""
    grid_w = iu.read_grid(test_data_dir / "triangle.vtu", locate_mode="walk")
    ivar = iu.get_point_data_index(grid_w, "Polynomial")
    rng = np.random.default_rng(3)
    r = jnp.asarray(sample_points(rng, grid_w.rmin, grid_w.rmax, N_SAMPLES))
    values, i_cell, found = iu.interpolate_scalar_at(grid_w, r, ivar)
    assert bool(found.all())
    diff = np.abs(np.asarray(values) - solution(np.asarray(r)))
    assert diff.max() <= THRESHOLD


def test_tetra_walk_mode(test_data_dir):
    grid = iu.read_grid(test_data_dir / "tetra.vtu", locate_mode="walk")
    ivar = iu.get_point_data_index(grid, "Polynomial")
    grid = iu.set_point_data(grid, ivar, solution(np.asarray(grid.points)))
    rng = np.random.default_rng(4)
    r = jnp.asarray(sample_points(rng, grid.rmin, grid.rmax, N_SAMPLES))
    values, i_cell, found = iu.interpolate_scalar_at(grid, r, ivar)
    assert bool(found.all())
    diff = np.abs(np.asarray(values) - solution(np.asarray(r)))
    assert diff.max() <= THRESHOLD


def test_warm_start_guess(quad_grid):
    """Passing the previous located cell as guess must give identical
    results (warm-start chaining, benchmark.f90:57-65 pattern)."""
    grid = quad_grid
    ivar = iu.get_point_data_index(grid, "Polynomial")
    rng = np.random.default_rng(5)
    r = jnp.asarray(sample_points(rng, grid.rmin, grid.rmax, 200))
    v1, ic1, f1 = iu.interpolate_scalar_at(grid, r, ivar)
    # Perturb slightly and re-query warm
    r2 = r + 0.01 * jnp.asarray(rng.random((200, 3)) - 0.5)
    r2 = jnp.clip(r2, grid.rmin + 1e-6, grid.rmax - 1e-6)
    v2_warm, _, f2 = iu.interpolate_scalar_at(grid, r2, ivar, guess=ic1)
    v2_cold, _, _ = iu.interpolate_scalar_at(grid, r2, ivar)
    assert bool(f2.all())
    np.testing.assert_allclose(
        np.asarray(v2_warm), np.asarray(v2_cold), atol=1e-13
    )


def test_outside_queries_not_found(triangle_grid):
    grid = triangle_grid
    r = jnp.asarray(
        np.array(
            [[-1.0, -1.0, 0.0], [100.0, 0.5, 0.0], [0.5, -50.0, 0.0]]
        )
    )
    ivar = iu.get_point_data_index(grid, "Polynomial")
    values, i_cell, found = iu.interpolate_scalar_at(grid, r, ivar)
    assert not bool(found.any())
    assert bool((i_cell < 0).all())
    assert bool(jnp.isnan(values).all())


def test_outside_queries_not_found_walk(test_data_dir):
    grid = iu.read_grid(test_data_dir / "triangle.vtu", locate_mode="walk")
    r = jnp.asarray(np.array([[-1.0, -1.0, 0.0], [100.0, 0.5, 0.0]]))
    i_cell, found = iu.get_cell(grid, r)
    assert not bool(found.any())
    assert bool((i_cell < 0).all())


def test_fill_value_semantics(triangle_grid):
    """The reference leaves outputs untouched on miss (:492); here the
    caller passes previous values as fill."""
    grid = triangle_grid
    ivar = iu.get_point_data_index(grid, "Polynomial")
    r = jnp.asarray(np.array([[0.5, 0.5, 0.0], [-10.0, 0.0, 0.0]]))
    prev = jnp.asarray(np.array([123.0, 456.0]))
    values, _, found = iu.interpolate_scalar_at(
        grid, r, ivar, fill_value=prev
    )
    assert bool(found[0]) and not bool(found[1])
    assert values[1] == 456.0


def test_multi_variable_interpolation(triangle_grid):
    grid, i_vx = iu.add_point_data(
        triangle_grid, "vx", -np.asarray(triangle_grid.points)[:, 1]
    )
    grid, i_vy = iu.add_point_data(
        grid, "vy", np.asarray(grid.points)[:, 0]
    )
    ipoly = iu.get_point_data_index(grid, "Polynomial")
    rng = np.random.default_rng(6)
    r = jnp.asarray(sample_points(rng, grid.rmin, grid.rmax, 100))
    vals, _, found = iu.interpolate_at(
        grid, r, jnp.asarray([ipoly, i_vx, i_vy])
    )
    assert bool(found.all())
    rnp = np.asarray(r)
    np.testing.assert_allclose(np.asarray(vals[:, 0]), solution(rnp), atol=1e-13)
    np.testing.assert_allclose(np.asarray(vals[:, 1]), -rnp[:, 1], atol=1e-13)
    np.testing.assert_allclose(np.asarray(vals[:, 2]), rnp[:, 0], atol=1e-13)


def test_cell_and_icell_scalar_at(quad_grid):
    grid = quad_grid
    n_cells = grid.n_cells
    grid, icd = iu.add_cell_data(grid, "rho", np.arange(n_cells, dtype=float))
    grid, iicd = iu.add_icell_data(grid, "mat", np.arange(n_cells))
    centers = grid.cell_centers()
    vals, ic, found = iu.get_cell_scalar_at(grid, centers, icd)
    assert bool(found.all())
    np.testing.assert_array_equal(np.asarray(ic), np.arange(n_cells))
    np.testing.assert_allclose(np.asarray(vals), np.arange(n_cells))
    ivals, _, _ = iu.get_icell_scalar_at(grid, centers, iicd)
    np.testing.assert_array_equal(np.asarray(ivals), np.arange(n_cells))


def test_point_is_inside_cell(triangle_grid):
    grid = triangle_grid
    centers = grid.cell_centers()
    n = grid.n_cells
    ics = jnp.arange(n, dtype=jnp.int32)
    assert bool(iu.point_is_inside_cell(grid, centers, ics).all())
    # Center of cell 0 is not inside the "opposite" cells in this mesh
    inside0 = iu.point_is_inside_cell(
        grid, jnp.broadcast_to(centers[0], (n, 3)), ics
    )
    assert bool(inside0[0])
    assert not bool(inside0.all())


def test_jit_and_vmap_compatible(triangle_grid):
    import jax

    grid = triangle_grid
    ivar = iu.get_point_data_index(grid, "Polynomial")

    @jax.jit
    def f(g, r):
        return iu.interpolate_scalar_at(g, r, ivar)[0]

    rng = np.random.default_rng(7)
    r = jnp.asarray(sample_points(rng, grid.rmin, grid.rmax, 64))
    np.testing.assert_allclose(
        np.asarray(f(grid, r)), solution(np.asarray(r)), atol=1e-13
    )


def test_interpolation_is_differentiable():
    """JAX-native bonus over the reference: gradients of interpolated
    fields w.r.t. query positions (exact for linear data in cell
    interiors; on cell edges the piecewise-linear interpolant is
    genuinely non-differentiable)."""
    import jax

    from interpolate_unstructured_tpu.utils import meshgen

    points, cells, neighbors = meshgen.triangle_rect_mesh(8, 8)
    g = iu.build_grid(
        points, cells, neighbors, "triangle",
        point_data={"f": 2 * points[:, 0] - 3 * points[:, 1] + 1},
    )

    def f_at(r):
        v, _, _ = iu.interpolate_scalar_at(g, r[None], 0)
        return v[0]

    # interior points (off the 0.125-spaced mesh lines)
    rs = jnp.asarray(
        [[0.37, 0.61, 0.0], [0.71, 0.52, 0.0], [0.06, 0.94, 0.0]]
    )
    grads = jax.vmap(jax.grad(f_at))(rs)
    np.testing.assert_allclose(
        np.asarray(grads), np.tile([2.0, -3.0, 0.0], (3, 1)), atol=1e-12
    )


def test_scalar_fill_value_0d_array(triangle_grid):
    """fill_value as a 0-d numpy/jnp scalar (np.float32(7.0)) must hit
    the scalar branch, not crash on [:, None] (review finding)."""
    r = np.array([[0.5, 0.5, 0.0], [99.0, 99.0, 0.0]])
    for fv in (np.float32(7.0), jnp.float32(7.0), np.float64(7.0)):
        v, ic, found = iu.interpolate_scalar_at(
            triangle_grid, jnp.asarray(r), 0, fill_value=fv
        )
        f = np.asarray(found)
        assert f[0] and not f[1]
        assert float(np.asarray(v)[1]) == 7.0
