"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import interpolate_unstructured_tpu as iu
from interpolate_unstructured_tpu.parallel import sharding
from conftest import sample_points


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return sharding.make_mesh()


def test_sharded_interpolate_matches_local(triangle_grid, mesh):
    grid = sharding.replicate_grid(triangle_grid, mesh)
    ivar = iu.get_point_data_index(grid, "Polynomial")
    rng = np.random.default_rng(10)
    r = jnp.asarray(sample_points(rng, grid.rmin, grid.rmax, 256))
    r_sh, b = sharding.shard_batch(r, mesh)
    guess = jnp.full(r_sh.shape[0], -1, dtype=jnp.int32)

    f = sharding.sharded_interpolate_at(mesh)
    vals, ic, found = f(grid, r_sh, jnp.asarray([ivar]), guess)
    vals_local, ic_local, found_local = iu.interpolate_at(
        triangle_grid, r, jnp.asarray([ivar])
    )
    np.testing.assert_allclose(
        np.asarray(vals)[:b], np.asarray(vals_local), atol=1e-14
    )
    np.testing.assert_array_equal(np.asarray(found)[:b], np.asarray(found_local))


def test_sharded_interpolate_walk_mode(test_data_dir, mesh):
    grid = iu.read_grid(test_data_dir / "tetra.vtu", locate_mode="walk")
    ivar = iu.get_point_data_index(grid, "Polynomial")
    grid = iu.set_point_data(
        grid, ivar, np.asarray(grid.points).sum(axis=1) + 1
    )
    grid_r = sharding.replicate_grid(grid, mesh)
    rng = np.random.default_rng(11)
    r = jnp.asarray(sample_points(rng, grid.rmin, grid.rmax, 128))
    r_sh, b = sharding.shard_batch(r, mesh)
    f = sharding.sharded_interpolate_at(mesh)
    vals, ic, found = f(grid_r, r_sh, jnp.asarray([ivar]))
    assert bool(np.asarray(found)[:b].all())
    exact = np.asarray(r).sum(axis=1) + 1
    np.testing.assert_allclose(np.asarray(vals)[:b, 0], exact, atol=1e-13)


def test_sharded_trace(triangle_grid, mesh):
    pts = np.asarray(triangle_grid.points)
    grid, i_vx = iu.add_point_data(triangle_grid, "vx", -pts[:, 1])
    grid, i_vy = iu.add_point_data(grid, "vy", pts[:, 0])
    grid = sharding.replicate_grid(grid, mesh)

    y0 = jnp.asarray(
        np.stack(
            [np.full(8, 1.5), np.linspace(0.05, 0.4, 8)], axis=1
        )
    )
    y0_sh, b = sharding.shard_batch(y0, mesh)
    f = sharding.sharded_trace(
        mesh, nvar=0, min_dx=1e-5, max_dx=0.1, max_steps=64,
        rtol=1e-3, atol=1e-3,
    )
    res = f(grid, y0_sh, jnp.asarray([i_vx, i_vy]))
    assert res.y.shape == (8, 64, 2)
    n = np.asarray(res.n_steps)
    assert (n >= 1).all()
    # Circular traces preserve radius
    for i in range(b):
        m = min(int(n[i]), 64)
        r = np.linalg.norm(np.asarray(res.y[i, :m, :2]), axis=1)
        np.testing.assert_allclose(
            r, np.linalg.norm(np.asarray(y0[i])), atol=6e-3
        )

    # Prebuilt-table reuse (round 5): identical results, table built
    # once outside the shard_map instead of per call per shard
    tt = iu.build_trace_table(grid, jnp.asarray([i_vx, i_vy]))
    res2 = f(grid, y0_sh, jnp.asarray([i_vx, i_vy]), trace_table=tt)
    np.testing.assert_array_equal(
        np.asarray(res.n_steps), np.asarray(res2.n_steps)
    )
    np.testing.assert_array_equal(np.asarray(res.y), np.asarray(res2.y))


def test_distribute_and_collect_roundtrip(triangle_grid, mesh):
    """Multi-host input pipeline, single-process-multi-device case:
    per-process query blocks assemble into one sharded global array
    and results collect back trimmed to the contribution size."""
    grid = sharding.replicate_grid(triangle_grid, mesh)
    ivar = iu.get_point_data_index(grid, "Polynomial")
    rng = np.random.default_rng(12)
    # 203 is deliberately NOT a multiple of 8: exercises padding
    r = sample_points(rng, grid.rmin, grid.rmax, 203)

    r_sh, local_b = sharding.distribute_queries(r, mesh)
    assert local_b == 203
    assert r_sh.shape[0] % 8 == 0
    f = sharding.sharded_interpolate_at(mesh)
    vals, ic, found = f(grid, r_sh, jnp.asarray([ivar]))

    out = sharding.collect_results(vals, local_b)
    assert out.shape[0] == 203
    exact = np.asarray(r).sum(axis=1) + 1
    np.testing.assert_allclose(out[:, 0], exact, atol=1e-13)
    got_found = sharding.collect_results(found, local_b)
    assert bool(got_found.all())


def test_sharded_accurate_matches_local(mesh):
    """Sharded accurate-mode queries (df32 value planes on the
    replicated grid) equal the single-device fused path exactly."""
    from interpolate_unstructured_tpu.ops.interp_acc import (
        interpolate_at_acc,
        prepare_accurate,
    )
    from interpolate_unstructured_tpu.utils import meshgen

    pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
    g = iu.build_grid(
        pts, cells, nbrs, "tetra",
        point_data={"P": np.sin(np.asarray(pts)).sum(1)},
        locate_mode="walk", dtype=jnp.float32,
    )
    g = prepare_accurate(g)
    assert g.cand_df_table is not None
    grid = sharding.replicate_grid(g, mesh)

    rng = np.random.default_rng(12)
    r = jnp.asarray(0.05 + rng.random((256, 3)) * 0.9, jnp.float32)
    r_sh, b = sharding.shard_batch(r, mesh)

    f = sharding.sharded_interpolate_at_acc(mesh)
    vh, vl, found, ic = f(grid, r_sh, jnp.asarray([0]))
    vh_l, vl_l, found_l, ic_l = interpolate_at_acc(g, r, (0,))
    np.testing.assert_array_equal(np.asarray(vh)[:b], np.asarray(vh_l))
    np.testing.assert_array_equal(np.asarray(vl)[:b], np.asarray(vl_l))
    np.testing.assert_array_equal(np.asarray(ic)[:b], np.asarray(ic_l))
    assert bool(np.asarray(found)[:b].all())


def test_sharded_cell_data_lookups(quad_grid, mesh):
    """Sharded get_cell_scalar_at / get_icell_scalar_at (the remaining
    public entry points, m_interp_unstructured.f90:436-462) match the
    local lookups, cold and warm."""
    grid = quad_grid
    n_cells = grid.n_cells
    grid, icd = iu.add_cell_data(
        grid, "rho", np.arange(n_cells, dtype=float) + 0.5
    )
    grid, iicd = iu.add_icell_data(grid, "mat", 7 - np.arange(n_cells))
    grid_r = sharding.replicate_grid(grid, mesh)

    rng = np.random.default_rng(13)
    r = jnp.asarray(sample_points(rng, grid.rmin, grid.rmax, 203))
    r_sh, b = sharding.shard_batch(r, mesh)

    f = sharding.sharded_get_cell_scalar_at(mesh)
    vals, ic, found = f(grid_r, r_sh, icd)
    vals_l, ic_l, found_l = iu.get_cell_scalar_at(grid, r, icd)
    assert bool(np.asarray(found)[:b].all())
    np.testing.assert_array_equal(np.asarray(ic)[:b], np.asarray(ic_l))
    np.testing.assert_allclose(np.asarray(vals)[:b], np.asarray(vals_l))

    # warm restart: previous cells as guesses
    guess = jnp.asarray(ic)
    vals_w, ic_w, found_w = f(grid_r, r_sh, icd, guess)
    np.testing.assert_array_equal(np.asarray(ic_w)[:b], np.asarray(ic_l))
    np.testing.assert_allclose(np.asarray(vals_w)[:b], np.asarray(vals_l))

    fi = sharding.sharded_get_icell_scalar_at(mesh)
    ivals, iic, ifound = fi(grid_r, r_sh, iicd)
    ivals_l, _, _ = iu.get_icell_scalar_at(grid, r, iicd)
    assert bool(np.asarray(ifound)[:b].all())
    np.testing.assert_array_equal(np.asarray(ivals)[:b], np.asarray(ivals_l))
