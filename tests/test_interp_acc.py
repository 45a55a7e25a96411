"""Accurate-mode (compensated f32) interpolation tests.

The contract being bridged: the reference meets <=1e-12 vs float64
(test_triangle.f90:42-48) while the fast path is float32.  The
df32 mode must reproduce the float64 interpolation — SAME cells, SAME
weight formulas — to ~1e-12 from float32 storage and arithmetic.

Meshes are scaled by pi so coordinates (and the random float64 data)
genuinely need the stored (hi, lo) residual split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import interpolate_unstructured_tpu as iu
from conftest import sample_points

SCALE = np.pi
N = 1000


def _f32_and_f64_grids(test_data_dir, name, seed):
    """Parallel f32 (+acc tables) and f64 grids of a bundled mesh with
    a random float64 variable added to both."""
    rng = np.random.default_rng(seed)
    g32 = iu.read_grid(
        test_data_dir / name, coord_scale_factor=SCALE, dtype=jnp.float32
    )
    g64 = iu.read_grid(
        test_data_dir / name, coord_scale_factor=SCALE, dtype=jnp.float64
    )
    rough = rng.standard_normal(g32.n_points)  # O(1) inter-vertex jumps
    g32, iv32 = iu.add_point_data(g32, "rough", rough)
    g64, iv64 = iu.add_point_data(g64, "rough", rough)
    assert iv32 == iv64
    g32 = iu.prepare_accurate(g32)
    return g32, g64, iv32


@pytest.mark.parametrize(
    "name,seed", [("triangle.vtu", 0), ("quad.vtu", 1), ("tetra.vtu", 2)]
)
def test_acc_matches_f64_same_cells(test_data_dir, name, seed):
    g32, g64, ivar = _f32_and_f64_grids(test_data_dir, name, seed)
    rng = np.random.default_rng(seed + 10)
    r64 = jnp.asarray(sample_points(rng, g32.rmin, g32.rmax, N))

    vh, vl, found, ic = iu.interpolate_at_acc(g32, r64, (ivar,))
    assert bool(np.asarray(found).all())
    got = np.asarray(vh, np.float64) + np.asarray(vl, np.float64)

    # f64 reference on the SAME cells (the df32 arithmetic is under
    # test, not near-face tie-breaking of the f32 locate)
    ref = np.asarray(
        iu.interpolate_at_icell(
            g64, r64, jnp.asarray([ivar]), jnp.asarray(ic)
        ),
        np.float64,
    )
    err = np.abs(got[:, 0] - ref[:, 0]).max()
    assert err < 1e-12, f"max |acc - f64| = {err:.3e}"


@pytest.mark.parametrize(
    "name,seed", [("triangle.vtu", 3), ("quad.vtu", 4), ("tetra.vtu", 5)]
)
def test_acc_linear_exactness_1e12(test_data_dir, name, seed):
    """The f32 fast path tops out ~1e-6 here; accurate mode must hold
    the reference's f64-grade exactness on the linear field."""
    g32 = iu.read_grid(
        test_data_dir / name, coord_scale_factor=SCALE, dtype=jnp.float32
    )
    # exact f64 linear data at the SCALED coordinates
    pts64 = np.asarray(g32.points, np.float64) + np.asarray(
        g32.points_lo, np.float64
    )
    lin = pts64.sum(axis=1) + 1.0
    g32, ivar = iu.add_point_data(g32, "lin64", lin)
    g32 = iu.prepare_accurate(g32)

    rng = np.random.default_rng(seed + 20)
    r64 = jnp.asarray(sample_points(rng, g32.rmin, g32.rmax, N))
    vh, vl, found, _ = iu.interpolate_at_acc(g32, r64, (ivar,))
    assert bool(np.asarray(found).all())
    got = np.asarray(vh, np.float64) + np.asarray(vl, np.float64)
    ref = np.asarray(r64, np.float64).sum(axis=1) + 1.0
    err = np.abs(got[:, 0] - ref).max()
    assert err < 1e-12, f"max linear-exactness error {err:.3e}"


def test_acc_multivar_and_f32_queries(test_data_dir):
    g32, g64, ivar = _f32_and_f64_grids(test_data_dir, "tetra.vtu", 7)
    rng = np.random.default_rng(30)
    r64 = sample_points(rng, g32.rmin, g32.rmax, 64)
    poly = iu.get_point_data_index(g32, "Polynomial")

    vh, vl, found, ic = iu.interpolate_at_acc(g32, jnp.asarray(r64), (poly, ivar))
    assert vh.shape == (64, 2)
    # f32 queries (no residual): still valid, limited by query rounding
    vh2, vl2, found2, _ = iu.interpolate_at_acc(
        g32, jnp.asarray(r64, jnp.float32), (poly, ivar)
    )
    assert bool(np.asarray(found2).all())


def test_acc_table_survives_checkpoint(test_data_dir, tmp_path):
    g32, g64, ivar = _f32_and_f64_grids(test_data_dir, "quad.vtu", 8)
    fn = str(tmp_path / "acc.binda")
    iu.save_grid(g32, fn)
    g2 = iu.load_grid(fn)
    # residual leaves round-trip; the derived table rebuilds on demand
    assert g2.points_lo is not None and g2.point_data_lo is not None
    np.testing.assert_array_equal(
        np.asarray(g2.points_lo), np.asarray(g32.points_lo)
    )
    g2 = iu.prepare_accurate(g2)
    rng = np.random.default_rng(31)
    r64 = jnp.asarray(sample_points(rng, g2.rmin, g2.rmax, 128))
    vh, vl, found, ic = iu.interpolate_at_acc(g2, r64, (ivar,))
    ref = np.asarray(
        iu.interpolate_at_icell(
            g64, r64, jnp.asarray([ivar]), jnp.asarray(ic)
        ),
        np.float64,
    )
    got = np.asarray(vh, np.float64) + np.asarray(vl, np.float64)
    assert np.abs(got[:, 0] - ref[:, 0]).max() < 1e-12


def test_acc_i_var_guard_and_negative_wrap(test_data_dir):
    """Out-of-range variable slots raise; negative slots wrap
    python-style like the generic path."""
    g32, _, ivar = _f32_and_f64_grids(test_data_dir, "triangle.vtu", 5)
    r = jnp.asarray([[0.3 * SCALE, 0.3 * SCALE, 0.0]])
    nv = g32.n_point_data

    vh, vl, found, ic = iu.interpolate_at_acc(g32, r, (ivar,))
    vh_n, vl_n, _, _ = iu.interpolate_at_acc(g32, r, (ivar - nv,))
    np.testing.assert_array_equal(np.asarray(vh), np.asarray(vh_n))
    np.testing.assert_array_equal(np.asarray(vl), np.asarray(vl_n))

    with pytest.raises(ValueError, match="point-data range"):
        iu.interpolate_at_acc(g32, r, (nv,))
    with pytest.raises(ValueError, match="point-data range"):
        iu.interpolate_at_acc(g32, r, (-nv - 1,))


def test_set_point_data_refreshes_accurate_state(test_data_dir):
    """set_point_data must keep point_data_lo and acc_table in sync —
    accurate mode would otherwise interpolate the OLD values."""
    g32, _, ivar = _f32_and_f64_grids(test_data_dir, "triangle.vtu", 6)
    rng = np.random.default_rng(60)
    new_vals = rng.standard_normal(g32.n_points)  # float64

    g32b = iu.set_point_data(g32, ivar, new_vals)
    r = jnp.asarray(
        sample_points(np.random.default_rng(61), g32.rmin, g32.rmax, 64)
    )
    vh, vl, found, ic = iu.interpolate_at_acc(g32b, r, (ivar,))
    assert bool(np.asarray(found).all())
    got = np.asarray(vh, np.float64) + np.asarray(vl, np.float64)

    # f64 reference from scratch on the same cells and the new values
    g64 = iu.read_grid(
        test_data_dir / "triangle.vtu",
        coord_scale_factor=SCALE,
        dtype=jnp.float64,
    )
    g64, iv64 = iu.add_point_data(g64, "rough", new_vals)
    ref = np.asarray(
        iu.interpolate_at_icell(
            g64, r, jnp.asarray([iv64]), jnp.asarray(ic)
        ),
        np.float64,
    )
    np.testing.assert_allclose(got, ref, atol=1e-10)


def test_set_point_data_scalar_broadcast_f32(test_data_dir):
    """Scalar values broadcast on f32 grids too (the residual sync must
    not reshape a 0-d array), and the targeted acc-table column update
    matches a full rebuild."""
    from interpolate_unstructured_tpu.ops.interp_acc import build_acc_table

    g32, _, ivar = _f32_and_f64_grids(test_data_dir, "triangle.vtu", 7)
    g = iu.set_point_data(g32, ivar, 0.1)  # python float -> broadcast
    np.testing.assert_allclose(
        np.asarray(g.point_data[:, ivar]), np.float32(0.1)
    )
    # residual column carries the exact f64 remainder of 0.1
    lo = np.asarray(g.point_data_lo[:, ivar], np.float64)
    np.testing.assert_allclose(
        lo + np.float64(np.float32(0.1)), 0.1, atol=1e-16
    )
    # column update == full rebuild
    np.testing.assert_array_equal(
        np.asarray(g.acc_table), np.asarray(build_acc_table(g))
    )
    # negative i_var wraps; out-of-range raises
    g2 = iu.set_point_data(g32, ivar - g32.n_point_data, 0.5)
    np.testing.assert_allclose(
        np.asarray(g2.point_data[:, ivar]), np.float32(0.5)
    )
    with pytest.raises(ValueError, match="point-data range"):
        iu.set_point_data(g32, g32.n_point_data, 0.0)


def test_acc_host_f64_split_without_x64(test_data_dir):
    """Host (numpy) float64 queries split on the HOST: jnp.asarray
    would silently downcast to f32 when x64 is off — exactly the
    sessions accurate mode exists for.  Passing the same queries as a
    host array must match the device-split path bit-for-bit."""
    g32, _, ivar = _f32_and_f64_grids(test_data_dir, "triangle.vtu", 8)
    rng = np.random.default_rng(80)
    r_np = sample_points(rng, g32.rmin, g32.rmax, 128)  # numpy f64

    vh1, vl1, f1, ic1 = iu.interpolate_at_acc(g32, r_np, (ivar,))
    vh2, vl2, f2, ic2 = iu.interpolate_at_acc(
        g32, jnp.asarray(r_np), (ivar,)  # device f64 (x64 on in tests)
    )
    np.testing.assert_array_equal(np.asarray(vh1), np.asarray(vh2))
    np.testing.assert_array_equal(np.asarray(vl1), np.asarray(vl2))
    np.testing.assert_array_equal(np.asarray(ic1), np.asarray(ic2))


@pytest.mark.parametrize("mesh", ["triangle.vtu", "quad.vtu", "tetra.vtu"])
def test_acc_tile_matches_f64(test_data_dir, mesh):
    """The df32 tile must hit ~1e-12 accuracy vs the f64 reference at
    the same cells, under jit: XLA contracts mul+add into FMA when it
    compiles a fused graph, which the df32 transforms must survive
    (ops/df32.py).  Truth is the f64 interpolation at the same cells."""
    from interpolate_unstructured_tpu.ops import interp_acc, locate

    g32, g64, ivar = _f32_and_f64_grids(test_data_dir, mesh, 21)
    rng = np.random.default_rng(22)
    r = sample_points(rng, g32.rmin, g32.rmax, 700).astype(np.float32)
    r_hi = jnp.asarray(r)
    r_lo = jnp.zeros_like(r_hi)

    ic, found = locate.get_cell(g32, r_hi)
    ic = jnp.maximum(ic, 0)
    truth = np.asarray(
        iu.interpolate_at_icell(
            g64, jnp.asarray(r, jnp.float64), jnp.asarray([ivar]), ic
        )
    )[:, 0]
    scale = max(1.0, np.abs(truth[np.asarray(found)]).max())
    f = np.asarray(found)

    tile = jax.jit(
        lambda g, rh, c, rl: interp_acc._interp_acc_tile(g, rh, (ivar,), c, rl)
    )
    vh_x, vl_x = tile(g32, r_hi, ic, r_lo)
    got_x = np.asarray(vh_x[:, 0], np.float64) + np.asarray(
        vl_x[:, 0], np.float64
    )
    err_tile = np.abs(got_x[f] - truth[f]).max() / scale
    assert err_tile < 2e-12, f"XLA df32 tile drifted: {err_tile}"
