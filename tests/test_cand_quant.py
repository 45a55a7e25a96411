"""Quantized candidate rows (IUConfig.cand_quantized).

The f32 tri/tet cold path stores int16 probe geometry in the query
bin's local frame plus exact f32 value planes
(models/grid._pack_qcand_rows_jit).  These tests pin:

* cell/found agreement with the legacy f32 row layout away from faces
  (within the quantization fuzz band verdicts may legitimately differ),
* linear exactness of the value planes,
* the GPU Pallas kernel (interpret mode) against the XLA tile,
* the overflow-extension path on a no-cover build,
* that f64 grids and quads keep the legacy layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from interpolate_unstructured_tpu import build_grid
from interpolate_unstructured_tpu.models.grid import (
    _qcand_floats_per,
    cand_fused_nv,
    cand_is_quantized,
)
from interpolate_unstructured_tpu.ops import locate, pallas_cand
from interpolate_unstructured_tpu.utils.config import IUConfig
from interpolate_unstructured_tpu.utils.meshgen import (
    tet_box_mesh,
    triangle_rect_mesh,
)


def _mesh(cell_type):
    if cell_type == "tetra":
        return tet_box_mesh(6, 6, 6)
    return triangle_rect_mesh(8, 8)


def _grids(cell_type, **cfg_kwargs):
    points, cells, neighbors = _mesh(cell_type)
    poly = points.sum(axis=1) + 1.0
    out = []
    for quant in (True, False):
        cfg = IUConfig(cand_quantized=quant, **cfg_kwargs)
        out.append(
            build_grid(
                points, cells, neighbors, cell_type,
                point_data={"Polynomial": poly},
                locate_mode="walk", config=cfg, dtype=jnp.float32,
            )
        )
    return out


def _queries(grid, n=4000, seed=5):
    rng = np.random.default_rng(seed)
    rmin = np.asarray(grid.rmin, np.float64)
    rmax = np.asarray(grid.rmax, np.float64)
    r = rmin + rng.random((n, 3)) * (rmax - rmin)
    if grid.ndim == 2:
        r[:, 2] = 0.0
    return jnp.asarray(r, jnp.float32)


@pytest.mark.parametrize("cell_type", ["tetra", "triangle"])
def test_quantized_matches_legacy_and_truth(cell_type):
    gq, gl = _grids(cell_type)
    assert cand_is_quantized(gq.cell_type, gq.dtype, gq.config)
    assert not cand_is_quantized(gl.cell_type, gl.dtype, gl.config)
    # fewer (or 512 B-rounding-equal) row bytes than the legacy layout
    assert gq.cand_table.shape[1] <= gl.cand_table.shape[1]
    assert gq.cand_qeps > 0.0

    r = _queries(gq)
    icq, foundq, valsq = locate._candidates_query(gq, r, (0,))
    icl, foundl, valsl = locate._candidates_query(gl, r, (0,))
    assert bool(foundq.all()) and bool(foundl.all())

    # verdicts may differ only inside the quantization fuzz band:
    # check the winning cells truly contain their queries within the
    # widened tolerance
    inside = locate.point_is_inside_cell(gq, r, icq)
    margin_ok = np.asarray(inside) | (
        np.asarray(icq) == np.asarray(icl)
    )
    assert margin_ok.all()

    truth = np.asarray(r, np.float64).sum(axis=1) + 1.0
    for vals in (valsq, valsl):
        err = np.abs(np.asarray(vals[0], np.float64) - truth).max()
        assert err < 5e-5, err
    # agreement rate should be near-total (fuzz band is ~h/2e4 wide)
    agree = (np.asarray(icq) == np.asarray(icl)).mean()
    assert agree > 0.999, agree


def test_pallas_interpret_matches_xla_tile():
    (gq,) = _grids("tetra")[:1]
    r = _queries(gq)
    nv = cand_fused_nv(gq)
    k = gq.cand_ids.shape[1]
    ccol = k * _qcand_floats_per("tetra", nv)
    r_t = r.T
    ijk = locate._cand_bin_ijk_t(gq, r_t)
    nby, nbz = gq.cand_shape[1], gq.cand_shape[2]
    idx = (ijk[0] * nby + ijk[1]) * nbz + ijk[2]
    rl_t = locate._cand_local_t(gq, r_t, ijk)
    eps = gq.config.eps_inside + gq.cand_qeps

    id_p, aux_p, vals_p = pallas_cand.cand_rows_query(
        gq, gq.cand_table, idx, rl_t, (0,), ccol, eps, k, k, nv,
        interpret=True,
    )
    id_x, aux_x, vals_x = locate._probe_rows_xla(
        gq, gq.cand_table[idx], rl_t, k, ccol, (0,), eps, k,
        quantized=True, nv_fused=nv,
    )
    np.testing.assert_array_equal(np.asarray(id_p), np.asarray(id_x))
    np.testing.assert_array_equal(np.asarray(aux_p), np.asarray(aux_x))
    np.testing.assert_allclose(
        np.asarray(vals_p), np.asarray(vals_x), rtol=0, atol=1e-6
    )


def test_extension_path_no_cover():
    gq, _ = _grids("tetra", cand_cover_row_bytes=0)
    assert gq.cand_ext_ids is not None
    r = _queries(gq, seed=11)
    ic, found, valsT = locate._candidates_query(gq, r, (0,))
    assert bool(found.all())
    truth = np.asarray(r, np.float64).sum(axis=1) + 1.0
    err = np.abs(np.asarray(valsT[0], np.float64) - truth).max()
    assert err < 5e-5, err


def test_f64_and_quad_stay_legacy():
    points, cells, neighbors = _mesh("tetra")
    g64 = build_grid(
        points, cells, neighbors, "tetra",
        point_data={"Polynomial": points.sum(axis=1) + 1.0},
        locate_mode="walk", config=IUConfig(), dtype=jnp.float64,
    )
    assert not cand_is_quantized(g64.cell_type, g64.dtype, g64.config)
    assert g64.cand_qeps == 0.0
    assert not cand_is_quantized("quad", jnp.float32, IUConfig())
