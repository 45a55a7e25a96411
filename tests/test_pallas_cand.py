"""The GPU candidate-probe kernel (ops/pallas_cand.py, Triton route).

On the CPU it runs through the Pallas interpreter and must reproduce
the XLA probe (locate._probe_rows_xla) exactly: same winning candidate,
same aux verdict, same fused values.  The compiled kernel is checked on
the card by the ``gpu``-marked test at the end (chip_smoke.py runs it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import interpolate_unstructured_tpu as iu
from interpolate_unstructured_tpu.models.grid import (
    _qcand_floats_per,
    cand_fused_nv,
)
from interpolate_unstructured_tpu.ops import interp, locate, pallas_cand
from interpolate_unstructured_tpu.utils import meshgen, serial_oracle
from interpolate_unstructured_tpu.utils.config import IUConfig

MESHES = {
    "tetra": lambda: meshgen.tet_box_mesh(5, 5, 5),
    "triangle": lambda: meshgen.triangle_rect_mesh(6, 5),
    "quad": lambda: meshgen.quad_rect_mesh(6, 5),
}


@functools.lru_cache(maxsize=None)
def _grid(cell_type, cover=True, dtype=jnp.float32, quantized=True):
    pts, cells, nbrs = MESHES[cell_type]()
    # without cover rows, coarse bins force overflow into extension rows
    cfg = IUConfig(
        cand_cover_row_bytes=2048 if cover else 0,
        cand_bins_per_cell=2.0 if cover else 0.1,
        cand_quantized=quantized,
    )
    return iu.build_grid(
        pts, cells, nbrs, cell_type,
        point_data={"Polynomial": pts.sum(1) + 1.0},
        locate_mode="walk", dtype=dtype, config=cfg,
    )


def _queries(grid, n_in=1000, n_out=237, seed=7):
    """In-mesh plus surrounding queries; the total is no multiple of
    the kernel's block."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(grid.rmin), np.asarray(grid.rmax)
    r = np.concatenate([
        lo + rng.random((n_in, 3)) * (hi - lo),
        lo - 0.1 * (hi - lo) + rng.random((n_out, 3)) * 1.2 * (hi - lo),
    ])
    if grid.ndim == 2:
        r[:, 2] = 0.0
    return jnp.asarray(r, jnp.float32)


def _probe_args(grid, r):
    """(idx, r_local (3, B), count_col, eps, K, nv) of the main table."""
    r_t = r.T
    ijk = locate._cand_bin_ijk_t(grid, r_t)
    idx = locate._cand_bin_flat(grid, ijk)
    rl_t = locate._cand_local_t(grid, r_t, ijk)
    k = grid.cand_ids.shape[1]
    nv = cand_fused_nv(grid)
    ccol = k * _qcand_floats_per(grid.cell_type, nv)
    eps = grid.config.eps_inside + grid.cand_qeps
    return idx, rl_t, ccol, eps, k, nv


def _both(grid, table, idx, rl_t, slots, ccol, eps, ovf_base, k, nv):
    got = pallas_cand.cand_rows_query(
        grid, table, idx, rl_t, slots, ccol, eps, ovf_base, k, nv,
        interpret=True,
    )
    want = locate._probe_rows_xla(
        grid, table[idx], rl_t, k, ccol, slots or None, eps, ovf_base,
        quantized=True, nv_fused=nv,
    )
    return got, want


def _assert_same(got, want, n_vals):
    """Same verdicts; same winner and values wherever they are used.
    On an exact miss (aux -1) the winner is never read, and among the
    far-negative margins of a miss the two compilations may round
    differently."""
    aux = np.asarray(got[1])
    np.testing.assert_array_equal(aux, np.asarray(want[1]))
    used = aux != -1
    np.testing.assert_array_equal(
        np.asarray(got[0])[used], np.asarray(want[0])[used]
    )
    assert got[2].shape == (n_vals, got[0].shape[0])
    np.testing.assert_allclose(
        np.asarray(got[2])[:, used], np.asarray(want[2])[:, used],
        rtol=0, atol=1e-6,
    )


@pytest.mark.parametrize("slots", [(0,), ()], ids=["values", "no-values"])
@pytest.mark.parametrize("cell_type", ["tetra", "triangle"])
def test_kernel_matches_xla_probe(cell_type, slots):
    grid = _grid(cell_type)
    r = _queries(grid)
    idx, rl_t, ccol, eps, k, nv = _probe_args(grid, r)
    got, want = _both(grid, grid.cand_table, idx, rl_t, slots, ccol, eps,
                      k, k, nv)
    _assert_same(got, want, len(slots))
    aux = np.asarray(got[1])
    assert (aux == -2).sum() >= 1000  # every in-mesh query found
    assert (aux == -1).any()  # and real misses outside


@pytest.mark.parametrize("cell_type", ["tetra", "triangle", "quad"])
def test_pallas_cand_parity(cell_type):
    """The probe that serves each layout on the GPU — the kernel
    (interpret mode) for quantized simplex rows, the XLA probe for quad
    rows — against independent checks: the aux encoding against the
    bins' true counts, containment of every hit, fused values against
    interpolate_at_icell, and the cells of the full candidate path."""
    grid = _grid(cell_type)
    assert cand_fused_nv(grid) >= 1
    r = _queries(grid, n_in=1024, n_out=256)
    quantized = pallas_cand.supported(grid, "gpu")
    assert quantized == (cell_type != "quad")
    r_t = r.T
    ijk = locate._cand_bin_ijk_t(grid, r_t)
    idx = locate._cand_bin_flat(grid, ijk)
    k = grid.cand_ids.shape[1]
    nv = cand_fused_nv(grid)
    eps = grid.config.eps_inside + grid.cand_qeps
    if quantized:
        rq_t = locate._cand_local_t(grid, r_t, ijk)
        ccol = k * _qcand_floats_per(grid.cell_type, nv)
        id_best, aux, vals_t = pallas_cand.cand_rows_query(
            grid, grid.cand_table, idx, rq_t, (0,), ccol, eps, k, k, nv,
            interpret=True,
        )
    else:
        nf, npc = grid.n_faces_per_cell, grid.n_points_per_cell
        ccol = k * (4 * nf + 3 * npc + 1 + npc * nv)
        id_best, aux, vals_t = locate._probe_rows_xla(
            grid, grid.cand_table[idx], r_t, k, ccol, (0,), eps, k,
            quantized=False, nv_fused=nv,
        )
    aux = np.asarray(aux)

    # aux encoding: -2 = found; >= 0 = overflow-bin miss carrying the
    # extension-table slot; -1 = exact miss (non-overflow bin)
    bins = np.asarray(idx)
    over = np.asarray(grid.cand_count)[bins] > k
    found = aux == -2
    np.testing.assert_array_equal(aux[~found & ~over], -1)
    if (~found & over).any():
        slots = np.asarray(grid.cand_ext_slot)[bins[~found & over]]
        np.testing.assert_array_equal(aux[~found & over], slots)
    inside = np.asarray(
        locate.point_is_inside_cell(grid, r, jnp.maximum(id_best, 0))
    )
    assert inside[found].all()

    ref = np.asarray(
        interp.interpolate_at_icell(
            grid, r, jnp.asarray([0]), jnp.maximum(id_best, 0)
        )
    )[:, 0]
    np.testing.assert_allclose(
        np.asarray(vals_t)[0, found], ref[found], rtol=2e-5, atol=2e-5
    )

    ic_ref, found_ref, _ = locate._candidates_query(grid, r, (0,))
    both = found & np.asarray(found_ref)
    assert both.sum() >= 1000
    np.testing.assert_array_equal(
        np.asarray(id_best)[both], np.asarray(ic_ref)[both]
    )


@pytest.mark.parametrize("cell_type", ["tetra", "triangle"])
def test_kernel_extension_rows(cell_type):
    """Overflow bins: the main-table probe reports the extension slot,
    and probing the extension rows (same layout, other K and count
    threshold) matches the XLA probe."""
    grid = _grid(cell_type, cover=False)
    assert grid.cand_ext_table is not None
    r = _queries(grid, n_in=3000, n_out=0, seed=11)
    idx, rl_t, ccol, eps, k, nv = _probe_args(grid, r)
    got, want = _both(grid, grid.cand_table, idx, rl_t, (0,), ccol, eps,
                      k, k, nv)
    _assert_same(got, want, 1)
    aux = np.asarray(got[1])
    ovf = aux >= 0
    assert ovf.any(), "no overflow-bin misses to probe"
    slots = jnp.asarray(np.where(ovf, aux, 0), jnp.int32)
    k_ext = grid.cand_ext_ids.shape[1]
    ext_ccol = k_ext * _qcand_floats_per(grid.cell_type, nv)
    got2, want2 = _both(grid, grid.cand_ext_table, slots, rl_t, (0,),
                        ext_ccol, eps, k + k_ext, k_ext, nv)
    _assert_same(got2, want2, 1)
    assert (np.asarray(got2[1])[ovf] == -2).all()


@pytest.mark.parametrize("cell_type", ["tetra", "triangle"])
def test_kernel_matches_f64_oracle(cell_type):
    """The kernel's verdict and fused values against the serial C++
    oracle in float64 (linear field: values exact up to f32 rounding)."""
    if not serial_oracle.available():
        pytest.skip("serial oracle needs g++")
    grid = _grid(cell_type)
    r = _queries(grid, n_out=0, seed=3)
    idx, rl_t, ccol, eps, k, nv = _probe_args(grid, r)
    ic, aux, vals = pallas_cand.cand_rows_query(
        grid, grid.cand_table, idx, rl_t, (0,), ccol, eps, k, k, nv,
        interpret=True,
    )
    pts = np.asarray(grid.points, np.float64)
    v_o, ic_o, f_o = serial_oracle.serial_query(
        pts, np.asarray(grid.cells), np.asarray(grid.neighbors),
        pts.sum(1) + 1.0, np.asarray(r, np.float64), cell_type=cell_type,
    )
    found = np.asarray(aux) == -2
    np.testing.assert_array_equal(found, f_o)
    np.testing.assert_allclose(np.asarray(vals[0]), v_o, atol=5e-5)
    # cells agree except on shared faces, where both are right
    differ = np.asarray(ic) != ic_o
    inside = np.asarray(locate.point_is_inside_cell(grid, r, ic))
    assert inside[differ].all()


@pytest.mark.parametrize(
    "case, platform, expect",
    [
        ("tetra", "gpu", True),
        ("triangle", "gpu", True),
        ("tetra", "cpu", False),
        ("quad", "gpu", False),
        ("tetra-f64", "gpu", False),
        ("tetra-unquantized", "gpu", False),
    ],
)
def test_dispatch_choice(case, platform, expect):
    """Only quantized f32 simplex rows on a GPU take the kernel."""
    cell_type = case.split("-")[0]
    grid = _grid(
        cell_type,
        dtype=jnp.float64 if case.endswith("f64") else jnp.float32,
        quantized=not case.endswith("unquantized"),
    )
    assert pallas_cand.supported(grid, platform) is expect


@pytest.mark.parametrize("cover", [True, False], ids=["cover", "ext"])
def test_candidates_query_through_kernel(monkeypatch, cover):
    """The public cold path with the kernel chosen (interpret mode):
    same cells, verdicts and values as with the XLA probe, including
    the extension-row fallback."""
    grid = _grid("tetra", cover=cover)
    r = _queries(grid, n_in=2000, n_out=300, seed=5)
    want = locate._candidates_query(grid, r, (0,))
    monkeypatch.setattr(pallas_cand, "supported", lambda g, p: True)
    monkeypatch.setattr(
        pallas_cand, "cand_rows_query",
        functools.partial(pallas_cand.cand_rows_query, interpret=True),
    )
    got = locate._candidates_query(grid, r, (0,))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(
        np.asarray(got[2]), np.asarray(want[2]), rtol=0, atol=1e-6
    )


@pytest.mark.gpu
def test_kernel_compiled_on_gpu_matches_xla(gpu):
    """The Triton-compiled kernel on the card against the XLA probe."""
    pts, cells, nbrs = meshgen.tet_box_mesh(20, 20, 20)
    with jax.default_device(gpu):
        grid = iu.build_grid(
            pts, cells, nbrs, "tetra",
            point_data={"Polynomial": pts.sum(1) + 1.0},
            locate_mode="walk", dtype=jnp.float32,
        )
        r = _queries(grid, n_in=200_000, n_out=20_003, seed=9)
        idx, rl_t, ccol, eps, k, nv = _probe_args(grid, r)
        got = jax.jit(
            lambda t, i, q: pallas_cand.cand_rows_query(
                grid, t, i, q, (0,), ccol, eps, k, k, nv
            )
        )(grid.cand_table, idx, rl_t)
        want = jax.jit(
            lambda t, i, q: locate._probe_rows_xla(
                grid, t[i], q, k, ccol, (0,), eps, k,
                quantized=True, nv_fused=nv,
            )
        )(grid.cand_table, idx, rl_t)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    same = np.asarray(got[0]) == np.asarray(want[0])
    # FMA contraction may differ between the two compilers: the winner
    # may differ only where two candidates tie within rounding
    assert same.mean() > 0.9999, same.mean()
    np.testing.assert_allclose(
        np.asarray(got[2]), np.asarray(want[2]), rtol=0, atol=5e-5
    )
