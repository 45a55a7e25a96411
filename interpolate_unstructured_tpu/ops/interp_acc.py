"""Accurate (compensated-f32) interpolation — a middle path between a
float32 grid (~1e-6) and a float64 grid.

The reference meets a <=1e-12 contract in native f64
(test_triangle.f90:42-48).  This mode keeps the f32 machinery for POINT
LOCATION (a query located in a neighboring cell still interpolates
continuously, and the walk/candidate tolerances already cover f32
rounding) and recomputes the WEIGHTS AND VALUES in double-float
arithmetic (:mod:`.df32`, ~48 mantissa bits) from a packed per-cell
row that stores the original float64 geometry and data split into
(hi, lo) float32 pairs:

    row = [vhi (npc*3) | vlo (npc*3) | dhi (nv*npc) | dlo (nv*npc)]

padded to a 512-byte gather row.  The (hi, lo)
split is exact: hi = f32(x64), lo = f32(x64 - hi) represents any
float64 from the bundled meshes to ~1e-14 relative.

Weight formulas mirror the reference kernels exactly
(m_interp_unstructured.f90 :529-551 triangle, :553-586 tetra,
:588-641 quad), evaluated in df32; weights are normalized by their
df32 sum (identical inside cells, where sub-areas/volumes sum to the
cell measure).

Accuracy: ~1e-13 absolute on unit-scale meshes — measured against the
f64 CPU path in tests/test_interp_acc.py.  Work per query: the f32
locate plus one 512 B gather and ~2k elementwise flops.  Whether this
mode beats a native float64 grid on a GPU has not been measured.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import df32, locate

ACC_ROW_ALIGN = 128  # floats; 512 B rows


def acc_row_width(npc: int, nv: int) -> int:
    used = npc * 6 + 2 * nv * npc
    return -(-used // ACC_ROW_ALIGN) * ACC_ROW_ALIGN


def supported(grid) -> bool:
    return (
        grid.dtype == jnp.float32
        and grid.acc_table is not None
        and grid.cell_type in ("triangle", "quad", "tetra")
    )


@functools.partial(jax.jit, static_argnames=("npc", "nv", "width"))
def _pack_acc_rows_jit(points, points_lo, cells, pd, pd_lo, *, npc, nv, width):
    n = cells.shape[0]
    vhi = points[cells].reshape(n, npc * 3)
    vlo = points_lo[cells].reshape(n, npc * 3)
    cols = [vhi, vlo]
    if nv:
        dhi = pd[cells][:, :, :nv].transpose(0, 2, 1).reshape(n, nv * npc)
        dlo = pd_lo[cells][:, :, :nv].transpose(0, 2, 1).reshape(n, nv * npc)
        cols += [dhi, dlo]
    row = jnp.concatenate(cols, axis=1)
    return jnp.pad(row, ((0, 0), (0, width - row.shape[1])))


def update_acc_table_column(grid, i_var: int):
    """Refresh the packed rows for ONE mutated point-data variable.

    Row layout (see :func:`_pack_acc_rows_jit`):
    ``[vhi npc*3 | vlo npc*3 | dhi var-major nv*npc | dlo nv*npc]`` —
    a set_point_data only touches variable ``i_var``'s hi/lo slots, so
    two column-slice writes replace the full (n_cells, width) rebuild.
    Reads grid.point_data / point_data_lo, which must already hold the
    new values.
    """
    npc = grid.n_points_per_cell
    nv = grid.n_point_data
    t = grid.acc_table
    base = 6 * npc
    hi = grid.point_data[grid.cells, i_var].astype(t.dtype)
    lo_src = grid.point_data_lo
    lo = (
        lo_src[grid.cells, i_var].astype(t.dtype)
        if lo_src is not None
        else jnp.zeros_like(hi)
    )
    t = t.at[:, base + i_var * npc : base + (i_var + 1) * npc].set(hi)
    off = base + nv * npc
    return t.at[:, off + i_var * npc : off + (i_var + 1) * npc].set(lo)


def build_acc_table(grid):
    """Assemble the packed accurate rows on device (chunked like the
    walk/candidate repack so no whole-table transient materializes)."""
    npc = grid.n_points_per_cell
    nv = grid.n_point_data
    width = acc_row_width(npc, nv)
    lo = grid.points_lo
    if lo is None:
        # No stored f64 residuals (old checkpoint): geometry is the
        # f32 arrays exactly; accuracy is then limited by the f32
        # representation of the mesh, not by the arithmetic.
        lo = jnp.zeros_like(grid.points)
    pd = grid.point_data
    pd_lo = grid.point_data_lo
    if pd_lo is None:
        pd_lo = jnp.zeros_like(pd)
    chunk = 1 << 18
    n = grid.n_cells
    statics = dict(npc=npc, nv=nv, width=width)
    if n <= chunk:
        return _pack_acc_rows_jit(
            grid.points, lo, grid.cells, pd, pd_lo, **statics
        )
    parts = []
    for i in range(0, n, chunk):
        idx = grid.cells[i : i + chunk]
        if idx.shape[0] < chunk:
            idx = jnp.pad(idx, ((0, chunk - idx.shape[0]), (0, 0)))
        parts.append(
            _pack_acc_rows_jit(grid.points, lo, idx, pd, pd_lo, **statics)
        )
    return jnp.concatenate(parts, axis=0)[:n]


def prepare_accurate(grid, build_df: bool = True):
    """Return a grid with the accurate-mode tables built (no-op when
    already present).  Works on loaded checkpoints too; accuracy vs
    the original f64 mesh requires ``points_lo`` (stored by
    ``build_grid`` for float32 grids since checkpoint v4).

    Two tables are built:
    * ``acc_table`` — per-cell (hi, lo) geometry+data rows for the
      at-known-cell API (:func:`interpolate_at_icell_acc`), and
    * ``cand_df_table`` (simplex cover grids) — df32 value planes
      fused into the quantized candidate rows, so the cold accurate
      query runs as ONE locate-fused gather
      (ops.locate._candidates_query_df) instead of locate + a second
      per-cell gather + the ~2k-flop df32 weight kernel.

    ``build_df=False`` skips the second table — a host-side f64 plane
    solve over every cell plus ~1.3x the candidate table's bytes on
    device — for callers that only use the at-known-cell API
    (:func:`interpolate_at_acc` then runs locate + acc_table gather,
    bit-identical results at ~70% of the fused throughput).
    """
    import dataclasses

    from ..models.grid import build_cand_df_table, cand_df_supported

    updates = {}
    if grid.acc_table is None:
        updates["acc_table"] = build_acc_table(grid)
    if build_df and grid.cand_df_table is None and cand_df_supported(grid):
        updates["cand_df_table"] = build_cand_df_table(grid)
    if not updates:
        return grid
    return dataclasses.replace(grid, **updates)


def split_queries(r64):
    """Split float64 (or float32) queries into an f32 (hi, lo) pair.

    The float64 residual is computed on the HOST (numpy) when the
    input is a host array: with jax x64 disabled (the library's normal
    f32 operating mode) ``jnp.asarray`` would silently downcast r64 to
    f32 BEFORE any dtype check could see it, returning zero residuals
    and quietly degrading accurate mode to f32 query positions — the
    exact pitfall the interpolate_at_acc docstring warns about."""
    src_dtype = getattr(r64, "dtype", None)
    if src_dtype is not None and np.dtype(src_dtype) == np.float64:
        if isinstance(r64, jnp.ndarray):
            # device f64 array: x64 is necessarily enabled
            hi = r64.astype(jnp.float32)
            lo = (r64 - hi.astype(jnp.float64)).astype(jnp.float32)
            return hi, lo
        r_np = np.asarray(r64, np.float64)
        hi_np = r_np.astype(np.float32)
        lo_np = (r_np - hi_np.astype(np.float64)).astype(np.float32)
        return jnp.asarray(hi_np), jnp.asarray(lo_np)
    hi = jnp.asarray(r64, jnp.float32)
    return hi, jnp.zeros_like(hi)


def _weights_tri_df(q, v):
    """Unsigned sub-triangle areas (:529-551) in df32 — the shared
    kernel (ops/wkern.py) with the df32 arithmetic trait.

    q: 3 df components; v: [vertex][dim] df components.  Returns
    2*area (the factor cancels in the sum normalization)."""
    from . import wkern

    return wkern.triangle_areas2(v, q, wkern.DF())


def _weights_tet_df(q, v):
    """Signed triple-product weights (:553-586) in df32 — the shared
    kernel (ops/wkern.py) with the df32 arithmetic trait."""
    from . import wkern

    return wkern.tetra_triples(v, q, wkern.DF())


def _weights_quad_df(q, v):
    """Inverse-bilinear weights (:588-641) in df32 — the shared kernel
    (ops/wkern.py) with the df32 arithmetic trait, so the root choice,
    linear fallback, maxloc, and degenerate guard are identical to the
    fast paths by construction."""
    from . import wkern

    return wkern.quad_weights_generic(v, q, wkern.DF())


def interpolate_at_icell_acc(grid, r_hi, i_vars, i_cell, r_lo=None):
    """df32 interpolation at known cells.

    Args:
      grid: f32 grid with ``acc_table`` (see :func:`prepare_accurate`).
      r_hi, r_lo: (B, 3) f32 query split (``r_lo`` zeros if omitted).
      i_vars: static tuple of point-data variable slots.
      i_cell: (B,) int32 located cells (>= 0).

    Returns (vals_hi, vals_lo): (B, len(i_vars)) f32 pairs whose f64
    sum carries ~1e-13 accuracy.
    """
    if not supported(grid):
        raise ValueError(
            "grid is not prepared for accurate mode — call "
            "prepare_accurate on a float32 triangle/quad/tetra grid first"
        )
    npc = grid.n_points_per_cell
    nv = grid.n_point_data
    from .interp import _static_slots

    slots = _static_slots(i_vars)
    if slots is None:
        # The f32 path falls back to a dynamic gather for traced
        # i_vars; the df32 kernels index columns statically, so give a
        # clear error instead of a low-level ConcretizationTypeError.
        raise TypeError(
            "accurate mode needs concrete i_vars (a Python tuple of "
            "ints); a traced array cannot select df32 row columns — "
            "keep i_vars static under jit"
        )
    i_vars = slots
    if any(v >= nv or v < -nv for v in i_vars):
        raise ValueError("i_vars outside the live point-data range")
    i_vars = tuple(v % max(nv, 1) for v in i_vars)  # python-style wrap
    if r_lo is None:
        r_lo = jnp.zeros_like(r_hi)

    return _interp_acc_tile(grid, r_hi, i_vars, i_cell, r_lo)


def _interp_acc_tile(grid, r_hi, i_vars, i_cell, r_lo):
    npc = grid.n_points_per_cell
    nv = grid.n_point_data
    g = grid.acc_table[jnp.maximum(i_cell, 0)]

    def col(j):
        return g[:, j]

    q = [(r_hi[:, d], r_lo[:, d]) for d in range(3)]
    v = [
        [(col(vtx * 3 + d), col(npc * 3 + vtx * 3 + d)) for d in range(3)]
        for vtx in range(npc)
    ]
    if grid.cell_type == "triangle":
        w = _weights_tri_df(q, v)
    elif grid.cell_type == "tetra":
        w = _weights_tet_df(q, v)
    else:
        w = _weights_quad_df(q, v)

    if grid.cell_type in ("triangle", "tetra"):
        tot = w[0]
        for k in range(1, npc):
            tot = df32.add(tot, w[k])
        w = [df32.div(wk, tot) for wk in w]

    d0 = npc * 6
    outs_h, outs_l = [], []
    for slot in i_vars:
        acc = None
        for vtx in range(npc):
            dhi = col(d0 + slot * npc + vtx)
            dlo = col(d0 + nv * npc + slot * npc + vtx)
            term = df32.mul(w[vtx], (dhi, dlo))
            acc = term if acc is None else df32.add(acc, term)
        outs_h.append(acc[0])
        outs_l.append(acc[1])
    return jnp.stack(outs_h, axis=1), jnp.stack(outs_l, axis=1)


def interpolate_at_acc(grid, r, i_vars, guess=None, r_lo=None):
    """Accurate-mode public entry: f32 locate + df32 interpolate.

    ``r`` may be float64 — host (numpy) f64 splits on the host, so x64
    need NOT be enabled (jnp.asarray would silently downcast it to f32
    and lose the residual); device-resident f64 splits on device
    (requires x64) — or float32 (pass ``r_lo`` when the queries carry
    known f64 residuals).

    Returns (vals_hi, vals_lo, found, i_cell); missed queries keep
    weights from their nearest candidate but ``found`` is False.
    """
    if r_lo is None:
        r_hi, r_lo = split_queries(r)  # handles host f64 without x64
    else:
        r_hi = jnp.asarray(r, jnp.float32)

    # Fused cold path: grids prepared with df-plane candidate rows
    # answer locate AND df32 interpolation from ONE gather (the slots
    # must be concrete and within the fused range, mirroring the f32
    # fused path's static gate — interp._static_slots reads RAW
    # values, never tracers)
    from .interp import _static_slots

    slots = _static_slots(i_vars)
    if (
        guess is None
        and grid.cand_df_table is not None
        and slots
    ):
        from ..models.grid import cand_fused_nv

        if all(0 <= s < cand_fused_nv(grid) for s in slots):
            ic, found, vhT, vlT = locate._candidates_query_df(
                grid, r_hi, slots, r_lo=r_lo
            )
            return vhT.T, vlT.T, found, ic

    ic, found = locate.get_cell(grid, r_hi, guess=guess)
    vh, vl = interpolate_at_icell_acc(
        grid, r_hi, i_vars, jnp.maximum(ic, 0), r_lo=r_lo
    )
    return vh, vl, found, ic
