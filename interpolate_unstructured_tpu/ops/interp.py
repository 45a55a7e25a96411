"""Batched interpolation kernels and the public query API.

Vectorizations of the reference L4 kernels
(m_interp_unstructured.f90:436-662): barycentric triangle, scalar-triple
tetrahedron, and inverse-bilinear quad weights, fused with a
multi-variable gather/contraction ``einsum('bk,bkv->bv')``.

Weight formulas match the reference bit-for-bit in exact arithmetic:
* triangle (:529-551): opposite-sub-triangle areas over the precomputed
  cell area (unsigned — valid for points inside the cell only).
* tetra (:553-586): signed scalar triple products over 6*volume.
* quad (:588-641): Reed Beta inverse bilinear — quadratic in mu with the
  (-B - sqrt(disc)) / 2A root, linear fallback for degenerate A (the
  reference's absolute |A| < 1e-20, :618, scaled to the dtype), lambda
  from the largest-|denominator| component, then tensor-product blend.

The reference's silent-miss semantics (output untouched when no cell is
found, :492) become explicit: every query returns a ``found`` mask, and
values default to the provided fill (or NaN) where not found.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import locate

# Full input-precision contractions (no reduced-precision matmul
# passes such as TF32)
_PRECISION = lax.Precision.HIGHEST


def _vq_components(cell_points, r, npc):
    """(B, npc, 3) vertices + (B, 3) query -> per-component lists for
    the shared weight kernels (ops/wkern.py)."""
    v = [[cell_points[:, k, d] for d in range(3)] for k in range(npc)]
    q = [r[:, d] for d in range(3)]
    return v, q


def triangle_weights(cell_points, area, r):
    """(B,3,3) vertices, (B,) area, (B,3) query -> (B,3) weights.

    Opposite sub-triangle areas over the cell area (:529-551); the
    area math is the shared kernel in ops/wkern.py."""
    from . import wkern

    v, q = _vq_components(cell_points, r, 3)
    a2 = wkern.triangle_areas2(v, q, wkern.Plain(r.dtype))
    return jnp.stack([0.5 * a for a in a2], axis=1) / area[:, None]


def tetra_weights(cell_points, volume, r):
    """(B,4,3) vertices, (B,) signed volume, (B,3) query -> (B,4)
    weights.  Signed triple products over 6*volume (:553-586); the
    triple-product math is the shared kernel in ops/wkern.py."""
    from . import wkern

    v, q = _vq_components(cell_points, r, 4)
    w = wkern.tetra_triples(v, q, wkern.Plain(r.dtype))
    return jnp.stack(w, axis=1) / (6.0 * volume)[:, None]


def quad_weights(cell_points, r):
    """(B,4,3) vertices, (B,3) query -> (B,4) inverse-bilinear weights.

    Branch-free replication of interpolate_quad (:588-641); the quad is
    assumed planar with its plane parallel to z (cross_product_z, :653).
    The arithmetic — root choice, linear fallback, maxloc, degenerate
    guard — is the SINGLE shared definition in ops/wkern.py, used by
    every path (plain and df32) by construction.
    """
    from . import wkern

    v, q = _vq_components(cell_points, r, 4)
    w = wkern.quad_weights_generic(v, q, wkern.Plain(r.dtype))
    return jnp.stack(w, axis=1)


def _weights_from_geometry(cell_type, cp, vol, r):
    """Weight-kernel dispatch on pre-gathered per-query geometry."""
    if cell_type == "triangle":
        return triangle_weights(cp, vol, r)
    if cell_type == "quad":
        return quad_weights(cp, r)
    if cell_type == "tetra":
        return tetra_weights(cp, vol, r)
    raise ValueError(f"Unsupported cell type {cell_type!r}")


def cell_weights(grid, r, i_cell):
    """Interpolation weights of each query in its (assumed) cell.

    Returns (B, npc) weights; dispatch on the grid's static cell type
    (iu_interpolate_at_icell, :497-527).
    """
    ic = jnp.maximum(i_cell, 0)
    cp = grid.cell_points[ic]
    return _weights_from_geometry(
        grid.cell_type, cp, grid.cell_volume[ic], r
    )


def _onehot_gather(table, ic):
    """Row gather as a one-hot matmul: (C, K), (B,) -> (B, K).

    Each one-hot row has a single 1.0, so the contraction is the exact
    row value (no rounding: 1*v plus zeros) at HIGHEST precision.
    """
    c = table.shape[0]
    onehot = (
        ic[:, None] == lax.broadcasted_iota(jnp.int32, (1, c), 1)
    ).astype(table.dtype)
    return jnp.dot(onehot, table, precision=_PRECISION)


def _interpolate_bruteforce(grid, r, i_vars):
    """Fused locate + interpolate for small (brute-force-mode) meshes.

    Zero per-row gathers: containment margins via one matmul, then one
    one-hot matmul pulls each query's cell geometry *and* vertex data in
    a single (B, C) x (C, K) contraction.  Tiled over the batch to
    bound the materialized (tile, C·nf) margin and (tile, C) one-hot
    buffers.
    """
    from . import locate

    n_cells, nf = grid.face_offsets.shape
    npc = grid.n_points_per_cell
    v = i_vars.shape[0]
    eps = grid.config.eps_inside

    # Per-cell payload: vertex coords | volume | vertex data values
    pd_cell = grid.point_data[:, i_vars][grid.cells]  # (C, npc, V)
    table = jnp.concatenate(
        [
            grid.cell_points.reshape(n_cells, npc * 3),
            grid.cell_volume[:, None],
            pd_cell.reshape(n_cells, npc * v),
        ],
        axis=1,
    )

    def tile(rt):
        margins = locate._containment_margins(grid, rt)  # (bt, C)
        best = jnp.argmax(margins, axis=1).astype(jnp.int32)
        found = jnp.max(margins, axis=1) >= -eps
        g = _onehot_gather(table, best)
        cp = g[:, : npc * 3].reshape(-1, npc, 3)
        vol = g[:, npc * 3]
        vertex_vals = g[:, npc * 3 + 1 :].reshape(-1, npc, v)
        w = _weights_from_geometry(grid.cell_type, cp, vol, rt)
        vals = (w[:, :, None] * vertex_vals).sum(axis=1)
        return vals, jnp.where(found, best, -1), found

    b = r.shape[0]
    # Bound tile * C * nf (margins) to ~2^26 elements
    max_tile = max(1024, (1 << 26) // max(n_cells * nf, 1))
    if b <= max_tile:
        return tile(r)
    chunk = max_tile
    pad = (-b) % chunk
    rp = jnp.pad(r, ((0, pad), (0, 0)))
    vals, ic, found = lax.map(tile, rp.reshape(-1, chunk, 3))
    return (
        vals.reshape(-1, v)[:b],
        ic.reshape(-1)[:b],
        found.reshape(-1)[:b],
    )


def interpolate_at_icell(grid, r, i_vars, i_cell):
    """Interpolate point-data variables inside known cells (:497-527).

    Args:
      r: (B, 3) positions.
      i_vars: (V,) int array / sequence of point-data variable indices.
      i_cell: (B,) containing cell per position (not validated).
    Returns:
      (B, V) interpolated values.
    """
    i_vars = jnp.asarray(i_vars)
    ic = jnp.maximum(i_cell, 0)
    b = r.shape[0]
    n_cells = grid.n_cells
    npc = grid.n_points_per_cell
    nf = grid.n_faces_per_cell
    v = i_vars.shape[0]
    pd_sel = grid.point_data[:, i_vars]  # (P, V)

    row_width = 512 // jnp.dtype(grid.dtype).itemsize
    k_cols = npc * 3 + 1 + npc * v
    if b * 4 >= n_cells and k_cols <= row_width:
        # Big batch: assemble a per-call fused row table on device
        # (vertex coords | volume | vertex data) padded to 512 bytes
        # — ONE row gather per query answers the
        # whole interpolation (C-sized assembly is cheap relative to
        # B-sized gathers)
        ftab = jnp.concatenate(
            [
                grid.cell_points.reshape(n_cells, npc * 3),
                grid.cell_volume[:, None],
                pd_sel[grid.cells].reshape(n_cells, npc * v),
            ],
            axis=1,
        )
        ftab = jnp.pad(ftab, ((0, 0), (0, row_width - k_cols)))
        g = ftab[ic]
        cp = g[:, : npc * 3].reshape(-1, npc, 3)
        vol = g[:, npc * 3]
        vertex_vals = g[:, npc * 3 + 1 : k_cols].reshape(-1, npc, v)
        w = _weights_from_geometry(grid.cell_type, cp, vol, r)
        return (w[:, :, None] * vertex_vals).sum(axis=1)

    if grid.walk_table is not None:
        # Geometry rides the packed 512B-row table: one gather
        g = grid.walk_table[ic]
        cp = g[:, nf * 5 : nf * 5 + npc * 3].reshape(-1, npc, 3)
        vol = g[:, nf * 5 + npc * 3]
        w = _weights_from_geometry(grid.cell_type, cp, vol, r)
    else:
        w = cell_weights(grid, r, ic)  # (B, npc)

    vertex_vals = pd_sel[grid.cells[ic]]  # (B, npc, V)
    return (w[:, :, None] * vertex_vals).sum(axis=1)


def interpolate_at(grid, r, i_vars, guess=None, fill_value=jnp.nan):
    """Locate + interpolate (iu_interpolate_at, :480-495), batched.

    Args:
      r: (B, 3) positions.
      i_vars: (V,) point-data variable indices.
      guess: optional (B,) warm-start cells (negative = cold).
      fill_value: value for queries outside the mesh (the reference
        leaves the output untouched, :492 — pass the previous values
        here to reproduce that).
    Returns:
      values: (B, V)
      i_cell: (B,) containing cell, negative if not found
      found: (B,) bool
    """
    valsT, i_cell, found = _interpolate_at_T(
        grid, r, i_vars, guess, fill_value
    )
    return valsT.T, i_cell, found


def _interpolate_at_T(grid, r, i_vars, guess=None, fill_value=jnp.nan):
    """interpolate_at with TRANSPOSED (V, B) values.

    The scalar wrapper reads ``valsT[0]`` from this, never touching a
    (B, 1) layout; the fused candidate path produces its values
    row-shaped (V, B) anyway.
    """
    # Capture concrete variable indices BEFORE the jnp conversion: under
    # jit tracing jnp.asarray yields a Tracer and the fused-row fast
    # path would silently never engage
    slots = _static_slots(i_vars)
    # int32 keeps an empty list a valid indexer (asarray([]) is float)
    i_vars = jnp.asarray(i_vars, jnp.int32)

    def fill_T(valsT, found):
        if isinstance(fill_value, (int, float)):
            fill = jnp.full_like(valsT, fill_value)
        else:
            # array fills keep the documented (B, V)-broadcastable
            # contract (e.g. previous values); broadcast in caller
            # shape, then relayout once
            fill = jnp.broadcast_to(
                jnp.asarray(fill_value, valsT.dtype), valsT.shape[::-1]
            ).T
        return jnp.where(found[None, :], valsT, fill)

    if grid.locate_mode == "bruteforce":
        # Fused gather-free pipeline (the guess is irrelevant here:
        # containment is exact in one shot)
        values, i_cell, found = _interpolate_bruteforce(grid, r, i_vars)
        return fill_T(values.T, found), i_cell, found

    # Fused cold path: walk-mode grids with candidate tables answer
    # locate AND interpolate from the SAME gathered row when every
    # requested variable is fused into it — the separate
    # interpolate_at_icell gather round disappears.
    if (
        guess is None
        and grid.cand_table is not None
        and slots  # non-empty: the generic path handles i_vars == []
    ):
        from ..models.grid import cand_fused_nv

        # Negative indices are valid in the generic path (python-style
        # wrap into point_data) but would slice packed-row role columns
        # at bogus offsets here — they must fall through.
        if all(0 <= s < cand_fused_nv(grid) for s in slots):
            i_cell, found, valsT = locate._candidates_query(grid, r, slots)
            return fill_T(valsT, found), i_cell, found

    i_cell, found = locate.get_cell(grid, r, guess)
    values = interpolate_at_icell(grid, r, i_vars, i_cell)
    return fill_T(values.T, found), i_cell, found


def _static_slots(i_vars):
    """Concrete variable indices as a tuple, or None under tracing."""
    import numpy as np

    try:
        return tuple(int(v) for v in np.asarray(i_vars).reshape(-1))
    except (
        jax.errors.TracerArrayConversionError,
        jax.errors.ConcretizationTypeError,
        TypeError,
        ValueError,
    ):
        return None


def interpolate_scalar_at(grid, r, i_var, guess=None, fill_value=jnp.nan):
    """Single-variable wrapper (iu_interpolate_scalar_at, :464-477)."""
    fv = fill_value
    # np.ndim handles Python scalars AND 0-d arrays (np.float32(0.0),
    # jnp scalars) — an isinstance check misses the latter and the
    # [:, None] below would raise on a 0-dimensional array
    if np.ndim(fv) != 0:
        fv = jnp.asarray(fv)[:, None]
    # Pass the raw index: a jnp conversion here would hide the
    # concrete value from interpolate_at's fused-row fast path.
    # The transposed internal keeps the whole pipeline on (1, B)
    # layouts — values come back as one (1, B) row.
    valsT, i_cell, found = _interpolate_at_T(
        grid, r, [i_var], guess, fill_value=fv
    )
    return valsT[0], i_cell, found


def get_cell_scalar_at(grid, r, i_var, guess=None, fill_value=jnp.nan):
    """Piecewise-constant cell-data lookup (iu_get_cell_scalar_at,
    :436-448): locate, then read cell_data directly — no interpolation."""
    i_cell, found = locate.get_cell(grid, r, guess)
    if grid.locate_mode == "bruteforce":
        vals = _onehot_gather(
            grid.cell_data[:, i_var][:, None], jnp.maximum(i_cell, 0)
        )[:, 0]
    else:
        vals = grid.cell_data[jnp.maximum(i_cell, 0), i_var]
    vals = jnp.where(found, vals, fill_value)
    return vals, i_cell, found


def get_icell_scalar_at(grid, r, i_var, guess=None, fill_value=-1):
    """Integer cell-data lookup (iu_get_icell_scalar_at, :450-462)."""
    i_cell, found = locate.get_cell(grid, r, guess)
    vals = grid.icell_data[jnp.maximum(i_cell, 0), i_var]
    vals = jnp.where(found, vals, fill_value)
    return vals, i_cell, found
