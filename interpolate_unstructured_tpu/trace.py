"""Field-line tracing: adaptive Bogacki–Shampine RK23 along an
interpolated vector field.

Re-design of ``iu_integrate_along_field``
(m_interp_unstructured.f90:987-1217) for batched execution: one
``lax.while_loop`` over the whole trajectory batch with fixed-shape
output buffers and explicit active-lane masking (a vmapped nested
while_loop would run every lane for the slowest lane's iteration
count anyway).  Control-flow parity:

* integrates along the *unit vector* of the interpolated field
  (arc-length parameterization, get_unitvec :1193-1201, optional
  ``reverse``), plus ``nvar`` user ODE variables via a traced callback
  (integrate_sub_t, :61-74);
* embedded 2nd-order error estimate with
  ``scales = atol + max(|y3|,|y2|)*rtol`` and
  ``err = sqrt(sum(((y3-y2)/scales)^2)/3)`` (:1162-1163); accept when
  ``err <= 1`` or ``dx < 2*min_dx`` (:1165);
* step-size update ``dx*min(max_growth, 0.8*err**(-1/3))`` clamped to
  ``[min_dx, max_dx]``, growth capped at 1x right after a rejection
  else 2x (:1178-1188);
* boundary handling: when a sub-step's neighbor walk stops early
  (status != 0), shrink ``dx = (1-1e-8)*|r_p - r0|`` (distance to the
  intersection, :1084) and retry; terminate when ``dx < min_dx``,
  reporting ``boundary_material`` (-1 physical boundary, else the mask
  value of the cell entered, :1086-1096);
* optional ``axisymmetric`` clamps the first coordinate >= 1e-12
  (:1120/:1133/:1147/:1171); optional icell mask restricts integration
  to a region (:1055-1068).

The Fortran ``cycle``-on-failure structure is flattened branch-free:
when an earlier sub-step fails (or a lane is done), later walks are
aimed at their own start point, which makes them degenerate no-ops
(the walk's tiny-distance short-circuit, :689-692), so one pass through
the body computes exactly what the reference's goto-laden loop does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .ops import interp, locate

SAFETY_FAC = 0.8
MIN_RADIUS = 1e-12


def _shrink_eps(dtype):
    """Boundary shrink factor: dx -> (1-eps)*|r_p - r0| (:1084).

    The reference's 1e-8 assumes float64; in float32, (1 - 1e-8) == 1
    exactly, so dx never decreases and the shrink-and-retry loop
    livelocks at domain boundaries.  Use ~sqrt(machine eps) instead.
    """
    import numpy as np

    if np.dtype(dtype) == np.float32:
        return 3e-4
    return 1e-8
# boundary_material sentinel: trace still running / buffer exhausted
BM_NOT_REACHED = -2
# Sub-step walk hit config.trace_walk_max_steps even at dx ~ min_dx:
# a min_dx segment crosses more cells than the cap allows (pathological
# min_dx / cell-size ratio).  The reference walks unbounded (:431) so
# it has no analog; reporting it as a boundary (-1) would be silently
# wrong mid-domain.  Raise trace_walk_max_steps or min_dx to cure.
BM_STEP_CAP = -3


class TraceResult(NamedTuple):
    """Batched trace output (shapes lead with the trajectory batch B)."""

    y: Any  # (B, max_steps, ndim+nvar) solution curve; [i, 0] = y0
    y_field: Any  # (B, max_steps, ndim) field samples along the curve
    n_steps: Any  # (B,) int32: valid points; max_steps+1 = not reached
    boundary_material: Any  # (B,) int32: -1 physical boundary, mask value,
    #                         BM_NOT_REACHED if the buffer filled first,
    #                         or BM_STEP_CAP (walk cap at min_dx — see
    #                         the sentinel's comment)
    n_iterations: Any  # (B,) int32: RK iterations spent (diagnostics)


class _State(NamedTuple):
    y_buf: Any
    yf_buf: Any
    anchor: Any  # (ndim+nvar, B) rows: current accepted state
    #              (== y_buf[:, n_idx].T)
    field_a: Any  # (3, B) rows: field at the anchor (zero-padded dims)
    n_idx: Any  # index of last accepted point (n_steps-1)
    i_cell_prev: Any
    dx: Any
    last_rejected: Any
    iteration: Any
    done: Any
    overflow: Any  # buffer filled before a boundary was reached
    boundary_material: Any


def _default_sub_int(field, y):
    return jnp.zeros((0,), dtype=y.dtype)


def build_trace_table(grid, i_field):
    """Fused per-cell row table for the tracer: the walk-table layout
    (face normals | offsets | neighbor ids) extended with the cell
    geometry AND the traced field's vertex values, padded to the
    512-byte fast-gather width.

    One row gather after each RK sub-walk then serves the *entire*
    interpolation (iu_interpolate_at_icell, :497-527) — the generic
    path's three separate gathers (walk row, connectivity, point data)
    collapse into none.

    Public so repeated trace calls over the SAME field can prebuild it
    once and pass ``trace_table=`` to :func:`integrate_along_field`:
    assembled inline it is re-gathered and re-written every call (a
    ~1M-cell mesh's table is 244 MB in f32).  ``i_field`` order must
    match the ``i_field`` later passed to the trace call.
    """
    n_cells = grid.n_cells
    nf = grid.n_faces_per_cell
    npc = grid.n_points_per_cell
    dtype = grid.dtype
    pd = grid.point_data[:, i_field]  # (P, ndim)
    cols = jnp.concatenate(
        [
            grid.face_normals.reshape(n_cells, nf * 3),
            grid.face_offsets,
            grid.neighbors.astype(dtype),
            grid.cell_points.reshape(n_cells, npc * 3),
            grid.cell_volume[:, None],
            pd[grid.cells].reshape(n_cells, npc * pd.shape[1]),
        ],
        axis=1,
    )
    # Rows padded to a multiple of 16 elements, at least 64 (256 B in
    # f32); the width has not been tuned on the GPU.
    row_width = max(64, -(-cols.shape[1] // 16) * 16)
    pad = row_width - cols.shape[1]
    return jnp.pad(cols, ((0, 0), (0, pad)))


def integrate_along_field(
    grid,
    y0,
    i_field,
    *,
    nvar: int = 0,
    sub_int=None,
    min_dx: float,
    max_dx: float,
    max_steps: int,
    rtol: float,
    atol: float,
    reverse: bool = False,
    axisymmetric: bool = False,
    i_icell_mask: int | None = None,
    mask_value: int | None = None,
    max_iterations: int | None = None,
    trace_table=None,
) -> TraceResult:
    """Trace field lines from a batch of seed states.

    Args:
      grid: UGrid with the field stored as point data.
      y0: (B, ndim+nvar) initial positions + extra variable values.
      i_field: sequence of ndim point-data indices of the field
        components to trace.
      nvar: number of extra ODE variables (trailing entries of y0).
      sub_int: callback ``(field (ndim,), y (ndim+nvar,)) -> (nvar,)``
        giving the arc-length derivatives of the extra variables
        (integrate_sub_t, :61-74).  Traced into the loop.
      min_dx/max_dx/max_steps/rtol/atol/reverse/axisymmetric: see module
        docstring.
      i_icell_mask/mask_value: integrate only where
        ``icell_data[:, i_icell_mask] == mask_value`` (:1055-1068).
      trace_table: optional prebuilt :func:`build_trace_table` result
        for this (grid, i_field) — reuse it across repeated trace
        calls over the same field; built inline (per call) when None.
      max_iterations: hard cap on RK iterations (the reference loops
        unbounded, :1078); defaults to ``50 * max_steps + 1000``.

    Returns:
      TraceResult with per-trajectory curves, field samples, step
      counts, and boundary codes.
    """
    if max_dx < min_dx:
        raise ValueError("max_dx < min_dx")
    if max_steps < 1:
        raise ValueError("max_steps < 1")
    if (i_icell_mask is None) != (mask_value is None):
        raise ValueError("i_icell_mask and mask_value must be given together")
    ndim = len(tuple(i_field))
    if ndim != grid.ndim:
        raise ValueError(f"i_field has {ndim} entries, grid is {grid.ndim}D")
    if sub_int is None:
        sub_int = _default_sub_int
    if max_iterations is None:
        max_iterations = 50 * max_steps + 1000

    i_field = jnp.asarray(i_field)
    y0 = jnp.asarray(y0)
    if y0.ndim != 2 or y0.shape[1] != ndim + nvar:
        raise ValueError(f"y0 must have shape (B, {ndim + nvar})")
    dtype = grid.dtype
    y0 = y0.astype(dtype)
    shrink_eps = _shrink_eps(dtype)

    b = y0.shape[0]

    # The iteration body works in ROW layout (D, B): per-component
    # rows keep the RK glue elementwise over the batch.
    def pad3(r_nd):
        """(ndim, B) rows -> (3, B) with zero-filled unused coords."""
        if ndim == 3:
            return r_nd
        return jnp.concatenate(
            [r_nd, jnp.zeros((3 - ndim, b), dtype=dtype)], axis=0
        )

    def clamp_axi(r3):
        if axisymmetric:
            return jnp.concatenate(
                [jnp.maximum(r3[0:1], MIN_RADIUS), r3[1:]], axis=0
            )
        return r3

    def unitvec(field):
        """(3, B) field rows -> (ndim, B) unit-vector rows.

        The norm is guarded by ``tiny``: a zero interpolated field
        (stagnation point / zero-initialized variable) would otherwise
        yield NaN derivatives and a lane that neither accepts nor
        terminates, spinning the whole batch to max_iterations.  With
        k = 0 the lane steps in place, accepts, and finishes through
        the buffer-overflow path (BM_NOT_REACHED) — the reference has
        no defined behavior here (it divides by zero, :1199)."""
        u = field[:ndim] / jnp.maximum(
            jnp.sqrt(
                field[0] * field[0] + field[1] * field[1]
                + field[2] * field[2]
            ),
            _tiny,
        )
        return -u if reverse else u

    sub_int_b = jax.vmap(sub_int)  # user callback stays per-point

    def boundary_code(ic):
        """-1 for a physical boundary, else the mask value of the cell
        that ended the trace (:1086-1096)."""
        if i_icell_mask is None:
            return jnp.full_like(ic, -1)
        masked = grid.icell_data[jnp.maximum(ic, 0), i_icell_mask]
        return jnp.where(ic < 0, -1, masked.astype(jnp.int32))

    if trace_table is None:
        trace_table = build_trace_table(grid, i_field)
    nf = grid.n_faces_per_cell
    npc = grid.n_points_per_cell
    _cp_off = nf * 5
    _vol_off = _cp_off + npc * 3
    _fv_off = _vol_off + 1

    from .utils.config import tiny_distance

    _tiny = tiny_distance(dtype)

    def rk_stage(anchor, k_prev, coeff, r_start, ic_start, ok):
        """One batched walk+interpolate sub-step (row interface,
        column-major internally at the walk/interp boundaries).  Lanes
        with ``ok`` False aim at their own start, making the walk a
        degenerate no-op (tiny-distance short
        circuit, :689-692).  The walk starts from the *previous
        sub-step's* end point and cell (the reference threads i_cell
        between sub-steps the same way, :1122-1150) — sub-step targets
        are ~0.25*dx apart, so carried starts walk far fewer faces than
        restarting from the anchor.  After the walk, ONE fused-row
        gather yields geometry + field vertex values for the
        interpolation.

        anchor (D, B), k_prev (D, B), r_start (3, B) rows; returns
        (ys (D, B), field (3, B), k (D, B), ic, r_p (3, B), tgt (3, B),
        failed, capped) — ``capped`` flags failures that are walk
        step-cap artifacts, not boundary/mask stops."""
        ys = anchor + coeff[None, :] * k_prev
        r3 = clamp_axi(pad3(ys[:ndim]))
        tgt = jnp.where(ok[None, :], r3, r_start)
        tgt_c = tgt.T
        ic, r_p, _, st = locate.walk(
            grid,
            r_start.T,
            tgt_c,
            ic_start,
            max_steps=grid.config.trace_walk_max_steps,
            i_icell_mask=i_icell_mask,
            table=trace_table,
        )
        failed = ok & (st != 0)
        capped = ok & (st == locate.STATUS_STEP_CAP)
        g = trace_table[jnp.maximum(ic, 0)]
        cp = g[:, _cp_off:_vol_off].reshape(-1, npc, 3)
        vol = g[:, _vol_off]
        w = interp._weights_from_geometry(grid.cell_type, cp, vol, tgt_c)
        vv = g[:, _fv_off : _fv_off + npc * ndim].reshape(-1, npc, ndim)
        field = pad3((w[:, :, None] * vv).sum(axis=1).T)
        k = jnp.concatenate(
            [unitvec(field), sub_int_b(field[:ndim].T, ys.T).T], axis=0
        )
        return ys, field, k, ic, r_p.T, tgt, failed, capped

    # ---- initialization (:1045-1073; column-major one-time ops) ----------
    r0_3 = jnp.zeros((b, 3), dtype=dtype).at[:, :ndim].set(y0[:, :ndim])
    ic0, found0 = locate.get_cell(grid, r0_3)
    ic0 = jnp.where(found0, ic0, -1).astype(jnp.int32)
    field0 = interp.interpolate_at_icell(
        grid, r0_3, i_field, jnp.maximum(ic0, 0)
    )
    if mask_value is not None:
        in_region = found0 & (
            grid.icell_data[jnp.maximum(ic0, 0), i_icell_mask] == mask_value
        )
    else:
        in_region = found0
    start_done = ~in_region
    start_bm = jnp.where(
        start_done, boundary_code(ic0), jnp.int32(BM_NOT_REACHED)
    )

    # One scratch row past max_steps swallows masked writes
    y_buf = jnp.zeros((b, max_steps + 1, ndim + nvar), dtype=dtype)
    y_buf = y_buf.at[:, 0, :].set(y0)
    yf_buf = jnp.zeros((b, max_steps + 1, ndim), dtype=dtype)
    yf_buf = yf_buf.at[:, 0, :].set(
        jnp.where(in_region[:, None], field0, 0.0)
    )

    init = _State(
        y_buf=y_buf,
        yf_buf=yf_buf,
        anchor=y0.T,
        field_a=pad3(jnp.where(in_region[:, None], field0, 0.0).T),
        n_idx=jnp.zeros(b, jnp.int32),
        i_cell_prev=ic0,
        dx=jnp.full(b, max_dx, dtype),
        last_rejected=jnp.full(b, -100, jnp.int32),
        iteration=jnp.zeros(b, jnp.int32),
        done=start_done,
        overflow=jnp.zeros(b, bool),
        boundary_material=start_bm,
    )

    # Buffer writes as one-hot selects over the step axis: a per-lane
    # dynamic scatter (.at[rows, idx].set) lowers to a serialized
    # per-row path that costs ~10ms per iteration at 64k lanes — 4x the
    # three walks combined; the masked full-buffer rewrite is
    # bandwidth-bound and ~10x cheaper.  The current anchor state rides
    # the loop carry, so the matching per-lane *gather* disappears
    # entirely.
    #
    # Better still: per iteration every writing lane stores exactly one
    # row, and active lanes advance nearly in lockstep (a lane only
    # falls behind by rejected/failed iterations), so the writer
    # indices span a narrow band.  Rewrite only a W-step window
    # anchored at the minimum writer index (dynamic_slice + in-window
    # one-hot + dynamic_update_slice) — S1/W times less buffer traffic
    # — and fall back to the full rewrite on the rare iteration whose
    # writers span wider than W.
    S1 = max_steps + 1
    W = min(32, S1)
    step_iota = lax.broadcasted_iota(jnp.int32, (1, S1), 1)
    win_iota = lax.broadcasted_iota(jnp.int32, (1, W), 1)

    def write_rows_2(y_buf, yf_buf, idx, write, y_vals, yf_vals):
        lo = jnp.clip(
            jnp.min(jnp.where(write, idx, jnp.int32(S1))), 0, S1 - W
        )
        fits = jnp.max(jnp.where(write, idx, jnp.int32(-1))) < lo + W

        def windowed(bufs):
            yb, fb = bufs
            z = jnp.zeros((), lo.dtype)
            sel = (win_iota + lo == idx[:, None]) & write[:, None]
            ys = lax.dynamic_slice(yb, (z, lo, z), (b, W, yb.shape[2]))
            ys = jnp.where(sel[:, :, None], y_vals[:, None, :], ys)
            yb = lax.dynamic_update_slice(yb, ys, (z, lo, z))
            fs = lax.dynamic_slice(fb, (z, lo, z), (b, W, fb.shape[2]))
            fs = jnp.where(sel[:, :, None], yf_vals[:, None, :], fs)
            fb = lax.dynamic_update_slice(fb, fs, (z, lo, z))
            return yb, fb

        def full(bufs):
            yb, fb = bufs
            sel = (step_iota == idx[:, None]) & write[:, None]
            return (
                jnp.where(sel[:, :, None], y_vals[:, None, :], yb),
                jnp.where(sel[:, :, None], yf_vals[:, None, :], fb),
            )

        return lax.cond(fits, windowed, full, (y_buf, yf_buf))

    def cond(carry):
        it, s = carry
        return jnp.any(~s.done) & (it < max_iterations)

    def body(carry):
        it, s = carry
        act = ~s.done
        anchor = s.anchor  # (ndim+nvar, B) rows
        field_a = s.field_a  # (3, B) rows
        r0 = pad3(anchor[:ndim])
        dx = s.dx

        # k1 reuses the stored field sample (:1109-1115)
        if nvar:
            k1 = jnp.concatenate(
                [unitvec(field_a),
                 sub_int_b(field_a[:ndim].T, anchor.T).T],
                axis=0,
            )
        else:
            k1 = unitvec(field_a)

        ok = act
        _, _, k2, ic2, rp2, tgt2, f2, c2 = rk_stage(
            anchor, k1, 0.5 * dx, r0, s.i_cell_prev, ok
        )
        ok = ok & ~f2
        # Carry the sub-step end point/cell into the next walk (the
        # reference's i_cell threading, :1122-1150); failed/done
        # lanes keep the anchor start, which their degenerate walk
        # ignores
        start3 = jnp.where(ok[None, :], tgt2, r0)
        ics3 = jnp.where(ok, ic2, s.i_cell_prev)
        _, _, k3, ic3, rp3, tgt3, f3, c3 = rk_stage(
            anchor, k2, 0.75 * dx, start3, ics3, ok
        )
        ok = ok & ~f3
        # 3rd-order update + 4th sub-step at the updated point
        # (:1144-1156)
        k123 = (2.0 * k1 + 3.0 * k2 + 4.0 * k3) / 9.0
        start4 = jnp.where(ok[None, :], tgt3, r0)
        ics4 = jnp.where(ok, ic3, s.i_cell_prev)
        ys3, field4, k4, ic4, rp4, _, f4, c4 = rk_stage(
            anchor, k123, dx, start4, ics4, ok
        )
        ok = ok & ~f4

        failed = act & ~ok
        # First failing stage supplies (r_p, i_cell) for the shrink
        r_p = jnp.where(
            f2[None, :], rp2, jnp.where(f3[None, :], rp3, rp4)
        )
        ic_fail = jnp.where(f2, ic2, jnp.where(f3, ic3, ic4))
        cap_fail = jnp.where(f2, c2, jnp.where(f3, c3, c4))

        # Embedded 2nd-order estimate and error norm (:1159-1163)
        y2nd = anchor + dx[None, :] * (
            7.0 * k1 + 6.0 * k2 + 8.0 * k3 + 3.0 * k4
        ) / 24.0
        scales = atol + jnp.maximum(jnp.abs(ys3), jnp.abs(y2nd)) * rtol
        err = jnp.sqrt(jnp.sum(((ys3 - y2nd) / scales) ** 2, axis=0) / 3.0)

        accept = ok & ((err <= 1.0) | (dx < 2.0 * min_dx))

        # ---- failure path: shrink dx to the boundary distance ----
        # Capped at 0.75*dx: when a trajectory hugs a wall the walk
        # fails right at the step end (d_boundary ~ dx) and the (1-eps)
        # factor alone decays dx at ~eps per retry — thousands of
        # futile iterations (the reference's 1e-8 factor would
        # effectively hang there).
        db = r_p - r0
        d_boundary = jnp.sqrt(db[0] * db[0] + db[1] * db[1]
                              + db[2] * db[2])
        dx_fail = jnp.minimum((1.0 - shrink_eps) * d_boundary, 0.75 * dx)
        hit_boundary = failed & (dx_fail < min_dx)

        # ---- accept path: write the new point ----
        n_new = jnp.where(accept, s.n_idx + 1, s.n_idx)
        overflow = accept & (n_new >= max_steps)
        write = accept & ~overflow
        ys_store = clamp_axi(ys3)
        y_buf, yf_buf = write_rows_2(
            s.y_buf, s.yf_buf, n_new, write,
            ys_store.T, field4[:ndim].T,
        )
        anchor_new = jnp.where(write[None, :], ys_store, s.anchor)
        field_new = jnp.where(write[None, :], field4, s.field_a)
        i_cell_prev = jnp.where(accept, ic4, s.i_cell_prev)

        # ---- step-size control (:1178-1188) ----
        last_rejected = jnp.where(
            act & (failed | ~accept), it, s.last_rejected
        )
        max_growth = jnp.where(last_rejected > it - 2, 1.0, 2.0).astype(
            dtype
        )
        dx_factor = jnp.minimum(
            max_growth, SAFETY_FAC * (1.0 / err) ** (1.0 / 3.0)
        )
        dx_ok = jnp.clip(dx * dx_factor, min_dx, max_dx)
        dx_new = jnp.where(failed, dx_fail, dx_ok)
        dx_new = jnp.where(act, dx_new, s.dx)

        done = s.done | hit_boundary | overflow
        bm = jnp.where(
            hit_boundary,
            # A step-cap failure at min_dx is a walk-budget artifact,
            # not a boundary/mask stop — report it distinctly
            jnp.where(
                cap_fail, jnp.int32(BM_STEP_CAP), boundary_code(ic_fail)
            ),
            s.boundary_material,
        )

        return (
            it + 1,
            _State(
                y_buf=y_buf,
                yf_buf=yf_buf,
                anchor=anchor_new,
                field_a=field_new,
                n_idx=jnp.where(write, n_new, s.n_idx),
                i_cell_prev=i_cell_prev,
                dx=dx_new,
                last_rejected=last_rejected,
                iteration=jnp.where(act, it + 1, s.iteration),
                done=done,
                overflow=s.overflow | overflow,
                boundary_material=bm,
            ),
        )

    _, final = lax.while_loop(cond, body, (jnp.int32(0), init))
    # n_steps: points stored; max_steps+1 flags 'boundary not reached
    # before the buffer filled' (:1167-1168)
    n_steps = jnp.where(
        final.overflow, jnp.int32(max_steps + 1), final.n_idx + 1
    )
    return TraceResult(
        y=final.y_buf[:, :max_steps],
        y_field=final.yf_buf[:, :max_steps],
        n_steps=n_steps,
        boundary_material=final.boundary_material.astype(jnp.int32),
        n_iterations=final.iteration,
    )


def write_trace_vtk(result: TraceResult, filename, ndim: int = None,
                    min_points: int = 2):
    """Export traced field lines as VTK polylines (.vtu).

    Each trajectory becomes one VTK_POLY_LINE cell over its valid
    points; extra ODE variables ("var0", ...), the sampled field
    components ("field_0", ...), per-vertex arc index ("step") and the
    trajectory id ("trajectory") ride along as point data.  Beyond the
    reference (iu_write_vtk exports only the grid) — load next to the
    grid's .vtu to visualize traces through the mesh.

    Trajectories storing fewer than ``min_points`` points are omitted.
    The default (2) drops both invalid starts (seed outside the
    mesh/mask — these store only their seed) and legitimate one-point
    traces that hit the boundary on their very first step; the two are
    indistinguishable in a ``TraceResult``.  Pass ``min_points=1`` to
    keep the latter (they render as single-vertex polylines, i.e.
    orphan points — including any invalid starts in the batch).
    """
    import numpy as np

    from .io.vtk import write_vtu_polylines

    y = np.asarray(result.y)
    yf = np.asarray(result.y_field)
    b, max_steps, d = y.shape
    if ndim is None:
        ndim = yf.shape[2]
    # n_steps == max_steps + 1 flags an overflowed buffer (:1167-1168)
    n = np.minimum(np.asarray(result.n_steps), max_steps)
    keep = np.flatnonzero(n >= min_points)
    n = n[keep]

    idx = [ik * max_steps + np.arange(nk) for ik, nk in zip(keep, n)]
    idx = (
        np.concatenate(idx) if idx else np.zeros(0, dtype=np.int64)
    )
    pts = y.reshape(b * max_steps, d)[idx][:, :ndim]
    if ndim < 3:
        pts = np.pad(pts, ((0, 0), (0, 3 - ndim)))
    point_data = {
        f"var{i}": y.reshape(b * max_steps, d)[idx][:, ndim + i]
        for i in range(d - ndim)
    }
    for c in range(yf.shape[2]):
        point_data[f"field_{c}"] = yf.reshape(b * max_steps, -1)[idx][:, c]
    ipoint_data = {
        "trajectory": np.repeat(keep.astype(np.int32), n),
        "step": np.concatenate(
            [np.arange(nk, dtype=np.int32) for nk in n]
        )
        if len(n)
        else np.zeros(0, np.int32),
    }
    write_vtu_polylines(
        filename, pts, np.cumsum(n).astype(np.int32),
        point_data, ipoint_data,
    )
