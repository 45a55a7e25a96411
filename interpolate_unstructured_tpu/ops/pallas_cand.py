"""Candidate-row probe as a Pallas kernel on the Triton route (GPU).

The cold-locate candidate path answers containment — and the fused
interpolation — from one packed row per query.  Its XLA twin
(ops.locate._probe_rows_xla) consumes a gathered ``tab[idx]`` buffer:
``chunk x W`` floats, 1-2 KB per query.  This kernel reads each
query's row straight from the table in device memory: each program
owns ``block`` queries, loads their row indices, and gathers the row
role by role (K candidate columns, padded to a power of two) into
registers.  No gathered buffer is written or read back.

Covered layout: QUANTIZED f32 simplex rows (triangle / tetra,
``IUConfig.cand_quantized``; models/grid._pack_qcand_rows_jit), for the
main and the overflow-extension tables::

    [qn pairs | qd pairs | (gx gy gz c) * nv | id] * K | count | dscale

with role j of candidate k at column ``j*K + k``.  ``r`` carries
r_local = r - bin_center (ops.locate._cand_local_t).  Quad rows,
unquantized f32 rows, f64 grids and the accurate-mode df-plane rows
stay on ``_probe_rows_xla``.

Only elementwise multiply-adds and reductions: no ``pl.dot``, so no
product can drop to TF32.  Semantics match ``_probe_rows_xla`` exactly
(m_interp_unstructured.f90:766-786 containment); the arg-max takes the
first of equal margins, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Queries per program and the launch shape.  A (block, KP) role tile of
# 128 x 64 f32 spreads over 256 threads at 32 values each.
BLOCK = 128
NUM_WARPS = 8
NUM_STAGES = 1


def supported(grid, platform: str) -> bool:
    """Whether the kernel serves this grid's candidate probe on
    ``platform`` (a ``jax.Device.platform`` string, passed in by the
    caller so tests can exercise the choice without a GPU)."""
    from ..models.grid import cand_is_quantized

    return platform == "gpu" and cand_is_quantized(
        grid.cell_type, grid.dtype, grid.config
    )


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _kernel(idx_ref, rx_ref, ry_ref, rz_ref, tab_ref, ic_ref, aux_ref,
            *vals_refs, nf, k, kp, width, var_slots, nv_fused, count_col,
            eps, ovf_base):
    i = idx_ref[...]  # (BQ,) row per query
    rows = i[:, None]
    kcol = lax.broadcasted_iota(jnp.int32, (1, kp), 1)
    live = kcol < k

    def role(j):
        # (BQ, KP) columns j*K .. j*K+KP-1 of each query's row; the
        # KP-K overhang reads the next role (masked below) and is
        # clipped to the row so the last role never leaves the table
        cols = jnp.minimum(j * k + kcol, width - 1)
        return tab_ref[rows, cols]

    def unpack(j):  # role j -> its two sign-extended int16 halves
        w = lax.bitcast_convert_type(role(j), jnp.int32)
        # jnp shifts keep int32 under x64; >> on signed ints is
        # arithmetic
        lo = jnp.right_shift(jnp.left_shift(w, 16), 16)
        hi = jnp.right_shift(w, 16)
        return lo.astype(jnp.float32), hi.astype(jnp.float32)

    s_n = -(-3 * nf // 2)
    s_d = -(-nf // 2)
    id_role = s_n + s_d + 4 * nv_fused
    rx = rx_ref[...][:, None]
    ry = ry_ref[...][:, None]
    rz = rz_ref[...][:, None]
    ds = tab_ref[i, count_col + 1][:, None]
    inv = jnp.float32(1.0 / 32767.0)

    comps = []
    for s in range(s_n):
        comps.extend(unpack(s))
    dcomps = []
    for s in range(s_d):
        dcomps.extend(unpack(s_n + s))
    margins = None
    for f in range(nf):
        proj = (
            comps[3 * f] * rx + comps[3 * f + 1] * ry + comps[3 * f + 2] * rz
        ) * inv
        mf = dcomps[f] * ds - proj
        margins = mf if margins is None else jnp.minimum(margins, mf)
    idv = role(id_role)
    margins = jnp.where(live & (idv >= 0), margins, jnp.float32(-1e30))

    m_best = jnp.max(margins, axis=1)
    k_best = jnp.min(
        jnp.where(margins == m_best[:, None], kcol, kp), axis=1
    )
    onehot = kcol == k_best[:, None]

    def pick(x):  # the winner's column, (BQ, KP) -> (BQ,)
        return jnp.sum(jnp.where(onehot, x, 0.0), axis=1)

    id_best = pick(idv).astype(jnp.int32)
    cnt = tab_ref[i, count_col].astype(jnp.int32)
    found = (m_best >= -eps) & (id_best >= 0)
    ovf_miss = (~found) & (cnt > ovf_base) & (id_best >= 0)
    ic_ref[...] = id_best
    aux_ref[...] = jnp.where(
        found, -2, jnp.where(ovf_miss, cnt - (ovf_base + 1), -1)
    )
    for vals_ref, slot in zip(vals_refs, var_slots):
        pr = s_n + s_d + 4 * slot
        val = role(pr) * rx + role(pr + 1) * ry + role(pr + 2) * rz
        vals_ref[...] = pick(val + role(pr + 3))


def cand_rows_query(grid, table, idx, rt_t, var_slots, count_col, eps,
                    ovf_base, k_max, nv_fused, *, block: int = BLOCK,
                    interpret: bool = False):
    """Probe quantized candidate rows ``table[idx]`` without gathering
    them first.

    Args:
      table: (n_rows, W) float32 packed rows (main or extension table).
      idx: (B,) int32 row per query.
      rt_t: (3, B) float32 r_local = r - bin_center, transposed.
      var_slots: fused variable slots to interpolate (may be empty).
      count_col: column of the row's count slot (dscale follows it).
      eps: static inside-test tolerance, quantization fuzz included.
      ovf_base: count above which a missed query is an overflow-bin
        miss (main table: K; extension table: K + k_ext).
      k_max: candidates per row of ``table``.
      nv_fused: fused variables per candidate in the row layout.
      block: queries per program (a power of two).
      interpret: run the kernel body through the Pallas interpreter
        (CPU tests); the GPU runs it compiled.

    Returns (id_best (B,) int32, aux (B,) int32, valsT (len(var_slots),
    B)) with ``_probe_rows_xla``'s aux encoding: -2 = id_best contains
    the query, >= 0 = overflow-bin miss (extension slot / residual
    flag), -1 = exact miss.
    """
    b = idx.shape[0]
    n_out = len(var_slots)
    b_pad = -(-max(b, 1) // block) * block
    if b_pad != b:
        # pads the 16 B/query inputs, never the rows
        idx = jnp.pad(idx, (0, b_pad - b))
        rt_t = jnp.pad(rt_t, ((0, 0), (0, b_pad - b)))
    kernel = functools.partial(
        _kernel,
        nf=grid.n_faces_per_cell,
        k=int(k_max),
        kp=_pow2(k_max),
        width=table.shape[1],
        var_slots=tuple(int(v) for v in var_slots),
        nv_fused=int(nv_fused),
        count_col=int(count_col),
        eps=float(eps),
        ovf_base=int(ovf_base),
    )
    # Every block is 1-D and a power of two, as Triton requires: the
    # query components and the value rows travel as separate arrays.
    vec = pl.BlockSpec((block,), lambda q: (q,))
    i32, f32 = jnp.int32, jnp.float32
    ic, aux, *vals = pl.pallas_call(
        kernel,
        grid=(b_pad // block,),
        in_specs=[vec, vec, vec, vec, pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[vec] * (2 + n_out),
        out_shape=[jax.ShapeDtypeStruct((b_pad,), i32)] * 2
        + [jax.ShapeDtypeStruct((b_pad,), f32)] * n_out,
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="cand_probe",
    )(idx.astype(i32), *rt_t.astype(f32), table)
    valsT = (jnp.stack([v[:b] for v in vals]) if vals
             else jnp.zeros((0, b), f32))
    return ic[:b], aux[:b], valsT
