"""Batched point location: which cell contains each query point?

Batched replacement for the reference's L3 engine
(m_interp_unstructured.f90:272-288, :412-434, :664-786).  The serial
one-query-at-a-time design is inverted into fixed-shape batch ops:

* ``bin_seed``       — O(1) gather from a uniform-grid seed table,
                       replacing the kd-tree cold start (:272-288).
* ``locate_bruteforce`` — exact containment via one (B,3) x (3, C*nf)
                       matmul + min/argmax reduction; used for meshes
                       small enough that all face planes fit comfortably
                       (this is also what the 8-cell benchmark mesh hits).
* ``walk``           — the face-to-face neighbor walk (:664-764) as a
                       ``lax.while_loop`` over the whole batch with an
                       active mask; each step is a handful of gathers and
                       dot products.
* ``get_cell``       — warm-start/cold-start dispatch (:412-434).

All functions are jit-friendly pure functions over (grid, (B,3) queries).
Cells are 0-based; "no cell" is encoded as a negative index. Status codes
follow the reference: 0 = arrived, -1 = left the domain, 1 = icell-mask
value changed (:664-667).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.config import huge_distance, tiny_distance

# Point location needs full input-precision dot products (no reduced-
# precision matmul passes such as TF32) or cells are misassigned near
# faces.
_PRECISION = lax.Precision.HIGHEST

# Walk status codes (parity with :664-667)
STATUS_ARRIVED = 0
STATUS_MASK_CHANGED = 1
STATUS_BOUNDARY = -1
STATUS_STEP_CAP = 2  # bounded-loop extension: cap hit before arrival


def _bin_index(grid, r):
    nbx, nby, nbz = grid.bin_shape
    rel = (r - grid.bin_rmin) * grid.bin_inv_h
    ij = jnp.floor(rel).astype(jnp.int32)
    ij = jnp.clip(ij, 0, jnp.array([nbx - 1, nby - 1, nbz - 1]))
    return (ij[:, 0] * nby + ij[:, 1]) * nbz + ij[:, 2]


def bin_seed(grid, r):
    """Cold-start seed cell for each query: one gather from the
    per-bin nearest-cell table built at load time.

    Args:
      r: (B, 3) query positions.
    Returns:
      (B,) int32 seed cell indices (always valid cells).
    """
    return grid.bin_table[_bin_index(grid, r)]


def _bin_seed_pack(grid, r):
    """Seed cell AND its center in one packed row gather."""
    g = grid.bin_pack[_bin_index(grid, r)]  # (B, 4)
    return g[:, 0].astype(jnp.int32), g[:, 1:4]


def kd_seed(grid, r):
    """Cold-start seed via the exact nearest cell center — the kd-tree
    backend (seed_mode="kdtree"), matching find_nearby_cell_kdtree
    (:272-288) / kdtree2_n_nearest semantics.

    Args:
      r: (B, 3) query positions.
    Returns:
      (B,) int32 seed cell indices.
    """
    from . import kdtree as kdtree_mod

    tree = kdtree_mod.KdTree(
        grid.kd_node_points,
        grid.kd_node_ids,
        grid.n_cells,
        grid.kd_max_depth,
    )
    idx, _ = kdtree_mod.nearest(tree, r)
    return idx


def _containment_margins(grid, r):
    """margins[b, c] = min over faces k of (d[c,k] - r_b . n[c,k]).

    A point is inside cell c iff margins[b, c] >= -eps (inside test of
    :766-786, all faces at once) as one (B, 3) x (3, C*nf) product.
    """
    n_cells, nf = grid.face_offsets.shape
    normals = grid.face_normals.reshape(n_cells * nf, 3)
    scores = jnp.dot(
        r, normals.T, precision=_PRECISION, preferred_element_type=r.dtype
    )  # (B, C*nf)
    margins = grid.face_offsets.reshape(-1)[None, :] - scores
    return margins.reshape(r.shape[0], n_cells, nf).min(axis=-1)


def locate_bruteforce(grid, r, chunk_size: int = 1024):
    """Exact containment over all cells (small meshes).

    Returns (i_cell, found): the most-interior containing cell per query,
    -1 where no cell contains the point.
    """
    eps = grid.config.eps_inside
    b = r.shape[0]
    n_work = grid.face_offsets.size  # C * nf

    def tile(rt):
        margins = _containment_margins(grid, rt)  # (bt, C)
        best = jnp.argmax(margins, axis=1).astype(jnp.int32)
        # max == value at argmax: no take_along_axis row gather
        found = jnp.max(margins, axis=1) >= -eps
        return jnp.where(found, best, -1), found

    # Keep the materialized (tile, C) margin buffer bounded.
    if b * n_work <= (1 << 26) or b <= chunk_size:
        return tile(r)

    pad = (-b) % chunk_size
    rp = jnp.pad(r, ((0, pad), (0, 0)))
    rt = rp.reshape(-1, chunk_size, 3)
    i_cell, found = lax.map(tile, rt)
    return i_cell.reshape(-1)[:b], found.reshape(-1)[:b]


def point_is_inside_cell(grid, r, i_cell):
    """Batched inside test (iu_point_is_inside_cell, :766-786)."""
    ic = jnp.maximum(i_cell, 0)
    normals = grid.face_normals[ic]  # (B, nf, 3)
    offs = grid.face_offsets[ic]  # (B, nf)
    margin = (offs - (normals * r[:, None, :]).sum(-1)).min(axis=-1)
    return (margin >= -grid.config.eps_inside) & (i_cell >= 0)


def walk(grid, r0, r1, ic0, max_steps=None, i_icell_mask=None, table=None):
    """Batched neighbor walk from r0 (inside cell ic0) towards r1.

    Vectorization of iu_get_cell_through_neighbors +
    get_cell_intersection (:664-764): per step, compute the exit face as
    the min positive ray-plane distance over faces whose outward normal
    has positive dot with the direction, hop across it, stop per-query on
    arrival / domain boundary / mask change.

    Args:
      r0, r1: (B, 3) start/end positions.
      ic0: (B,) int32 start cells (must contain r0 for exact parity).
      max_steps: static int step cap (reference walks unbounded, :431).
      i_icell_mask: optional static int; stop when
        icell_data[:, mask] changes vs the start cell (:712-719).
      table: optional packed per-cell row table to gather from instead
        of ``grid.walk_table``; must share its leading
        ``normals | offsets | neighbors`` column layout (the tracer
        passes a fused table whose rows also carry the field's vertex
        values so its interpolation reuses the same gather width).

    Returns:
      ic1: (B,) final cell (negative if walked out of the domain)
      r_p: (B, 3) final position — last face-intersection point when the
        walk stopped early (used by the tracer's boundary shrink, :1084)
      n_steps: (B,) int32 steps taken
      status: (B,) int32 status code
    """
    if max_steps is None:
        max_steps = grid.config.max_walk_steps
    if table is None:
        table = grid.walk_table
    ic0 = jnp.asarray(ic0, jnp.int32)
    dtype = r0.dtype
    tiny = tiny_distance(dtype)
    big = huge_distance(dtype)
    # Forward nudge + arrival band (rationale in the helper's docstring;
    # shared definition: the fused tracer must use the same values)
    from ..utils.config import walk_tolerances

    nudge, eps_arrive = walk_tolerances(dtype, grid.rmin, grid.rmax)

    delta = r1 - r0
    # Explicit component math: jnp.linalg.norm's overflow-safe
    # rescaling adds several extra passes over the (B, 3) array
    total = jnp.sqrt(
        delta[:, 0] ** 2 + delta[:, 1] ** 2 + delta[:, 2] ** 2
    )
    degenerate = total < tiny
    u = delta / jnp.where(degenerate, 1.0, total)[:, None]

    if i_icell_mask is not None:
        mask0 = grid.icell_data[jnp.maximum(ic0, 0), i_icell_mask]
    else:
        mask0 = None

    def cond(state):
        active, n = state[5], state[7]
        return jnp.any(active) & (n < max_steps)

    nf = grid.n_faces_per_cell

    def _face_pick(nbrs, dist_k, i_face):
        """Neighbor + distance of a chosen face via one-hot select
        (take_along_axis would hit the slow gather path)."""
        onehot = (
            lax.broadcasted_iota(jnp.int32, nbrs.shape, 1)
            == i_face[:, None]
        )
        nbr = jnp.sum(jnp.where(onehot, nbrs, 0), axis=1, dtype=jnp.int32)
        return onehot, nbr

    def body(state):
        r_p, ic, prev, dist_left, status, active, steps, n = state
        ics = jnp.maximum(ic, 0)

        # One packed row gather per step: normals | offsets | neighbor
        # ids (| cell points | volume) travel together
        g = table[ics]  # (B, row_width)
        normals = g[:, : nf * 3].reshape(-1, nf, 3)
        offs = g[:, nf * 3 : nf * 4]
        nbrs = g[:, nf * 4 : nf * 5].astype(jnp.int32)  # exact: |id| < 2^24

        # Elementwise multiply-reduce, NOT einsum: a batched (4,3)x(3,)
        # contraction may lower to a batched matmul at reduced
        # precision; the elementwise form fuses and stays full-f32
        pdn = (normals * u[:, None, :]).sum(-1)  # path . n per face
        rpn = (normals * r_p[:, None, :]).sum(-1)
        # Distance along u to each face plane; only faces with pdn > 0
        dist_k = jnp.where(pdn > 0, (offs - rpn) / pdn, big)
        i_face = jnp.argmin(dist_k, axis=1)
        face_dist = jnp.min(dist_k, axis=1)
        onehot1, ic_next = _face_pick(nbrs, dist_k, i_face)

        # A straight ray never re-enters a convex cell, yet float
        # rounding at a grazing face can pick the cell we just left and
        # ping-pong forever (the serial f64 reference rarely meets
        # this; batched f32 hits it constantly).  When the best face
        # leads straight back, take the second-best exit instead.
        backtrack = (ic_next == prev) & (prev >= 0)
        dist_k2 = jnp.where(onehot1, big, dist_k)
        i_face2 = jnp.argmin(dist_k2, axis=1)
        face_dist2 = jnp.min(dist_k2, axis=1)
        _, ic_next2 = _face_pick(nbrs, dist_k2, i_face2)
        face_dist = jnp.where(backtrack, face_dist2, face_dist)
        ic_next = jnp.where(backtrack, ic_next2, ic_next)

        hit = face_dist < 0.5 * big  # some face had pdn > 0
        # Never step backwards: clamp tiny negative grazing distances
        face_dist = jnp.maximum(face_dist, 0.0)

        # Arrival is eps-tolerant, consistent with the inside test: a
        # target within eps_inside PAST the exit face still counts as
        # arrived in the current cell (margin >= -eps there).  The
        # reference's knife-edge `dist < remaining` (:700-704) makes
        # points exactly ON a face a rounding coin-flip between
        # "arrived" and "crossed out of the domain".
        new_dist_left = dist_left - face_dist
        crossing = hit & (new_dist_left > eps_arrive)
        out_of_domain = ic_next < 0
        if mask0 is not None:
            mask_next = grid.icell_data[jnp.maximum(ic_next, 0), i_icell_mask]
            mask_changed = crossing & ~out_of_domain & (mask_next != mask0)
        else:
            mask_changed = jnp.zeros_like(crossing)

        # Advance position to the face intersection (skip if no face hit —
        # the reference would add 1e100 here, :762; we stay put instead).
        # Hops that continue walking overshoot the face by `nudge` so the
        # next cell sees r_p strictly on its side; terminating hops stay
        # exactly on the face (the tracer uses that intersection, :1084).
        continuing = crossing & ~out_of_domain & ~mask_changed
        advance = face_dist + jnp.where(continuing, nudge, 0.0)
        r_p = jnp.where(
            (active & hit)[:, None], r_p + advance[:, None] * u, r_p
        )
        dist_left = jnp.where(
            active & hit, dist_left - advance, dist_left
        )

        new_status = jnp.where(
            crossing & out_of_domain,
            STATUS_BOUNDARY,
            jnp.where(mask_changed, STATUS_MASK_CHANGED, STATUS_ARRIVED),
        )
        status = jnp.where(active, new_status, status)
        prev = jnp.where(active & continuing, ic, prev)
        ic = jnp.where(active & crossing, ic_next, ic)
        steps = steps + active.astype(jnp.int32)
        n_active = active & crossing & ~out_of_domain & ~mask_changed
        return r_p, ic, prev, dist_left, status, n_active, steps, n + 1

    b = r0.shape[0]
    init = (
        r0,
        ic0,
        jnp.full(b, -1, dtype=jnp.int32),  # previous cell (backtrack guard)
        total,
        jnp.zeros(b, dtype=jnp.int32),
        ~degenerate,
        jnp.zeros(b, dtype=jnp.int32),  # per-query step counter
        jnp.array(0, dtype=jnp.int32),
    )
    r_p, ic, _, _, status, still_active, n_steps, _ = lax.while_loop(
        cond, body, init
    )
    status = jnp.where(still_active, STATUS_STEP_CAP, status)
    return ic, r_p, n_steps, status


def _walk_origin(grid, starts):
    """Cell centers of ``starts`` (walk origins, :429) via ONE packed
    walk-table row gather — the vertex block lives at columns
    [nf*5, nf*5 + npc*3) of each 512 B row."""
    nf = grid.n_faces_per_cell
    npc = grid.n_points_per_cell
    if grid.walk_table is None:
        return grid.cell_points[starts].mean(axis=1)
    cp = grid.walk_table[starts][:, nf * 5 : nf * 5 + npc * 3]
    return cp.reshape(-1, npc, 3).mean(axis=1)


def _found_of(ic, status):
    return (status == STATUS_ARRIVED) & (ic >= 0)


def _cand_bin_index(grid, r):
    return _cand_bin_index_t(grid, r.T)


def _cand_bin_ijk_t(grid, r_t):
    """Clipped integer bin coordinates of TRANSPOSED queries (3, B)."""
    nbx, nby, nbz = grid.cand_shape
    shape = (nbx, nby, nbz)
    return [
        jnp.clip(
            jnp.floor(
                (r_t[d] - grid.cand_rmin[d]) * grid.cand_inv_h[d]
            ).astype(jnp.int32),
            0,
            shape[d] - 1,
        )
        for d in range(3)
    ]


def _cand_bin_flat(grid, ijk):
    """Flat candidate-bin index from integer coordinates — THE encode
    (inverse: geometry.cand_bin_decode; the packers' bin-local frame
    requires every site to agree on the axis order)."""
    _, nby, nbz = grid.cand_shape
    return (ijk[0] * nby + ijk[1]) * nbz + ijk[2]


def _cand_bin_index_t(grid, r_t):
    """Candidate-bin index from TRANSPOSED queries (3, B): three (B,)
    component computations."""
    return _cand_bin_flat(grid, _cand_bin_ijk_t(grid, r_t))


def _cand_local_t(grid, r_t, ijk):
    """(idx, r_local) for the quantized probe: bin index plus queries
    in the bin-local frame (bin centers via the shared
    geometry.cand_bin_center_cols definition, bitwise-matching the
    packer's)."""
    from . import geometry as geometry_mod

    cx, cy, cz = geometry_mod.cand_bin_center_cols(
        grid.cand_rmin, grid.cand_inv_h, ijk[0], ijk[1], ijk[2]
    )
    return jnp.stack([r_t[0] - cx, r_t[1] - cy, r_t[2] - cz])


def _compact_indices(mask, m):
    """Indices of set lanes of ``mask`` (B,) -> (m,), all included when
    the set count fits m.

    top_k on descending-index keys: set lanes get distinct positive
    keys, the largest are the lowest set indices; it needs no scatter.
    Large batches split into ~1M-lane chunks with a per-chunk quota
    (several small top_k calls instead of one over the whole batch); if
    any chunk's set count exceeds its quota — pathologically clustered
    misses — a guard falls back to the exact global top_k.  Neither
    choice has been re-measured on the GPU against a cumsum/scatter
    compaction.  Padding slots alias lane B-1; callers must re-mask
    with ``mask[idx]`` (a duplicated SET lane is harmless — its merge
    writes are idempotent).
    """
    b = mask.shape[0]
    keys = jnp.where(mask, b - jnp.arange(b, dtype=jnp.int32), 0)

    def global_topk(_):
        top, _t = lax.top_k(keys, min(m, b))
        idx = jnp.minimum(b - top, b - 1)
        if m > b:
            idx = jnp.pad(idx, (0, m - b), constant_values=b - 1)
        return idx

    ch = 1 << 20
    n_ch = -(-b // ch)
    q = (m // n_ch) // 8 * 8
    if n_ch < 2 or m >= b or q < 8:
        return global_topk(None)

    keys2 = jnp.pad(keys, (0, n_ch * ch - b)).reshape(n_ch, ch)
    counts = jnp.sum((keys2 > 0).astype(jnp.int32), axis=1)

    def chunked(_):
        outs = []
        for c in range(n_ch):
            top, _t = lax.top_k(keys2[c], q)
            outs.append(top)
        idx = jnp.minimum(b - jnp.concatenate(outs), b - 1)
        return jnp.pad(idx, (0, m - n_ch * q), constant_values=b - 1)

    return lax.cond(jnp.all(counts <= q), chunked, global_topk, None)


def _compacted_fallback(active, m, per_lane, merge_scatter, merge_full,
                        state):
    """Shared dispatch for the compacted recovery paths
    (_candidates_query and _get_cell_warm — ONE definition of the
    subtle machinery so a fix in one site cannot silently miss the
    other; the round-3 zero-miss guard did exactly that).  get_cell's
    phase-2 straggler dispatch stays separate on purpose: its full
    path is a single full-batch walk resume (walk gathers are per-row
    regardless, so there is no b-wide row materialization to avoid and
    full-batch walk rounds amortize better than m-chunked ones).

    * zero active lanes: return ``state`` untouched — the fallback
      costs full-batch passes even when it recovers nothing;
    * <= m active: stable compaction into an m-slot buffer
      (_compact_indices; padding slots alias lane b-1 and merge
      idempotently because per-lane outputs are deterministic), then
      ``merge_scatter(state, idx, keep, outs)``;
    * > m active (clustered/adversarial batches): contiguous m-wide
      slices through one sequential ``lax.map`` — per-lane row gathers
      never materialize b-wide buffers — restitched to full width,
      then ``merge_full(state, outs)``.

    ``per_lane(idx, keep) -> pytree`` of (m,)- or (c, m)-shaped
    arrays, each already masked by ``keep`` where it matters.
    """
    b = active.shape[0]
    n_act = jnp.sum(active.astype(jnp.int32))

    def small_path(state):
        idx = _compact_indices(active, m)
        return merge_scatter(state, idx, active[idx],
                             per_lane(idx, active[idx]))

    def full_path(state):
        pad_b = -(-b // m) * m
        idxs = jnp.arange(pad_b, dtype=jnp.int32).reshape(-1, m)
        act_p = jnp.pad(active, (0, pad_b - b))

        def body(idx):
            safe = jnp.minimum(idx, b - 1)
            return per_lane(safe, act_p[idx])

        def restitch(o):
            # (n_iter, m) -> (b,); (n_iter, c, m) -> (c, b)
            if o.ndim == 2:
                return o.reshape(-1)[:b]
            return jnp.moveaxis(o, 1, 0).reshape(o.shape[1], -1)[:, :b]

        outs = jax.tree.map(restitch, lax.map(body, idxs))
        return merge_full(state, outs)

    return lax.cond(
        n_act == 0,
        lambda s: s,
        lambda s: lax.cond(n_act <= m, small_path, full_path, s),
        state,
    )


def _quad_weights_c(px, py, pz, rx, ry, rz):
    """Inverse-bilinear quad weights on twelve (B,) vertex-component
    arrays.  The arithmetic is the single shared definition in
    ops/wkern.py (:588-641)."""
    from . import wkern

    v = [[px[k], py[k], pz[k]] for k in range(4)]
    return tuple(
        wkern.quad_weights_generic(v, (rx, ry, rz), wkern.Plain(rx.dtype))
    )


def _probe_rows_xla(grid, g, rt_t, k, count_col, var_slots, eps,
                    ovf_base, quantized=False, nv_fused=0,
                    df_planes=False):
    """XLA candidate-row probe over gathered rows ``g = tab[idx]``.
    It serves every layout; on the GPU the quantized simplex rows go
    to ops/pallas_cand.py instead, with identical semantics.  All
    per-tile math runs TRANSPOSED — (k, bt) slices of the rows, queries
    as (3, bt).

    Returns (id_best (bt,), aux (bt,), valsT (n_vals, bt)) with the
    aux encoding: -2 = id_best contains the query, >= 0 =
    overflow-bin miss (value = extension slot / residual flag),
    -1 = exact miss."""
    nf = grid.n_faces_per_cell
    npc = grid.n_points_per_cell
    is_quad = grid.cell_type == "quad"
    s_n = -(-3 * nf // 2)
    s_d = -(-nf // 2)
    if df_planes:
        id_role = s_n + s_d + 8 * nv_fused
        quantized = True  # the probe geometry is the quantized layout
    elif quantized:
        id_role = s_n + s_d + 4 * nv_fused
    else:
        id_role = 4 * nf + (3 * npc if is_quad else 0)
    data_role0 = id_role + 1
    bt = rt_t.shape[1]
    gT = g.T  # (W, bt): one transpose per tile, then row slices

    def role(j):  # (k, bt) block of role j
        return gT[j * k : (j + 1) * k]

    rx, ry, rz = rt_t[0], rt_t[1], rt_t[2]
    m_faces = []
    margins = None
    if quantized:
        # int16-quantized probe in the bin-local frame (layout and
        # semantics: models/grid._pack_qcand_rows_jit — rt_t here is
        # r_local)
        inv = jnp.float32(1.0 / 32767.0)
        ds = gT[count_col + 1]  # (bt,) per-row dscale

        def unpack(j):
            w = lax.bitcast_convert_type(role(j), jnp.int32)
            # jnp shifts keep int32 under x64; >> on signed ints is
            # arithmetic (sign-extended int16 halves)
            lo = jnp.right_shift(jnp.left_shift(w, 16), 16)
            hi = jnp.right_shift(w, 16)
            return lo.astype(jnp.float32), hi.astype(jnp.float32)

        comps = []
        for s in range(s_n):
            comps.extend(unpack(s))
        dcomps = []
        for s in range(s_d):
            dcomps.extend(unpack(s_n + s))
        idv = role(id_role)
        for f in range(nf):
            proj = (
                comps[3 * f] * rx
                + comps[3 * f + 1] * ry
                + comps[3 * f + 2] * rz
            ) * inv
            mf = dcomps[f] * ds - proj
            m_faces.append(mf)
            margins = mf if margins is None else jnp.minimum(margins, mf)
        margins = jnp.where(idv < 0, jnp.float32(-1e30), margins)
    else:
        for f in range(nf):
            proj = (
                role(f) * rx + role(nf + f) * ry + role(2 * nf + f) * rz
            )
            mf = role(3 * nf + f) - proj
            m_faces.append(mf)
            margins = mf if margins is None else jnp.minimum(margins, mf)
    k_best = jnp.argmax(margins, axis=0)  # (bt,)
    m_best = jnp.max(margins, axis=0)
    onehot = (
        lax.broadcasted_iota(jnp.int32, (k, bt), 0) == k_best[None, :]
    )

    def pick(x):  # winner extraction over the k rows
        return jnp.sum(jnp.where(onehot, x, 0), axis=0)

    id_best = pick(role(id_role)).astype(jnp.int32)
    cnt = gT[count_col].astype(jnp.int32)
    found = (m_best >= -eps) & (id_best >= 0)
    ovf_miss = (~found) & (cnt > ovf_base) & (id_best >= 0)
    aux = jnp.where(
        found, -2, jnp.where(ovf_miss, cnt - (ovf_base + 1), -1)
    )
    if var_slots is None:
        return id_best, aux, jnp.zeros((0, bt), rt_t.dtype)

    if df_planes:
        # df32 value planes (grid._pack_qdf_rows_jit): winner's plane
        # picked first, then v = g . r_local + c_loc in compensated
        # f32 with the exact (hi, lo) r_local split (rt_t rows 3..5)
        from . import df32

        rl = [(rt_t[d], rt_t[3 + d]) for d in range(3)]
        his, los = [], []
        for slot in var_slots:
            pr = s_n + s_d + 8 * slot
            acc = (pick(role(pr + 6)), pick(role(pr + 7)))
            for d in range(3):
                g_d = (pick(role(pr + d)), pick(role(pr + 3 + d)))
                acc = df32.add(acc, df32.mul(g_d, rl[d]))
            his.append(acc[0])
            los.append(acc[1])
        return id_best, aux, jnp.stack(his + los, axis=0)
    if quantized:
        # exact f32 per-cell value planes: value = g . r_local + c
        vals = []
        for slot in var_slots:
            pr = s_n + s_d + 4 * slot
            vals.append(
                pick(
                    role(pr) * rx + role(pr + 1) * ry
                    + role(pr + 2) * rz + role(pr + 3)
                )
            )
        return id_best, aux, jnp.stack(vals, axis=0)
    if is_quad:
        vrole = 4 * nf
        px = [pick(role(vrole + v * 3 + 0)) for v in range(npc)]
        py = [pick(role(vrole + v * 3 + 1)) for v in range(npc)]
        pz = [pick(role(vrole + v * 3 + 2)) for v in range(npc)]
        w = _quad_weights_c(px, py, pz, rx, ry, rz)
        vals = []
        for slot in var_slots:
            dr = data_role0 + slot * npc
            vals.append(
                sum(w[v] * pick(role(dr + v)) for v in range(npc))
            )
    else:
        # barycentric straight from margins for ALL candidates, winner
        # picked last: the packed data of vertex v is PREMULTIPLIED by
        # its inverse height at build time (_pack_cand_rows_jit)
        vals = []
        for slot in var_slots:
            dr = data_role0 + slot * npc
            acc = m_faces[1 % npc] * role(dr)
            for v in range(1, npc):
                acc = acc + m_faces[(v + 1) % npc] * role(dr + v)
            vals.append(pick(acc))
    return id_best, aux, jnp.stack(vals, axis=0)


def _cand_chunk(grid, table=None) -> int:
    """Per-chunk query count for the candidate probe.

    Sized so the gathered rows (chunk * physical row bytes) stay near
    IUConfig.cand_chunk_bytes: 1 KB rows chunk at 64k queries, 2 KB
    cover rows at 32k.  Rounded to an 8k multiple;
    ``config.cand_chunk_queries`` overrides.  ``table`` selects which
    packed table's row width sizes the chunk (default: the plain
    candidate table; the accurate-mode df-plane path passes its wider
    ``cand_df_table``)."""
    cfg = grid.config
    if cfg.cand_chunk_queries is not None:
        return cfg.cand_chunk_queries
    tab = grid.cand_table if table is None else table
    row_b = tab.shape[1] * jnp.dtype(tab.dtype).itemsize
    return max(1 << 13, (cfg.cand_chunk_bytes // row_b) >> 13 << 13)


def _chunked_cols(tile_fn, rt, b, chunk):
    """Drive a per-tile probe over column chunks of ``rt``.

    ``rt`` is (nrows, B) — queries stay TRANSPOSED through the
    candidate path, so chunks are contiguous column slices;
    ``tile_fn(rt_chunk) -> (ids, aux, valsT)`` with valsT (nv, chunk).
    <= 32 chunks unroll (XLA's scheduler may overlap one chunk's row
    gather with another's probe); larger batches run one sequential
    ``lax.map``.
    """
    if b <= chunk:
        return tile_fn(rt)
    pad = (-b) % chunk
    rp = jnp.pad(rt, ((0, 0), (0, pad)))
    n_ch = rp.shape[1] // chunk
    if n_ch <= 32:
        outs = [
            tile_fn(rp[:, i * chunk : (i + 1) * chunk])
            for i in range(n_ch)
        ]
        id_best = jnp.concatenate([o[0] for o in outs])[:b]
        aux = jnp.concatenate([o[1] for o in outs])[:b]
        valsT = jnp.concatenate([o[2] for o in outs], axis=1)[:, :b]
        return id_best, aux, valsT
    id_best, aux, valsT = lax.map(
        tile_fn, jnp.moveaxis(rp.reshape(rt.shape[0], -1, chunk), 1, 0)
    )
    id_best = id_best.reshape(-1)[:b]
    aux = aux.reshape(-1)[:b]
    # explicit target shape: reshape(-1) breaks on the 0-wide
    # no-values case (var_slots is None)
    valsT = jnp.moveaxis(valsT, 1, 0).reshape(
        valsT.shape[1], rp.shape[1]
    )[:, :b]
    return id_best, aux, valsT


def _candidates_query(grid, r, var_slots=None, max_steps=None):
    """Cold containment (+ optionally interpolation) via per-bin
    candidate rows: ONE wide row gather answers "which cell contains r"
    — and, when ``var_slots`` selects fused variables, the interpolated
    values too — for every query whose bin's complete candidate list
    fits the packed row (the overwhelming majority: ~98% of uniform
    queries on a 1M-cell tet mesh at K=15, counted on CPU).

    This replaces seed-then-walk for cold batches: each walk step is a
    full gather round over the batch, while the candidate row carries
    the face planes (and interpolation payload) of every cell
    intersecting the query's bin, so containment is a branch-free
    elementwise reduction over K candidates.  Queries in overflow bins
    (complete list > K) that match no stored candidate compact into a
    small buffer and probe the bin's EXTENSION row (candidates
    K..K+k_ext, same layout, same probe) — so where the extension covers
    the worst bin, every miss is exact: the point is outside the mesh.
    Only
    grids whose worst bin exceeds K + k_ext (or grids built without
    extension lists) ever fall back to a compacted neighbor walk
    seeded at the most interior candidate.

    Weights for simplices come from the fused per-face inverse heights
    (barycentric: weight of vertex v = margin of face (v+1)%npc times
    its inverse height — equal to the reference's area/volume ratios,
    :529-586, for points inside the cell); quads carry their vertices
    and run the inverse-bilinear kernel (:588-641) on the winner.

    Returns (ic, found, valsT) — valsT is TRANSPOSED (n_vars, B), and
    None when var_slots is.
    """
    cfg = grid.config
    if max_steps is None:
        max_steps = cfg.max_walk_steps
    eps = cfg.eps_inside
    nf = grid.n_faces_per_cell
    npc = grid.n_points_per_cell
    b = r.shape[0]
    k_max = grid.cand_ids.shape[1]
    from ..models.grid import cand_fused_nv

    is_quad = grid.cell_type == "quad"
    from ..models.grid import cand_is_quantized

    quantized = cand_is_quantized(grid.cell_type, grid.dtype, grid.config)
    # The count column sits after the fused data columns whether or not
    # this call reads them — derive it from the physical table layout.
    nv = cand_fused_nv(grid)
    if quantized:
        from ..models.grid import _qcand_floats_per

        count_col = k_max * _qcand_floats_per(grid.cell_type, nv)
        per_cand = _qcand_floats_per(grid.cell_type, nv)
        # int16 rounding makes the stored planes fuzzy within
        # grid.cand_qeps of the true faces; widen the inside tolerance
        # so interior points can never be lost to quantization.
        eps = eps + grid.cand_qeps
    else:
        id_role = 4 * nf + (3 * npc if is_quad else 0)
        data_role0 = id_role + 1
        count_col = k_max * (data_role0 + npc * nv)
        per_cand = data_role0 + npc * nv
    if var_slots is not None and any(v >= nv for v in var_slots):
        raise ValueError("var_slots outside the fused variable range")

    from . import pallas_cand

    use_kernel = pallas_cand.supported(grid, jax.default_backend())

    def probe(tab, idx, rt_t, k, ccol, ovf_base):
        """Probe rows ``tab[idx]``: containment verdict + fused values;
        queries arrive TRANSPOSED (3, bt).  Returns (id_best, aux,
        valsT) with _probe_rows_xla's aux encoding: -2 found, >= 0
        overflow miss, -1 exact miss."""
        if use_kernel:
            # Empty/None slots yield a (0, bt) vals array (never None
            # — the chunk driver concatenates the outputs)
            return pallas_cand.cand_rows_query(
                grid, tab, idx, rt_t, var_slots or (), ccol,
                eps, ovf_base, k, nv,
            )
        return _probe_rows_xla(
            grid, tab[idx], rt_t, k, ccol, var_slots, eps, ovf_base,
            quantized=quantized, nv_fused=nv,
        )

    def tile_fn(rt_t):
        ijk = _cand_bin_ijk_t(grid, rt_t)
        idx = _cand_bin_flat(grid, ijk)
        # the quantized probe works in the bin-local frame
        rq_t = _cand_local_t(grid, rt_t, ijk) if quantized else rt_t
        return probe(
            grid.cand_table, idx, rq_t, k_max, count_col, k_max,
        )

    # ONE (B, 3) -> (3, B) transpose up front; per-chunk column slices
    # are contiguous.  The XLA probe tiles big batches so its gathered
    # rows stay bounded in device memory; the kernel gathers nothing
    # and takes the batch whole.
    r_t = r.T  # the fallback below re-gathers from it
    id_best, aux, valsT = _chunked_cols(
        tile_fn, r_t, b, b if use_kernel else _cand_chunk(grid)
    )

    found = aux == -2
    # aux >= 0 marks overflow-bin misses (value = extension-table
    # slot); a miss in a NON-overflow bin (aux == -1) is exact: the
    # point is outside the mesh.
    need_fb = aux >= 0
    ic = jnp.where(found, id_best, -1)
    if grid.cand_ext_table is None and grid.cand_ext_covers:
        # Cover-all grids (every bin's complete list fits its row,
        # IUConfig.cand_cover_row_bytes): a phase-0 miss is exact, so
        # no fallback machinery enters the graph at all — no miss
        # compaction, no extension probe, no merge scatters.
        return ic, found, valsT if var_slots is not None else None
    # Values stay TRANSPOSED (nv, B) through the fallback and out the
    # return, the layout the probe produces them in.
    values = valsT if var_slots is not None else None

    def walk_and_interp(idx, active):
        """Walk the selected queries from their best candidate's center
        (finished lanes walk degenerately: r0 == r1)."""
        starts = jnp.maximum(id_best[idx], 0)
        r0 = jnp.where(
            active[:, None], _walk_origin(grid, starts), r[idx]
        )
        ic_o, _, _, st_o = walk(grid, r0, r[idx], starts, max_steps=max_steps)
        found_o = _found_of(ic_o, st_o) & active
        vals_o = None
        if var_slots is not None:
            from . import interp as interp_mod

            vals_o = interp_mod.interpolate_at_icell(
                grid, r[idx], jnp.asarray(list(var_slots)),
                jnp.maximum(ic_o, 0),
            ).T  # (nv, m)
        return ic_o, found_o, vals_o

    def ext_probe(idx, active):
        """Probe the overflow-extension rows: candidates K..K+k_ext of
        the query's bin, same row layout, same kernel.  Where the
        extension covers the worst bin (cand_ext_covers) a miss here is
        exact; otherwise the rare count > K + k_ext stragglers resume
        with a walk."""
        k_ext = grid.cand_ext_ids.shape[1]
        ext_ccol = k_ext * per_cand
        # aux of an overflow miss IS the extension slot
        slots = jnp.where(active, jnp.maximum(aux[idx], 0), 0)
        # (3, m) subset via three 1-D gathers (cheap; a (m, 3) gather
        # + transpose is not)
        rt_t = jnp.stack([r_t[0][idx], r_t[1][idx], r_t[2][idx]])
        if quantized:
            # ext rows share the query bin's local frame
            rt_t = _cand_local_t(grid, rt_t, _cand_bin_ijk_t(grid, rt_t))
        id2, aux2, vals2T = probe(
            grid.cand_ext_table, slots, rt_t, k_ext, ext_ccol,
            k_max + k_ext,
        )
        found2 = (aux2 == -2) & active
        ic2 = jnp.where(found2, id2, -1)
        vals2 = vals2T if var_slots is not None else None
        if not grid.cand_ext_covers:
            # aux2 >= 0: the bin's true count exceeds K + k_ext, so
            # even the extension row didn't hold the complete list
            resid = active & (aux2 >= 0)
            ic_w, found_w, vals_w = walk_and_interp(idx, resid)
            ic2 = jnp.where(found_w, ic_w, ic2)
            found2 = found2 | found_w
            if vals2 is not None:
                vals2 = jnp.where(found_w[None, :], vals_w, vals2)
        return ic2, found2, vals2

    fallback = ext_probe if grid.cand_ext_table is not None else (
        walk_and_interp
    )

    # After the fallback merges, ``found`` is exactly ``ic >= 0`` (ic
    # is -1 wherever nothing contained the point), so the mask is
    # derived at the end instead of scattered alongside ic.
    def merge(args, idx, ic_o, found_o, vals_o):
        ic, values = args
        ic_o = jnp.where(found_o, ic_o, ic[idx])
        ic = ic.at[idx].set(ic_o)
        if values is not None:
            vals_o = jnp.where(found_o[None, :], vals_o, values[:, idx])
            values = values.at[:, idx].set(vals_o)
        return ic, values

    m = -(-max(1024, b // cfg.cand_fallback_divisor) // 8) * 8
    if b <= m or b < cfg.walk_compact_min_batch:
        idx = jnp.arange(b, dtype=jnp.int32)
        ic_o, found_o, vals_o = fallback(idx, need_fb)
        ic = jnp.where(need_fb, jnp.where(found_o, ic_o, -1), ic)
        if values is not None:
            values = jnp.where(found_o[None, :], vals_o, values)
        return ic, ic >= 0, values

    def merge_scatter(args, idx, keep, outs):
        return merge(args, idx, *outs)

    def merge_full(args, outs):
        ic, values = args
        ic_o, found_o, vals_o = outs
        ic = jnp.where(found_o, ic_o, ic)
        if values is not None:
            values = jnp.where(found_o[None, :], vals_o, values)
        return ic, values

    ic, values = _compacted_fallback(
        need_fb, m, fallback, merge_scatter, merge_full, (ic, values)
    )
    if var_slots is None:
        return ic, ic >= 0, None
    return ic, ic >= 0, values


def locate_candidates(grid, r, max_steps=None):
    """Cold containment via per-bin candidate rows (see
    _candidates_query).  Returns (i_cell, found) with get_cell's
    contract."""
    ic, found, _ = _candidates_query(grid, r, None, max_steps)
    return ic, found


def _cand_local_df_t(grid, rt_hi, rt_lo, ijk):
    """(6, B) exact (hi, lo) split of r_local = r - bin_center.

    ``hi = fl(r - c)`` and ``lo`` its error-free residual (two_sum),
    plus any incoming query residual ``rt_lo`` (f64 queries split into
    f32 pairs) — so the df32 plane evaluation sees r_local to full
    f64-grade precision."""
    from . import df32
    from . import geometry as geometry_mod

    cs = geometry_mod.cand_bin_center_cols(
        grid.cand_rmin, grid.cand_inv_h, ijk[0], ijk[1], ijk[2]
    )
    his, los = [], []
    for d in range(3):
        hi, err = df32.two_sum(rt_hi[d], -cs[d])
        if rt_lo is not None:
            err = err + rt_lo[d]
        his.append(hi)
        los.append(err)
    return jnp.stack(his + los)


def _candidates_query_df(grid, r, var_slots, r_lo=None):
    """Accurate-mode fused cold query: ONE gather from the df-plane
    candidate rows (grid.cand_df_table) answers containment AND
    ~1e-13 interpolation.

    Only built for simplex COVER grids (grid.cand_df_supported), so a
    probe miss is exact — no fallback machinery enters the graph.

    Returns (ic, found, vals_hi (nv, B), vals_lo (nv, B)); missed
    queries carry their best candidate's plane values with found
    False (callers fill).
    """
    cfg = grid.config
    from ..models.grid import _qdf_floats_per, cand_fused_nv

    nv = cand_fused_nv(grid)
    if any(v >= nv for v in var_slots):
        raise ValueError("var_slots outside the fused variable range")
    k_max = grid.cand_ids.shape[1]
    per = _qdf_floats_per(grid.cell_type, nv)
    count_col = k_max * per
    eps = cfg.eps_inside + grid.cand_qeps
    b = r.shape[0]
    nsel = len(var_slots)

    r6 = jnp.concatenate(
        [r.T, (r_lo.T if r_lo is not None else jnp.zeros_like(r.T))],
        axis=0,
    )  # (6, B): query hi rows + residual rows

    def tile_fn(rt6):
        ijk = _cand_bin_ijk_t(grid, rt6[:3])
        idx = _cand_bin_flat(grid, ijk)
        rq6 = _cand_local_df_t(grid, rt6[:3], rt6[3:], ijk)
        return _probe_rows_xla(
            grid, grid.cand_df_table[idx], rq6, k_max, count_col,
            var_slots, eps, k_max, quantized=True, nv_fused=nv,
            df_planes=True,
        )

    id_best, aux, valsT = _chunked_cols(
        tile_fn, r6, b, _cand_chunk(grid, grid.cand_df_table)
    )

    found = aux == -2
    ic = jnp.where(found, id_best, -1)
    return ic, found, valsT[:nsel], valsT[nsel:]


def _get_cell_warm(grid, r, guess, max_steps):
    """Warm-start location on candidate-table grids.

    The one-gather candidate path answers every query in one probe,
    while a guess-seeded walk needs a gather round per face crossed
    (the bench's advected warm batch still crosses a face for ~65% of
    lanes on a 1M-cell mesh, so a "did it stay put" pretest round does
    not pay).  The guess still buys reference parity where it matters:
    candidate MISSES with a guess replay the reference walk from the
    guess cell (iu_get_cell_through_neighbors, :664-725) on a small
    compacted buffer, so off-domain queries report the boundary code
    of the face that walk exits through (:712-719) instead of a bare
    "not found".
    """
    cfg = grid.config
    b = r.shape[0]
    guess = jnp.asarray(guess, jnp.int32)
    # Out-of-range guesses fall back to a cold start (the reference
    # error-stops on guess > n_cells, :490)
    guess = jnp.where(guess >= grid.n_cells, -1, guess)

    ic, found, _ = _candidates_query(grid, r, None, max_steps)
    miss = ~found & (guess >= 0)

    def recover(idx, active):
        starts = jnp.maximum(guess[idx], 0)
        r0 = jnp.where(
            active[:, None], _walk_origin(grid, starts), r[idx]
        )
        ic_w, _, _, st_w = walk(
            grid, r0, r[idx], starts, max_steps=max_steps
        )
        found_w = _found_of(ic_w, st_w) & active
        code = jnp.where(found_w, ic_w, jnp.minimum(ic_w, -1))
        return code, found_w

    m = -(-max(1024, b // cfg.cand_fallback_divisor) // 8) * 8
    if b <= m or b < cfg.walk_compact_min_batch:
        idx = jnp.arange(b, dtype=jnp.int32)
        code, found_w = recover(idx, miss)
        ic = jnp.where(miss, code, ic)
        return ic, found | found_w

    def merge_scatter(args, idx, keep, outs):
        ic, found = args
        code, found_w = outs
        ic = ic.at[idx].set(jnp.where(keep, code, ic[idx]))
        found = found.at[idx].set(found[idx] | found_w)
        return ic, found

    def merge_full(args, outs):
        ic, found = args
        code, found_w = outs
        return jnp.where(miss, code, ic), found | found_w

    return _compacted_fallback(
        miss, m, recover, merge_scatter, merge_full, (ic, found)
    )


def _resume_walk(grid, r_p, r1, ic, active, max_steps):
    """Continue interrupted walks from their current position.

    Finished queries get a degenerate r0 == r1 walk (the tiny-distance
    short circuit, :689-692), so one batched call resumes exactly the
    active subset; the merged (ic, found) is correct for both kinds.
    """
    r0 = jnp.where(active[:, None], r_p, r1)
    ic_o, rp_o, _, st_o = walk(grid, r0, r1, ic, max_steps=max_steps)
    return ic_o, rp_o, st_o


def get_cell(grid, r, guess=None, max_steps=None):
    """Find the cell containing each query point (iu_get_cell, :412-434).

    Warm start: where ``guess >= 0`` the walk starts from the guess cell's
    center; otherwise from the cold-start seed.  In ``bruteforce`` mode
    the guess is irrelevant — containment is computed exactly in one shot.

    Large batches walk in two phases: a few full-batch rounds resolve
    the vast majority of queries (seeds are at most a bin away), then
    the stragglers are compacted into a batch//divisor buffer so the
    tail rounds stop paying full-batch gather cost.

    Returns (i_cell, found): i_cell is -1 (or the off-domain neighbor
    code) where the point is in no cell.
    """
    if grid.locate_mode == "bruteforce":
        return locate_bruteforce(grid, r)

    cfg = grid.config
    if max_steps is None:
        max_steps = cfg.max_walk_steps

    if guess is None and grid.cand_table is not None:
        # Pure cold batch: one-gather candidate containment
        return locate_candidates(grid, r, max_steps=max_steps)

    if guess is not None and grid.cand_table is not None:
        return _get_cell_warm(grid, r, guess, max_steps)

    use_kd = (
        grid.config.seed_mode == "kdtree" and grid.kd_node_points is not None
    )
    if guess is None and not use_kd and grid.bin_pack is not None:
        # Pure cold start: id + walk origin in one 16B-row gather
        start, r0 = _bin_seed_pack(grid, r)
    else:
        cold = kd_seed if use_kd else bin_seed
        if guess is None:
            start = cold(grid, r)
        else:
            # Out-of-range guesses fall back to a cold start (the
            # reference error-stops on guess > n_cells, :490; under jit
            # a graceful reseed is the batch-friendly equivalent)
            guess = jnp.where(guess >= grid.n_cells, -1, guess)
            start = jnp.where(guess >= 0, guess, cold(grid, r))
        r0 = _walk_origin(grid, jnp.maximum(start, 0))

    b = r.shape[0]
    p1 = min(cfg.walk_phase1_steps, max_steps)
    if b < cfg.walk_compact_min_batch or max_steps <= p1:
        ic, _, _, status = walk(grid, r0, r, start, max_steps=max_steps)
        found = _found_of(ic, status)
        return jnp.where(found, ic, jnp.minimum(ic, -1)), found

    # Phase 1: full batch, few rounds
    ic1, rp1, _, st1 = walk(grid, r0, r, start, max_steps=p1)
    active = st1 == STATUS_STEP_CAP
    found1 = _found_of(ic1, st1)
    remaining = max_steps - p1
    m = -(-max(1024, b // cfg.walk_compact_divisor) // 8) * 8

    def small_path(args):
        ic1, rp1, active, found1 = args
        # Stable compaction of active query ids into m slots
        idx = _compact_indices(active, m)
        act_s = active[idx]
        ic_o, _, st_o = _resume_walk(
            grid, rp1[idx], r[idx], ic1[idx], act_s, remaining
        )
        found_o = _found_of(ic_o, st_o)
        # Duplicate idx entries (slots past the active count alias
        # lane B-1) scatter identical values — deterministic
        return (
            ic1.at[idx].set(ic_o),
            found1.at[idx].set(found_o),
        )

    def full_path(args):
        ic1, rp1, active, found1 = args
        ic_o, _, st_o = _resume_walk(grid, rp1, r, ic1, active, remaining)
        return ic_o, _found_of(ic_o, st_o)

    n_act = jnp.sum(active.astype(jnp.int32))
    # Zero-straggler fast branch: skip the compacted tail entirely when
    # phase 1 resolved the whole batch (seeds are at most a bin away,
    # so this is the common case on conforming meshes)
    ic, found = lax.cond(
        n_act == 0,
        lambda args: (args[0], args[3]),
        lambda args: lax.cond(n_act <= m, small_path, full_path, args),
        (ic1, rp1, active, found1),
    )
    return jnp.where(found, ic, jnp.minimum(ic, -1)), found
