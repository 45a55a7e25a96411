"""Device-side candidate-bin construction.

Builds the same per-bin candidate lists as
:func:`..ops.geometry.build_candidate_bins` (the host reference
implementation) but on the accelerator: the host pair-expansion loop is
~150 s for a 1M-cell tet mesh on one CPU core, while the device
pipeline is offset-unrolled AABB/face filtering, one stable multi-key
sort, a cummax segment scan, and two scatters.

Pair generation is restructured for fixed shapes: instead of expanding
a ragged (cell, bin) pair list, the kernel loops over the static grid
of bin OFFSETS within a cell's AABB span (span is bounded and small for
near-uniform meshes); offset (i, j, k) contributes one potential pair
per cell, masked where the cell's span is exceeded.  Meshes whose
worst-case span exceeds the offset budget (strongly graded cell sizes)
return ``None`` and the caller falls back to the host builder.

Correctness contract (identical to the host builder): a kept pair is
anything NOT provably separated from the bin by a face plane, with the
separation test inflated by ``eps`` plus a dtype-scaled rounding guard
— extra candidates cost row slots, never correctness; counts are exact
upper-true counts so "no candidate contains r and count fits" remains
an exact not-found at query time.
"""

from __future__ import annotations

import functools
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import geometry

# Total (offsets x cells) pair slots the device pipeline may allocate
# (~12 B/slot live through the sort; 2^26 slots ~ 0.8 GB + sort space).
MAX_PAIR_SLOTS = 1 << 26
# _gen_pairs unrolls a static Python loop over the offsets (~15 ops
# each): independent of the pair budget, a strongly graded SMALL mesh
# (one cell's AABB spanning a 40^3 bin block) would otherwise trace a
# multi-thousand-iteration loop into one jit and hang/OOM the remote
# compile.  Typical conforming meshes need < 30 offsets.
MAX_OFFSETS = 512


@functools.partial(
    jax.jit,
    static_argnames=(
        "offsets", "bin_shape", "active", "eps", "ndim", "n_bins",
    ),
)
def _gen_pairs(
    normals, offs, b0, span, half, rmin_d, h_d, zc,
    *, offsets, bin_shape, active, eps, ndim, n_bins
):
    """Stage 1: per-(offset, cell) bin key / score / cell id.

    Filtered-out and invalid slots get key == n_bins (sorts to the
    end).  Score is the bin-center interiority used for ranking
    (covers-most-first), matching the host builder."""
    c = normals.shape[0]
    nbx, nby, nbz = bin_shape
    dtype = normals.dtype
    # reach[f] = max |n_f . (x - bin_center)| over the bin box.
    # Elementwise multiply-reduce, NOT a matmul: a reduced-precision
    # matmul pass (TF32 keeps ~1e-3 relative) would dwarf the eps
    # separation guard and could drop overlapping pairs.
    n_abs = jnp.abs(normals)
    reach = (
        n_abs[:, :, 0] * half[0]
        + n_abs[:, :, 1] * half[1]
        + n_abs[:, :, 2] * half[2]
    )  # (C, nf)
    off_eps = offs + jnp.asarray(eps, dtype)

    keys, scores = [], []
    for (i, j, k) in offsets:
        valid = (
            (i < span[:, 0]) & (j < span[:, 1]) & (k < span[:, 2])
        )
        bx = b0[:, 0] + i
        by = b0[:, 1] + j
        bz = b0[:, 2] + k
        pbin = (bx * nby + by) * nbz + bz
        cbx = rmin_d[0] + (bx.astype(dtype) + 0.5) * h_d[0]
        cby = rmin_d[1] + (by.astype(dtype) + 0.5) * h_d[1]
        cbz = (
            rmin_d[2] + (bz.astype(dtype) + 0.5) * h_d[2]
            if (active[2] or ndim == 3)
            else jnp.full_like(cbx, zc)
        )
        proj = (
            normals[:, :, 0] * cbx[:, None]
            + normals[:, :, 1] * cby[:, None]
            + normals[:, :, 2] * cbz[:, None]
        )  # (C, nf)
        separated = ((proj - reach) > off_eps).any(axis=1)
        keep = valid & ~separated
        keys.append(jnp.where(keep, pbin, n_bins).astype(jnp.int32))
        scores.append((offs - proj).min(axis=1).astype(jnp.float32))
    key = jnp.stack(keys).reshape(-1)
    score = jnp.stack(scores).reshape(-1)
    cell = jnp.tile(
        jnp.arange(c, dtype=jnp.int32), (len(offsets), 1)
    ).reshape(-1)
    return key, score, cell


@functools.partial(jax.jit, static_argnames=("n_bins",))
def _sort_rank_count(key, score, cell, *, n_bins):
    """Stage 2: stable (bin asc, score desc) sort, in-bin ranks, exact
    per-bin counts."""
    n = key.shape[0]
    sk, _, scell = lax.sort(
        (key, -score, cell), num_keys=2, is_stable=True
    )
    pos = jnp.arange(n, dtype=jnp.int32)
    change = jnp.concatenate(
        [jnp.ones(1, bool), sk[1:] != sk[:-1]]
    )
    seg_start = lax.cummax(jnp.where(change, pos, 0))
    rank = pos - seg_start
    # histogram over n_bins (+1 sentinel slot for dropped pairs)
    counts = jnp.zeros(n_bins + 1, jnp.int32).at[sk].add(1)
    return sk, rank, scell, counts[:n_bins]


@functools.partial(
    jax.jit, static_argnames=("n_bins", "k_max", "k_ext", "n_over")
)
def _fill_tables(sk, rank, scell, counts, *, n_bins, k_max, k_ext, n_over):
    """Stage 3: scatter ranked pairs into the main (and extension)
    id tables; assign extension slots in ascending bin order."""
    sentinel = n_bins * k_max
    flat = jnp.where(
        (sk < n_bins) & (rank < k_max), sk * k_max + rank, sentinel
    )
    cand_ids = (
        jnp.full(sentinel + 1, -1, jnp.int32)
        .at[flat].set(scell)[:sentinel]
        .reshape(n_bins, k_max)
    )
    over = counts > k_max
    ext_slot = jnp.where(
        over, jnp.cumsum(over.astype(jnp.int32)) - 1, -1
    ).astype(jnp.int32)
    if k_ext and n_over:
        slot_of_pair = ext_slot[jnp.minimum(sk, n_bins - 1)]
        in_ext = (
            (sk < n_bins) & (rank >= k_max) & (rank < k_max + k_ext)
            & (slot_of_pair >= 0)
        )
        esent = n_over * k_ext
        eflat = jnp.where(
            in_ext, slot_of_pair * k_ext + (rank - k_max), esent
        )
        ext_ids = (
            jnp.full(esent + 1, -1, jnp.int32)
            .at[eflat].set(scell)[:esent]
            .reshape(n_over, k_ext)
        )
    else:
        ext_ids = jnp.zeros((0, 0), jnp.int32)
    return cand_ids, ext_slot, ext_ids


def build_candidate_bins_device(
    cell_points: np.ndarray,
    face_normals: np.ndarray,
    face_offsets: np.ndarray,
    rmin,
    rmax,
    ndim: int,
    k_max: int,
    dtype,
    bins_per_cell: float = 1.0,
    max_bins: int = 1 << 21,
    eps: float = 0.0,
    ext_max_k: int = 0,
    cover_ok=None,
):
    """Device-pipeline equivalent of geometry.build_candidate_bins.

    Returns the same 7-tuple (with jnp id/count arrays), or ``None``
    when the mesh's worst-case AABB bin span exceeds the fixed offset
    budget — the caller then falls back to the host builder.
    """
    n_cells = len(cell_points)
    if n_cells == 0:
        return None
    rmin = np.asarray(rmin, np.float64)
    n_target = min(max(int(bins_per_cell * n_cells), 1), max_bins)
    bin_shape, h, inv_h, active = geometry._bin_grid_shape(
        rmin, rmax, ndim, n_target
    )
    nbx, nby, nbz = (int(s) for s in bin_shape)
    n_bins = nbx * nby * nbz

    pad = eps + 1e-300
    lo = cell_points.min(axis=1) - pad
    hi = cell_points.max(axis=1) + pad
    b0 = np.clip(
        np.floor((lo - rmin) * inv_h).astype(np.int64), 0, bin_shape - 1
    )
    b1 = np.clip(
        np.floor((hi - rmin) * inv_h).astype(np.int64), 0, bin_shape - 1
    )
    span = (b1 - b0 + 1).astype(np.int32)
    smax = span.max(axis=0)
    n_offsets = int(np.prod(smax))
    if n_offsets > MAX_OFFSETS or n_offsets * n_cells > MAX_PAIR_SLOTS:
        return None  # strongly graded mesh: host fallback

    offsets = tuple(
        product(range(int(smax[0])), range(int(smax[1])), range(int(smax[2])))
    )
    # dtype-scaled rounding guard on top of the caller's inflation so a
    # device-dropped pair is ALWAYS truly separated at the query eps
    scale = max(np.max(np.abs(rmin)), np.max(np.abs(np.asarray(rmax))), 1.0)
    eps_dev = float(eps + 64.0 * np.finfo(np.dtype(dtype)).eps * scale)
    zc = float(cell_points[:, :, 2].mean()) if (ndim == 2 and not active[2]) else 0.0

    dev = jnp.asarray
    key, score, cell = _gen_pairs(
        dev(face_normals, dtype=dtype),
        dev(face_offsets, dtype=dtype),
        dev(b0, dtype=jnp.int32),
        dev(span),
        dev(np.where(active, 0.5 * h, 0.0), dtype=dtype),
        dev(rmin, dtype=dtype),
        dev(np.where(active, h, 0.0), dtype=dtype),
        zc,
        offsets=offsets,
        bin_shape=(nbx, nby, nbz),
        active=tuple(bool(a) for a in active),
        eps=eps_dev,
        ndim=ndim,
        n_bins=n_bins,
    )
    sk, rank, scell, counts = _sort_rank_count(
        key, score, cell, n_bins=n_bins
    )
    # Two host scalars size the static extension shapes
    max_count = int(counts.max())
    if cover_ok is not None and cover_ok(max_count):
        # Cover-all rows: widen K to the worst bin so every bin's list
        # is complete — no extension table, no query-side fallback
        k_max = max_count
    n_over = int((counts > k_max).sum())
    k_ext = (
        min(max_count - k_max, ext_max_k)
        if (n_over and ext_max_k > 0)
        else 0
    )
    cand_ids, ext_slot, ext_ids = _fill_tables(
        sk, rank, scell, counts,
        n_bins=n_bins, k_max=k_max, k_ext=k_ext, n_over=n_over,
    )
    return (
        cand_ids,
        counts,
        (nbx, nby, nbz),
        rmin,
        inv_h,
        ext_ids,
        ext_slot,
    )
