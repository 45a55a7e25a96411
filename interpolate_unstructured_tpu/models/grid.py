"""``UGrid`` — the unstructured grid as a JAX pytree of device arrays.

Batched re-design of ``iu_grid_t`` (m_interp_unstructured.f90:24-59):
the same SoA schema, but 0-based, batch-first ``(n_cells, npc, 3)``
layouts, plus two precomputed tables for batched queries:

* ``face_offsets[c,k] = dot(face_point[c,k], normal[c,k])`` so the
  inside-test becomes one matmul against the query positions;
* a uniform-grid cold-start seed table replacing the kd-tree (L0).

Variable *names* are static pytree metadata (hashable tuples), so a grid
traces cleanly through ``jit``; data arrays are leaves.  Functional
registry updates (``add_point_data`` etc.) return a new grid.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import geometry
from ..utils.config import DEFAULT_CONFIG, IUConfig, resolve_config

UNDEFINED_NAME = "UNDEFINED_NAME"


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "points",
        "cells",
        "neighbors",
        "cell_points",
        "face_normals",
        "face_offsets",
        "cell_volume",
        "point_is_at_boundary",
        "point_data",
        "cell_data",
        "icell_data",
        "rmin",
        "rmax",
        "bin_table",
        "bin_rmin",
        "bin_inv_h",
        "bin_pack",
        "walk_table",
        "kd_node_points",
        "kd_node_ids",
        "cand_ids",
        "cand_count",
        "cand_table",
        "cand_rmin",
        "cand_inv_h",
        "cand_ext_ids",
        "cand_ext_slot",
        "cand_ext_table",
        "points_lo",
        "point_data_lo",
        "acc_table",
        "cand_df_table",
    ],
    meta_fields=[
        "cell_type",
        "bin_shape",
        "cand_shape",
        "cand_ext_covers",
        "cand_nv",
        "cand_qeps",
        "kd_max_depth",
        "point_data_names",
        "cell_data_names",
        "icell_data_names",
        "locate_mode",
        "config",
    ],
)
@dataclasses.dataclass(frozen=True)
class UGrid:
    """Unstructured grid state (schema parity: iu_grid_t, SURVEY.md §2.1)."""

    # --- geometry (leaves) -------------------------------------------------
    points: Any  # (n_points, 3) vertex coordinates (always 3D)
    cells: Any  # (n_cells, npc) int32 connectivity, 0-based
    neighbors: Any  # (n_cells, nf) int32, cell across face k, -1 = boundary
    cell_points: Any  # (n_cells, npc, 3) gathered vertex coords
    face_normals: Any  # (n_cells, nf, 3) outward unit face normals
    face_offsets: Any  # (n_cells, nf) dot(face point, face normal)
    cell_volume: Any  # (n_cells,) area (2D) / signed volume (3D)
    point_is_at_boundary: Any  # (n_points,) bool
    point_data: Any  # (n_points, >= n_point_data)
    cell_data: Any  # (n_cells, >= n_cell_data)
    icell_data: Any  # (n_cells, >= n_icell_data) int32
    rmin: Any  # (3,) bounding box min
    rmax: Any  # (3,) bounding box max
    # --- cold-start seed table (leaves) -------------------------------------
    bin_table: Any  # (prod(bin_shape),) int32 seed cell per bin
    bin_rmin: Any  # (3,)
    bin_inv_h: Any  # (3,) inverse bin size (0 in unused dims)
    # (n_bins, 4): seed cell id (as float) | seed cell center xyz —
    # one 16B row gather answers "where do I start walking from"
    bin_pack: Any = None
    # Packed per-cell walk payload (n_cells, 512B/itemsize): face
    # normals | face offsets | neighbor ids | cell vertex coords |
    # volume, zero padded. One 512-byte row gather per walk step
    # serves the hop AND the final interpolation geometry.
    walk_table: Any = None
    # Optional kd-tree over cell centers (seed_mode="kdtree"): implicit
    # left-balanced node layout (ops.kdtree), giving kdtree2-equivalent
    # exact nearest-center cold seeds (:272-288)
    kd_node_points: Any = None  # (n_cells, 3)
    kd_node_ids: Any = None  # (n_cells,) int32 cell id per tree node
    # Per-bin candidate tables (ops.geometry.build_candidate_bins): the
    # cells intersecting each bin, packed with their face planes into
    # one wide fast-gather row so cold containment resolves in a single
    # gather (ops.locate.locate_candidates).
    cand_ids: Any = None  # (n_cand_bins, K) int32, -1 padded
    cand_count: Any = None  # (n_cand_bins,) int32 exact intersection count
    cand_table: Any = None  # (n_cand_bins, row_floats) packed rows
    cand_rmin: Any = None  # (3,)
    cand_inv_h: Any = None  # (3,)
    # Overflow-bin extension lists (candidates ranked K..K+k_ext): one
    # more row gather resolves overflow-bin misses exactly, replacing
    # the old compacted-walk fallback
    cand_ext_ids: Any = None  # (n_overflow_bins, k_ext) int32
    cand_ext_slot: Any = None  # (n_cand_bins,) int32, -1 = not overflow
    cand_ext_table: Any = None  # (n_overflow_bins, ext_row_floats)
    # Accurate-mode (compensated f32) leaves: float64 residuals of the
    # downcast coordinates/data (hi = the f32 arrays above, lo = these)
    # and the packed per-cell df32 interpolation rows
    # (ops.interp_acc.build_acc_table).  None on float64 grids.
    points_lo: Any = None  # (n_points, 3) f32
    point_data_lo: Any = None  # (n_points, n_point_data) f32
    acc_table: Any = None  # (n_cells, acc_row_width) f32, derived
    # Accurate-mode FUSED candidate rows (simplex cover grids): the
    # quantized probe layout with df32 (hi, lo) value planes, so ONE
    # row gather answers locate AND ~1e-13 interpolation
    # (ops.interp_acc.prepare_accurate; derived, never checkpointed)
    cand_df_table: Any = None  # (n_cand_bins, df_row_floats) f32
    # --- static metadata -----------------------------------------------------
    cell_type: str = "triangle"
    bin_shape: tuple = (1, 1, 1)
    cand_shape: tuple = (1, 1, 1)
    # True when every bin's candidate count fits K + k_ext, i.e. the
    # extension probe is exhaustive and no residual walk can be needed
    cand_ext_covers: bool = True
    # Number of leading point-data variables fused into the packed
    # candidate rows, PINNED at pack time (-1 = not yet packed /
    # legacy checkpoint: derive from capacity).  See cand_fused_nv.
    cand_nv: int = -1
    # Quantized-probe margin fuzz bound (0.0 for f32/f64 row layouts):
    # added to the inside tolerance so interior points can never be
    # lost to int16 rounding (see IUConfig.cand_quantized)
    cand_qeps: float = 0.0
    kd_max_depth: int = 0  # static traversal stack bound
    point_data_names: tuple = ()
    cell_data_names: tuple = ()
    icell_data_names: tuple = ()
    locate_mode: str = "bruteforce"  # "bruteforce" | "walk"
    config: IUConfig = DEFAULT_CONFIG

    # --- derived sizes -------------------------------------------------------
    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_points_per_cell(self) -> int:
        return self.cells.shape[1]

    @property
    def n_faces_per_cell(self) -> int:
        # == n_points_per_cell for tri/quad/tet (:865)
        return self.cells.shape[1]

    @property
    def ndim(self) -> int:
        return geometry.NDIM_OF_CELL_TYPE[self.cell_type]

    @property
    def n_point_data(self) -> int:
        return len(self.point_data_names)

    @property
    def n_cell_data(self) -> int:
        return len(self.cell_data_names)

    @property
    def n_icell_data(self) -> int:
        return len(self.icell_data_names)

    @property
    def dtype(self):
        return self.points.dtype

    def cell_centers(self):
        """Cell centroid = mean of vertices (iu_get_cell_center, :264-269)."""
        return jnp.mean(self.cell_points, axis=1)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def build_grid(
    points: np.ndarray,
    cells: np.ndarray,
    neighbors: np.ndarray,
    cell_type: str,
    point_data: dict | None = None,
    cell_data: dict | None = None,
    icell_data: dict | None = None,
    coord_scale_factor: float | None = None,
    dtype=None,
    config: IUConfig = DEFAULT_CONFIG,
    locate_mode: str = "auto",
    timings: dict | None = None,
) -> UGrid:
    """Build a device-resident grid from host arrays.

    Preprocessing (cell point gather, outward unit normals, volumes,
    boundary flags, bbox, seed table) runs on the host in float64 — the
    batch equivalent of iu_read_grid's preprocessing chain (:916-925) —
    then everything moves to device in ``dtype``.

    Args:
      points: (n_points, >=2) coordinates; padded to 3D.
      cells: (n_cells, npc) 0-based connectivity.
      neighbors: (n_cells, nf) 0-based adjacency, negative = boundary.
      cell_type: "triangle" | "quad" | "tetra".
      point_data/cell_data/icell_data: name -> 1D array registries.
      coord_scale_factor: optional scaling of coordinates (:858-860).
      dtype: device float dtype; defaults to float64 when jax x64 is
        enabled, else float32.
      locate_mode: "auto" picks matmul brute force for small meshes and
        bin-seed + walk for large ones.
      timings: optional dict, filled with the build's phase split —
        ``host_geometry_s`` (gather/normals/volumes on host),
        ``seed_table_s``, ``transfer_s`` (host arrays -> device +
        walk-table assembly), ``cand_build_s`` (candidate lists),
        ``cand_pack_s`` (fused-row tables, incl. any one-off compile).
    """
    import time as _time

    _want_timings = timings is not None
    if timings is None:
        timings = {}
    _t0 = _time.perf_counter()

    def _mark(key):
        nonlocal _t0
        now = _time.perf_counter()
        timings[key] = timings.get(key, 0.0) + (now - _t0)
        _t0 = now

    if cell_type not in geometry.CELL_TYPES:
        raise ValueError(f"Unsupported cell type {cell_type!r}")

    points = np.asarray(points, dtype=np.float64)
    if points.ndim != 2:
        raise ValueError("points must be 2D")
    if points.shape[1] < 3:
        points = np.pad(points, ((0, 0), (0, 3 - points.shape[1])))
    if coord_scale_factor is not None:
        points = points * coord_scale_factor

    cells = np.asarray(cells, dtype=np.int32)
    neighbors = np.asarray(neighbors, dtype=np.int32)
    npc_expected = geometry.N_POINTS_PER_CELL[cell_type]
    if cells.shape[1] != npc_expected:
        raise ValueError(
            f"{cell_type} cells need {npc_expected} vertices, "
            f"got {cells.shape[1]}"
        )
    if neighbors.shape != cells.shape:
        raise ValueError("neighbors must have the same shape as cells")

    n_points = len(points)
    n_cells = len(cells)

    cell_points = geometry.gather_cell_points(points, cells)
    normals, at_boundary = geometry.face_normals_and_boundary(
        cell_points, cells, neighbors, cell_type, n_points
    )
    face_offsets = np.einsum("cki,cki->ck", cell_points, normals)
    volume = geometry.cell_volumes(cell_points, cell_type)
    _mark("host_geometry_s")
    _resolved = (
        dtype
        if dtype is not None
        else (np.float64 if jax.config.jax_enable_x64 else np.float32)
    )
    # Neighbor ids as floats are exact while n_cells < 2^24 (float32
    # mantissa); guard so the packed table is never silently lossy.
    if n_cells >= (1 << 24) and np.dtype(_resolved) == np.float32:
        raise ValueError(
            "float32 grids support up to 2^24 cells (packed walk table); "
            "load with dtype=jnp.float64"
        )

    rmin = points.min(axis=0)
    rmax = points.max(axis=0)

    if locate_mode == "auto":
        locate_mode = (
            "bruteforce" if n_cells <= config.bruteforce_max_cells else "walk"
        )
    if locate_mode not in ("bruteforce", "walk"):
        raise ValueError(f"Unknown locate_mode {locate_mode!r}")
    will_use_cand = (
        config.use_candidate_bins
        and locate_mode == "walk"
        and config.seed_mode != "kdtree"
    )

    ndim = geometry.NDIM_OF_CELL_TYPE[cell_type]
    centers = cell_points.mean(axis=1)
    # When candidate tables own the cold path the nearest-center seed
    # table is only a fallback (kd-mode / candidates-disabled grids
    # read it); a fine table costs a cKDTree query per bin (~15 s for
    # 4M bins on this host) for nothing — keep it coarse there.
    bin_table, bin_shape, bin_rmin, bin_inv_h = geometry.build_bin_seed_table(
        centers,
        rmin,
        rmax,
        ndim,
        bins_per_cell=(
            min(config.bins_per_cell, 0.05)
            if will_use_cand
            else config.bins_per_cell
        ),
        max_bins=config.max_bins,
    )
    # Packed seed rows: [cell id as float | cell center xyz] — a cold
    # start costs one 16-byte row gather instead of id + center gathers
    bin_pack = np.concatenate(
        [bin_table[:, None].astype(np.float64), centers[bin_table]], axis=1
    )
    _mark("seed_table_s")

    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    dtype = jnp.dtype(dtype)

    # Dtype/domain-scaled inside tolerance (repo invariant: scale every
    # epsilon to the dtype)
    config = resolve_config(config, dtype, rmin, rmax)

    if config.seed_mode not in ("bins", "kdtree"):
        raise ValueError(f"Unknown seed_mode {config.seed_mode!r}")
    kd_node_points = kd_node_ids = None
    kd_max_depth = 0
    if config.seed_mode == "kdtree":
        from ..ops import kdtree as kdtree_mod

        kd = kdtree_mod.build_kdtree(centers, dtype=dtype)
        kd_node_points, kd_node_ids = kd.node_points, kd.node_ids
        kd_max_depth = kd.max_depth

    def stack_registry(reg, n_rows, target_dtype):
        reg = reg or {}
        names = tuple(reg.keys())
        if names:
            cols = [np.asarray(reg[k]).reshape(n_rows) for k in names]
            data = np.stack(cols, axis=1)
        else:
            data = np.zeros((n_rows, 0))
        return names, data, jnp.asarray(data, dtype=target_dtype)

    pd_names, pd_host, pd = stack_registry(point_data, n_points, dtype)
    cd_names, _, cd = stack_registry(cell_data, n_cells, dtype)
    icd_names, _, icd = stack_registry(icell_data, n_cells, jnp.int32)

    # Accurate-mode residuals (ops.interp_acc): the exact float64
    # remainder of downcasting coordinates/point data to float32.
    points_lo = point_data_lo = None
    if dtype == jnp.float32:
        points_lo = jnp.asarray(_f32_residual(points))
        point_data_lo = jnp.asarray(_f32_residual(pd_host))

    grid = UGrid(
        points=jnp.asarray(points, dtype=dtype),
        cells=jnp.asarray(cells),
        neighbors=jnp.asarray(neighbors),
        cell_points=jnp.asarray(cell_points, dtype=dtype),
        face_normals=jnp.asarray(normals, dtype=dtype),
        face_offsets=jnp.asarray(face_offsets, dtype=dtype),
        cell_volume=jnp.asarray(volume, dtype=dtype),
        point_is_at_boundary=jnp.asarray(at_boundary),
        point_data=pd,
        cell_data=cd,
        icell_data=icd,
        rmin=jnp.asarray(rmin, dtype=dtype),
        rmax=jnp.asarray(rmax, dtype=dtype),
        bin_table=jnp.asarray(bin_table),
        bin_pack=jnp.asarray(bin_pack, dtype=dtype),
        walk_table=None,  # assembled on device below (no extra transfer)
        bin_rmin=jnp.asarray(bin_rmin, dtype=dtype),
        bin_inv_h=jnp.asarray(bin_inv_h, dtype=dtype),
        kd_node_points=kd_node_points,
        kd_node_ids=kd_node_ids,
        points_lo=points_lo,
        point_data_lo=point_data_lo,
        cell_type=cell_type,
        bin_shape=bin_shape,
        kd_max_depth=kd_max_depth,
        point_data_names=pd_names,
        cell_data_names=cd_names,
        icell_data_names=icd_names,
        locate_mode=locate_mode,
        config=config,
    )

    grid = dataclasses.replace(grid, walk_table=_build_walk_table(grid))
    if _want_timings:  # only sync when the caller asked for phase times
        jax.block_until_ready(grid.walk_table)
    _mark("transfer_s")
    # Candidate bins take over the whole cold path; an explicit
    # seed_mode="kdtree" choice opts into kd-seeded cold walks instead
    # (kdtree2 parity, m_interp_unstructured.f90:272-288)
    if will_use_cand:
        k_max, _nv = candidate_row_capacity(
            cell_type, dtype, config, n_point_data=len(pd_names)
        )
        if k_max >= 1:
            (
                cand_ids, cand_count, cand_shape, cand_rmin, cand_inv_h,
                ext_ids, ext_slot,
            ) = build_candidate_bins_dispatch(
                cell_points, normals, face_offsets, rmin, rmax, ndim,
                k_max, dtype, config,
                cover_ok=_make_cover_ok(cell_type, dtype, config, _nv, k_max),
            )
            grid = dataclasses.replace(
                grid,
                cand_ids=jnp.asarray(cand_ids),
                cand_count=jnp.asarray(cand_count),
                cand_shape=cand_shape,
                cand_rmin=jnp.asarray(cand_rmin, dtype=dtype),
                cand_inv_h=jnp.asarray(cand_inv_h, dtype=dtype),
                cand_ext_ids=(
                    jnp.asarray(ext_ids) if ext_ids.shape[1] else None
                ),
                cand_ext_slot=jnp.asarray(ext_slot),
                # cand_ids.shape[1], not the capacity k_max: the
                # builder may have cover-widened K to the worst bin
                cand_ext_covers=bool(
                    int(np.asarray(cand_count).max(initial=0))
                    <= cand_ids.shape[1] + ext_ids.shape[1]
                ),
            )
            _mark("cand_build_s")
            grid = dataclasses.replace(grid, **_build_cand_tables(grid))
            if _want_timings:
                jax.block_until_ready(grid.cand_table)
            _mark("cand_pack_s")
    if (
        config.refine_bin_seeds
        and locate_mode == "walk"
        and grid.cand_table is None
    ):
        # Bin seeds only matter when cold starts actually walk (kd-tree
        # mode / candidates disabled); the refinement pass costs one
        # batched self-locate of every bin center, so skip it when the
        # candidate tables supersede seeded cold walks.
        grid = _refine_bin_seeds(grid, centers)
    return grid


def _make_cover_ok(cell_type, dtype, config, nv, k_max):
    """Predicate deciding cover-all K widening (see
    IUConfig.cand_cover_row_bytes): the builders call it with the worst
    bin's exact candidate count once that is known.

    Widening to ``max_count`` is allowed when the widened row (with the
    same ``nv`` fused variables) fits the cover budget AND the widened
    K stays out of the post-hoc derivation hole — cand_fused_nv infers
    cover mode from "K doesn't fit cand_row_bytes bare", so a K that
    fits config rows bare but not with data would repack with nv = 0
    and silently drop the fused-interpolation path."""
    its = jnp.dtype(dtype).itemsize
    cfg_f = config.cand_row_bytes // its
    cov_f = config.cand_cover_row_bytes // its
    if cand_is_quantized(cell_type, dtype, config):
        # Quantized grids reconstruct nv deterministically from the
        # current config (cand_fused_nv), so the derivation-hole check
        # below doesn't apply — widening is allowed whenever the
        # widened row fits either budget.
        pern = _qcand_floats_per(cell_type, nv)

        def cover_ok_q(max_count: int) -> bool:
            if cov_f <= 0 or max_count <= k_max:
                return False
            return pern * max_count + 2 <= max(cfg_f, cov_f)

        return cover_ok_q
    pern = _cand_floats_per(cell_type, nv)
    per0 = _cand_floats_per(cell_type, 0)

    def cover_ok(max_count: int) -> bool:
        if cov_f <= 0 or max_count <= k_max:
            return False
        need = pern * max_count + 1
        if need <= cfg_f:
            return True  # widens within the config row — always safe
        if need > cov_f:
            return False  # worst bin doesn't fit a cover row
        return per0 * max_count + 1 > cfg_f  # hole check

    return cover_ok


def build_candidate_bins_dispatch(
    cell_points, normals, face_offsets, rmin, rmax, ndim, k_max,
    dtype, config, cover_ok=None,
):
    """Candidate-bin construction with backend dispatch: the device
    pipeline (ops/cand_build.py) for large meshes, the host reference
    builder (ops/geometry.py) for small ones or when the device
    pipeline declines (extreme AABB spans).  Both apply the same
    build-side eps inflation, which strictly dominates the query-side
    inside tolerance plus rounding so no containing cell can be
    filtered out of its bin's candidate list."""
    from ..ops import cand_build

    mode = config.cand_build
    if mode not in ("auto", "host", "device"):
        raise ValueError(f"Unknown cand_build mode {mode!r}")
    kwargs = dict(
        bins_per_cell=config.cand_bins_per_cell,
        max_bins=config.cand_max_bins,
        eps=2.0 * config.eps_inside,
        ext_max_k=config.cand_ext_max_k,
        cover_ok=cover_ok,
    )
    res = None
    if mode == "device" or (
        mode == "auto"
        and len(cell_points) >= config.cand_build_device_min_cells
    ):
        res = cand_build.build_candidate_bins_device(
            cell_points, normals, face_offsets, rmin, rmax, ndim,
            k_max, dtype=dtype, **kwargs,
        )
        if res is None and mode == "device":
            raise ValueError(
                "cand_build='device' but the mesh exceeds the device "
                "offset budget (strongly graded cell sizes)"
            )
    if res is None:
        res = geometry.build_candidate_bins(
            cell_points, normals, face_offsets, rmin, rmax, ndim,
            k_max, **kwargs,
        )
    return res


def cand_is_quantized(cell_type: str, dtype, config) -> bool:
    """Whether this grid's candidate rows use the int16-quantized
    layout (IUConfig.cand_quantized).  Simplices only: the quad
    inverse-bilinear weights need f32 vertices, and f64 grids keep the
    f64 layout (quantization fuzz would dwarf their tolerance)."""
    return bool(
        config.cand_quantized
        and cell_type in ("triangle", "tetra")
        and jnp.dtype(dtype) == jnp.float32
    )


def _qcand_floats_per(cell_type: str, nv: int) -> int:
    """Floats per candidate in a QUANTIZED row (_pack_qcand_rows_jit):
    ceil(3nf/2) int16-pair normal slots + ceil(nf/2) local-offset
    slots + one f32 value plane (gx, gy, gz, c) per fused variable +
    id.  Rows also carry TWO trailing columns (count, dscale) instead
    of one — capacity callers use overhead 2."""
    nf = geometry.N_POINTS_PER_CELL[cell_type]
    return -(-3 * nf // 2) + -(-nf // 2) + 4 * nv + 1


def _qdf_floats_per(cell_type: str, nv: int) -> int:
    """Floats per candidate in an accurate-mode DF row
    (_pack_qdf_rows_jit): the quantized probe geometry plus an (hi, lo)
    df32 value plane — (ghx ghy ghz glx gly glz c_hi c_lo) — per fused
    variable, plus id."""
    nf = geometry.N_POINTS_PER_CELL[cell_type]
    return -(-3 * nf // 2) + -(-nf // 2) + 8 * nv + 1


def _roles(x):
    """(n_rows, K, m) -> (n_rows, m*K): K-wide role columns, column =
    role*K + k — the layout both quantized packers and the probe
    kernels share."""
    return x.transpose(0, 2, 1).reshape(x.shape[0], -1)


def _src_floats(cell_type: str, nv: int) -> int:
    """Used floats in a per-cell pack-source record (_pack_src_rows_jit):
    [normals nf*3 | offsets nf | cell_points npc*3 | vertex data npc*nv]."""
    nf = npc = geometry.N_POINTS_PER_CELL[cell_type]
    return nf * 4 + npc * 3 + npc * nv


def _pad_record_stride(used: int, itemsize: int) -> int:
    """Record width padded so the row stride is a 256-byte multiple
    (not re-tuned on the H100)."""
    step = 256 // itemsize
    return -(-used // step) * step


def _pack_source_chunk(k_max: int, src_floats: int, itemsize: int) -> int:
    """Rows per lax.map step for the record-gather packers, sized so
    the materialized (chunk, K, S) gather output stays ~<= 128 MB (the
    packer's other per-chunk temporaries are of the same order)."""
    per_row = max(k_max * src_floats * itemsize, 1)
    c = (128 << 20) // per_row
    return max(1 << 12, min(1 << 18, 1 << max(int(c).bit_length() - 1, 0)))


@functools.partial(jax.jit, static_argnames=("nv", "dtype"))
def _pack_src_rows_jit(
    face_normals, face_offsets, cell_points, cells, point_data,
    *, nv, dtype
):
    """Per-cell pack-source records: ONE gather-friendly row per cell
    carrying everything the candidate-row packers read per candidate.

    The row packers used to issue 4-5 narrow gathers per (bin, k) slot
    (normals 48 B, offsets 16 B, vertices 48 B, connectivity 16 B plus
    a nested point-data gather).  Packing the per-cell fields into one
    record turns five narrow random fetches per slot into one."""
    n_cells = face_normals.shape[0]
    nf = face_normals.shape[1]
    npc = cell_points.shape[1]
    cols = [
        face_normals.reshape(n_cells, nf * 3),
        face_offsets,
        cell_points.reshape(n_cells, npc * 3),
    ]
    if nv:
        vtx = point_data[:, :nv][cells]  # (n_cells, npc, nv)
        cols.append(vtx.reshape(n_cells, npc * nv))
    rows = jnp.concatenate(cols, axis=1)
    pad = _pad_record_stride(rows.shape[1], jnp.dtype(dtype).itemsize) \
        - rows.shape[1]
    return jnp.pad(rows, ((0, 0), (0, pad)))


def _split_src(g, nf, npc, nv):
    """Slice a gathered (n, K, S) record block back into its fields:
    (normals (n,K,nf,3), offs (n,K,nf), cp (n,K,npc,3),
    vtx (n,K,npc,nv) or None)."""
    n, k = g.shape[:2]
    normals = g[..., : nf * 3].reshape(n, k, nf, 3)
    offs = g[..., nf * 3 : nf * 4]
    cp = g[..., nf * 4 : nf * 4 + npc * 3].reshape(n, k, npc, 3)
    vtx = None
    if nv:
        o = nf * 4 + npc * 3
        vtx = g[..., o : o + npc * nv].reshape(n, k, npc, nv)
    return normals, offs, cp, vtx


def _quantize_probe_geometry(normals, offs, ids, centers):
    """int16 probe geometry — the ONE definition shared by the plain
    (_pack_qcand_rows_jit) and accurate-mode (_pack_qdf_rows_jit)
    packers.  ``grid.cand_qeps`` is derived from the plain rows'
    dscale and the query side applies it to BOTH tables, so the two
    quantizations must stay bitwise identical: any change to the
    masking rule, QCAND_NSCALE, or clip bounds lands in both packers
    by construction.

    ``normals``/``offs`` are the ALREADY-GATHERED per-candidate face
    planes — (n, K, nf, 3) and (n, K, nf) slices of the pack-source
    record (_split_src).

    Returns (valid, centers, head_parts, ds): ``head_parts`` are the
    packed [qn | qd] role columns that open every quantized row;
    ``ds`` the per-row dscale."""
    valid = ids >= 0
    normals = normals.astype(jnp.float32)  # (n, K, nf, 3)
    offs = offs.astype(jnp.float32)  # (n, K, nf)
    centers = centers.astype(jnp.float32)

    d_loc = offs - (normals * centers[:, None, None, :]).sum(-1)
    absd = jnp.where(valid[..., None], jnp.abs(d_loc), 0.0)
    ds = absd.max(axis=(1, 2)) / QCAND_NSCALE  # (n,)
    ds_safe = jnp.maximum(ds, jnp.asarray(np.finfo(np.float32).tiny))
    qd = jnp.clip(
        jnp.round(d_loc / ds_safe[:, None, None]), -32767, 32767
    ).astype(jnp.int32)
    qn = jnp.clip(
        jnp.round(normals * QCAND_NSCALE), -32767, 32767
    ).astype(jnp.int32)

    n_rows, k_max = ids.shape
    nf = normals.shape[2]
    head_parts = [
        _roles(_pack_i16_pairs(qn.reshape(n_rows, k_max, nf * 3))),
        _roles(_pack_i16_pairs(qd)),
    ]
    return valid, centers, head_parts, ds


def _finish_qrows(parts, ids, count_vals, ds, row_floats):
    """Close a quantized row: [.. | id]*K | count | dscale, padded to
    the physical row width (shared by both quantized packers)."""
    parts = parts + [
        ids.astype(jnp.float32),
        count_vals.astype(jnp.float32)[:, None],
        ds.astype(jnp.float32)[:, None],
    ]
    rows = jnp.concatenate(parts, axis=1)
    pad = max(row_floats, rows.shape[1]) - rows.shape[1]
    return jnp.pad(rows, ((0, 0), (0, pad)))


@functools.partial(jax.jit, static_argnames=("nv",))
def _pack_dfsrc_rows_jit(face_normals, face_offsets, plane_hi, plane_lo,
                         *, nv):
    """Per-cell accurate-mode pack-source records (f32):
    [normals nf*3 | offsets nf | plane_hi nv*4 | plane_lo nv*4],
    padded to a 256-byte-multiple stride (see _pack_src_rows_jit)."""
    n_cells = face_normals.shape[0]
    nf = face_normals.shape[1]
    rows = jnp.concatenate(
        [
            face_normals.astype(jnp.float32).reshape(n_cells, nf * 3),
            face_offsets.astype(jnp.float32),
            plane_hi.reshape(n_cells, nv * 4),
            plane_lo.reshape(n_cells, nv * 4),
        ],
        axis=1,
    )
    pad = _pad_record_stride(rows.shape[1], 4) - rows.shape[1]
    return jnp.pad(rows, ((0, 0), (0, pad)))


@functools.partial(
    jax.jit, static_argnames=("cell_type", "row_floats", "nv")
)
def _pack_qdf_rows_jit(
    src, ids, count_vals, centers, *, cell_type, row_floats, nv
):
    """Accurate-mode candidate rows: quantized int16 probe geometry
    (identical to _pack_qcand_rows_jit) + df32 value planes.  ``src``
    is the per-cell df record table (_pack_dfsrc_rows_jit) — one row
    gather per candidate slot.

    ``plane_hi``/``plane_lo`` are the (n_cells, nv, 4) f32 split of the
    per-cell float64 planes v(r) = g . r + c (exact for simplices —
    barycentric interpolation is affine per cell; build_cand_df_table
    solves them on the host in f64).  The stored offset is re-anchored
    at the bin center IN df32: c_loc = c + g . c_bin, so the kernel
    evaluates v = g . r_local + c_loc with r_local = r - c_bin carried
    as an exact (hi, lo) pair — end-to-end ~2^-48 relative.

    Role layout (K-wide roles, column role*K + k; _qdf_floats_per):
      [qn | qd | (ghx ghy ghz glx gly glz ch cl) per var | id] * K
      | count | dscale
    """
    from ..ops import df32

    n_rows, k_max = ids.shape
    nf = geometry.N_POINTS_PER_CELL[cell_type]

    g = src[jnp.maximum(ids, 0)]  # (n, K, S) — the ONE row gather
    normals = g[..., : nf * 3].reshape(n_rows, k_max, nf, 3)
    offs = g[..., nf * 3 : nf * 4]
    _, centers, parts, ds = _quantize_probe_geometry(
        normals, offs, ids, centers
    )
    o = nf * 4
    ph = g[..., o : o + nv * 4].reshape(n_rows, k_max, nv, 4)
    plo = g[..., o + nv * 4 : o + nv * 8].reshape(n_rows, k_max, nv, 4)
    g = [(ph[..., d], plo[..., d]) for d in range(3)]  # df pairs (n,K,nv)
    c = (ph[..., 3], plo[..., 3])
    # c_loc = c + g . c_bin in df32 (bin centers are exact f32 by the
    # shared geometry.cand_bin_center_cols definition)
    acc = c
    for d in range(3):
        cb = centers[:, None, None, d]
        acc = df32.add(acc, df32.mul(g[d], (cb, jnp.zeros_like(cb))))
    cols = jnp.stack(
        [g[0][0], g[1][0], g[2][0], g[0][1], g[1][1], g[2][1],
         acc[0], acc[1]],
        axis=-1,
    )  # (n, K, nv, 8)
    parts.append(_roles(cols.reshape(n_rows, k_max, nv * 8)))
    return _finish_qrows(parts, ids, count_vals, ds, row_floats)


@functools.partial(
    jax.jit, static_argnames=("cell_type", "row_floats", "nv")
)
def _pack_qdf_rows_mapped(
    src, ids_st, counts_st, centers_st, *, cell_type, row_floats, nv
):
    """Chunked df-row repack: one lax.map writing straight into the
    single output (the eager concatenate version keeps ~3x the table
    bytes live — see _pack_cand_rows)."""

    def body(args):
        ids_c, counts_c, centers_c = args
        return _pack_qdf_rows_jit(
            src, ids_c, counts_c, centers_c,
            cell_type=cell_type, row_floats=row_floats, nv=nv,
        )

    return jax.lax.map(body, (ids_st, counts_st, centers_st))


def solve_cell_planes_f64(points64, cells, data64):
    """Per-cell float64 affine interpolant v(r) = g . r + c.

    Barycentric interpolation on a simplex is affine, so for tets the
    plane through the 4 (vertex, value) pairs IS the interpolant; for
    triangles (rank-3 system in 3D) the minimum-norm in-plane solution
    is used.  Solved anchored at the cell centroid (no cancellation),
    vectorized over all cells.  Returns (g (n, nv, 3), c (n, nv)) f64.
    """
    p = points64[cells]  # (n, npc, 3)
    d = data64[cells]  # (n, npc, nv)
    npc = p.shape[1]
    anchor = p.mean(axis=1)  # (n, 3)
    dp = p - anchor[:, None, :]
    if npc == 4:
        a = np.concatenate([dp, np.ones_like(dp[..., :1])], axis=2)
        # Degenerate (zero-volume) cells would abort the whole batched
        # solve with LinAlgError; route them through the minimum-norm
        # pseudo-inverse instead — every other path guards slivers
        # (ops/wkern degenerate-denominator guards), this one must too.
        # det(a) = 6 * signed volume; relative to the cell scale.
        det = np.linalg.det(a)
        scale = np.abs(dp).max(axis=(1, 2), initial=0.0) ** 3
        bad = ~(np.abs(det) > 1e-14 * scale)
        if bad.any():
            sol = np.empty(a.shape[:1] + (4, d.shape[2]), np.float64)
            good = ~bad
            if good.any():
                sol[good] = np.linalg.solve(a[good], d[good])
            sol[bad] = np.einsum(
                "nij,njv->niv", np.linalg.pinv(a[bad]), d[bad]
            )
        else:
            sol = np.linalg.solve(a, d)  # (n, 4, nv): g rows + c
        g = sol[:, :3].transpose(0, 2, 1)  # (n, nv, 3)
        c0 = sol[:, 3]  # (n, nv)
    elif npc == 3:
        # minimum-norm least squares via the pseudo-inverse of the
        # (3, 4) system [dp 1] — exact on the triangle's plane
        a = np.concatenate([dp, np.ones_like(dp[..., :1])], axis=2)
        sol = np.einsum(
            "nij,njv->niv", np.linalg.pinv(a), d
        )  # (n, 4, nv)
        g = sol[:, :3].transpose(0, 2, 1)
        c0 = sol[:, 3]
    else:
        raise ValueError("df planes are defined for simplices only")
    # de-anchor: v = g . (r - anchor) + c0 = g . r + (c0 - g . anchor)
    c = c0 - np.einsum("nvd,nd->nv", g, anchor)
    return g, c


def cand_df_supported(grid: UGrid) -> bool:
    """Gate for the fused accurate rows: float32 simplex cover grids
    with quantized candidate tables and at least one fused variable."""
    return (
        grid.cand_ids is not None
        and grid.cand_ext_table is None
        and grid.cand_ext_covers
        and grid.cell_type in ("triangle", "tetra")
        and grid.dtype == jnp.float32
        and cand_is_quantized(grid.cell_type, grid.dtype, grid.config)
        and cand_fused_nv(grid) >= 1
    )


def build_cand_df_table(grid: UGrid):
    """Assemble the accurate-mode fused candidate rows (see
    _pack_qdf_rows_jit).  Planes are solved on the host in float64
    from the stored (hi, lo) mesh/data split; without stored residuals
    (pre-v4 checkpoint) accuracy is bounded by the f32 representation.
    """
    nv = cand_fused_nv(grid)
    pts64 = np.asarray(grid.points, np.float64)
    if grid.points_lo is not None:
        pts64 = pts64 + np.asarray(grid.points_lo, np.float64)
    pd64 = np.asarray(grid.point_data[:, :nv], np.float64)
    if grid.point_data_lo is not None:
        pd64 = pd64 + np.asarray(
            grid.point_data_lo[:, :nv], np.float64
        )
    g64, c64 = solve_cell_planes_f64(
        pts64, np.asarray(grid.cells), pd64
    )
    plane64 = np.concatenate([g64, c64[:, :, None]], axis=2)  # (n,nv,4)
    plane_hi = plane64.astype(np.float32)
    plane_lo = (plane64 - plane_hi.astype(np.float64)).astype(np.float32)

    k_max = grid.cand_ids.shape[1]
    per = _qdf_floats_per(grid.cell_type, nv)
    step = 512 // 4
    row_floats = -(-(per * k_max + 2) // step) * step

    bin_idx = jnp.arange(grid.cand_ids.shape[0], dtype=jnp.int32)
    cx, cy, cz = geometry.cand_bin_center_cols(
        grid.cand_rmin, grid.cand_inv_h,
        *geometry.cand_bin_decode(
            bin_idx, grid.cand_shape[1], grid.cand_shape[2]
        ),
    )
    centers = jnp.stack([cx, cy, cz], axis=1)

    src = _pack_dfsrc_rows_jit(
        grid.face_normals, grid.face_offsets,
        jnp.asarray(plane_hi), jnp.asarray(plane_lo), nv=nv,
    )
    statics = dict(
        cell_type=grid.cell_type, row_floats=row_floats, nv=nv
    )
    chunk = _pack_source_chunk(k_max, src.shape[1], 4)
    return _chunked_pack(
        lambda i, c, z: _pack_qdf_rows_jit(src, i, c, z, **statics),
        lambda i3, c2, z3: _pack_qdf_rows_mapped(
            src, i3, c2, z3, **statics
        ),
        grid.cand_ids, grid.cand_count, centers, chunk, row_floats,
    )


def _cand_floats_per(cell_type: str, nv: int) -> int:
    """Floats per candidate in a fused row (see _pack_cand_rows_jit).

    Rows carry PRECOMPUTED unit face planes: margins then cost 2 fused
    multiply-adds per face in the probe, instead of deriving the planes
    from vertices per query.

    Simplex rows carry NO separate inverse-height role: the fused data
    is PREMULTIPLIED by the opposite vertex's inverse height at pack
    time (value = sum_v margin_{(v+1)%npc} * packed_data_v), saving nf
    floats per candidate — at 1 KB that lifts tet K from 10 to 12."""
    nf = npc = geometry.N_POINTS_PER_CELL[cell_type]
    per = 4 * nf + 1 + npc * nv  # planes + id + premultiplied data
    if cell_type == "quad":
        # inverse-bilinear weights need the vertices and RAW data
        per = 4 * nf + 3 * npc + 1 + npc * nv
    return per


def candidate_row_capacity(cell_type, dtype, config, n_point_data=0):
    """(K, nv): candidates per packed row and how many live point-data
    variables are fused into it.

    Fusing a variable costs ``npc`` floats per candidate; fewer
    candidates means more fallback walks, so fusing stops before K
    drops below ``config.cand_min_k``.
    """
    row_floats = config.cand_row_bytes // jnp.dtype(dtype).itemsize
    min_k = max(1, config.cand_min_k)
    if cand_is_quantized(cell_type, dtype, config):
        per_fn, overhead = _qcand_floats_per, 2
    else:
        per_fn, overhead = _cand_floats_per, 1
    for nv in range(n_point_data, -1, -1):
        k = (row_floats - overhead) // per_fn(cell_type, nv)
        if k >= min_k or nv == 0:
            return k, nv
    return 0, 0


QCAND_NSCALE = 32767.0  # int16 full scale for unit normal components


def _pack_i16_pairs(comp):
    """(n, K, m) int32 in [-32767, 32767] -> (n, K, ceil(m/2)) f32
    words: two int16 halves per 4-byte slot (lo = even comp, hi = odd),
    bitcast so the slot rides the f32 row unchanged."""
    m = comp.shape[-1]
    if m % 2:
        comp = jnp.pad(comp, ((0, 0), (0, 0), (0, 1)))
    lo = comp[..., 0::2] & 0xFFFF
    hi = comp[..., 1::2] & 0xFFFF
    return jax.lax.bitcast_convert_type(lo | (hi << 16), jnp.float32)


@functools.partial(
    jax.jit,
    static_argnames=("cell_type", "row_floats", "nv", "dtype"),
)
def _pack_qcand_rows_jit(
    src, ids, count_vals, centers, *, cell_type, row_floats, nv, dtype
):
    """Quantized candidate rows (simplices; see IUConfig.cand_quantized).

    ``src`` is the per-cell pack-source record table
    (_pack_src_rows_jit): the packer does ONE row gather per candidate
    slot and slices the fields out, instead of 4-5 narrow issue-bound
    gathers (round-5 repack cut; see _pack_src_rows_jit).

    Role layout (K-wide roles, column role*K + k; _qcand_floats_per):

      [qn (ceil(3nf/2) int16-pair slots) | qd (ceil(nf/2) slots)
       | plane (gx gy gz c) per fused var | id] * K  | count | dscale

    ``qn`` = round(n * 32767) of the unit face normals, face-major
    component order (f*3 + d).  ``qd`` = round(d_local / dscale) with
    ``d_local = off_f - n_f . c_bin`` the face offset in the query
    bin's local frame (centers passed per row; the query side computes
    r_local = r - c_bin with the SAME formula,
    geometry.cand_bin_center_cols) and ``dscale`` the row's max
    |d_local| / 32767.  The probe margin is then
    ``qd * dscale - (qn . r_local) / 32767`` — an exactly-representable
    plane within ~h/2e4 of the true face (the fuzz bound rides the
    grid as cand_qeps and widens the inside tolerance).

    Values come from exact f32 per-cell planes: for a simplex the
    interpolant is linear, value(r) = g . r_local + c with
    g = -sum_v (data_v - mean) * inv_height_v * n_f(v) (mean-shifted so
    no 1/h cancellation inflates f32 rounding) and c anchored at the
    bin center.  Invalid (padding) slots keep id -1; the kernel masks
    their margins by the id sign, so no huge-offset encoding is needed
    (int16 cannot hold one)."""
    n_rows, k_max = ids.shape
    nf = npc = geometry.N_POINTS_PER_CELL[cell_type]

    g = src[jnp.maximum(ids, 0)]  # (n, K, S) — the ONE row gather
    normals, offs, cp, vtx = _split_src(g, nf, npc, nv)
    _, centers, parts, ds = _quantize_probe_geometry(
        normals, offs, ids, centers
    )
    normals = normals.astype(jnp.float32)
    offs = offs.astype(jnp.float32)
    if nv:
        fv = (jnp.arange(npc) + 1) % npc  # face paired with vertex v
        opp = (jnp.arange(nf) - 1) % npc  # vertex opposite face f
        p_opp = cp[:, :, opp]
        m_opp = offs - (normals * p_opp).sum(-1)
        inv_f = 1.0 / jnp.where(m_opp == 0, 1.0, m_opp)
        iv_vertex = inv_f[..., fv]  # (n, K, npc)
        n_fv = normals[:, :, fv]  # (n, K, npc, 3)
        off_fv = offs[..., fv]  # (n, K, npc)

        d_mean = vtx.mean(axis=2)  # (n, K, nv)
        coef = (vtx - d_mean[:, :, None, :]) * iv_vertex[..., None]
        # elementwise multiply-reduce per component (no batched tiny
        # einsums: they may lower to reduced-precision matmuls)
        g = [
            -(coef * n_fv[..., d : d + 1]).sum(axis=2)  # (n, K, nv)
            for d in range(3)
        ]
        c0 = (coef * off_fv[..., None]).sum(axis=2) + d_mean
        c_loc = c0 + sum(
            g[d] * centers[:, None, d : d + 1] for d in range(3)
        )
        plane = jnp.stack(g + [c_loc], axis=-1)  # (n, K, nv, 4)
        parts.append(_roles(plane.reshape(n_rows, k_max, nv * 4)))
    return _finish_qrows(parts, ids, count_vals, ds, row_floats)


def _chunked_pack(pack_full, pack_stacked, ids, count_vals, centers,
                  chunk, row_floats):
    """Memory-bounded row-pack driver — ONE place holding the lessons:

    The whole repack runs as ONE jit with every grid array an explicit
    argument (closures would embed the arrays as compile-time
    constants): a ``lax.map`` over the padded
    chunk stack writes each chunk's rows straight into the single
    preallocated output.  The earlier python-loop-of-jit-calls +
    ``jnp.concatenate(parts)[:n]`` version kept all chunk outputs, the
    concatenated table AND the sliced copy live at once — ~3x the table
    bytes, which on a 4 GB cover table exceeded device memory; the
    failure surfaced as a deferred async RESOURCE_EXHAUSTED poisoning
    every later use of ``cand_table``.

    The returned table keeps the padded tail rows (ids -1, count 0):
    bin indices are always < n_bins so the pad rows are never gathered,
    and dropping them would cost another whole-table slice copy.

    ``pack_full(ids, counts, centers)`` packs one unchunked table;
    ``pack_stacked(ids3, cnt2, centers3)`` lax.maps over the
    (n_chunks, chunk, ...) stack.  ``centers`` may be None (plain
    f64-layout rows)."""
    n = ids.shape[0]
    ids = jnp.asarray(ids)
    count_vals = jnp.asarray(count_vals)
    if centers is not None:
        centers = jnp.asarray(centers)
    if n <= chunk:
        return pack_full(ids, count_vals, centers)
    pad = (-n) % chunk
    ids = jnp.pad(ids, ((0, pad), (0, 0)), constant_values=-1)
    count_vals = jnp.pad(count_vals, (0, pad))
    if centers is not None:
        centers = jnp.pad(centers, ((0, pad), (0, 0))).reshape(
            -1, chunk, 3
        )
    return pack_stacked(
        ids.reshape(-1, chunk, ids.shape[1]),
        count_vals.reshape(-1, chunk),
        centers,
    ).reshape(-1, row_floats)


def _pack_cand_rows(grid: UGrid, ids, count_vals, row_floats, nv,
                    centers=None, chunk: int | None = None):
    """Candidate-row packer: build the per-cell source record once
    (_pack_src_rows_jit), then pack in row chunks sized so the
    materialized (chunk, K, S) record gather stays memory-bounded.
    Chunk/memory discipline lives in _chunked_pack."""
    quantized = centers is not None
    src = _pack_src_rows_jit(
        grid.face_normals, grid.face_offsets, grid.cell_points,
        grid.cells, grid.point_data, nv=nv, dtype=grid.dtype,
    )
    if chunk is None:
        chunk = _pack_source_chunk(
            ids.shape[1], src.shape[1], jnp.dtype(grid.dtype).itemsize
        )
    statics = dict(
        cell_type=grid.cell_type, row_floats=row_floats, nv=nv,
        dtype=grid.dtype,
    )

    def pack_full(i, c, z):
        if quantized:
            return _pack_qcand_rows_jit(src, i, c, z, **statics)
        return _pack_cand_rows_jit(src, i, c, **statics)

    def pack_stacked(i3, c2, z3):
        return _pack_cand_rows_mapped(src, i3, c2, z3, **statics)

    return _chunked_pack(
        pack_full, pack_stacked, ids, count_vals, centers, chunk,
        row_floats,
    )


@functools.partial(
    jax.jit,
    static_argnames=("cell_type", "row_floats", "nv", "dtype"),
)
def _pack_cand_rows_mapped(
    src, ids3, cnt2, centers3, *, cell_type, row_floats, nv, dtype
):
    """lax.map over chunk-stacked (n_chunks, chunk, ...) inputs — one
    compile, one output allocation, chunk-bounded temporaries."""
    statics = dict(
        cell_type=cell_type, row_floats=row_floats, nv=nv, dtype=dtype
    )
    if centers3 is not None:
        return jax.lax.map(
            lambda ic: _pack_qcand_rows_jit(
                src, ic[0], ic[1], ic[2], **statics,
            ),
            (ids3, cnt2, centers3),
        )
    return jax.lax.map(
        lambda ic: _pack_cand_rows_jit(src, ic[0], ic[1], **statics),
        (ids3, cnt2),
    )


@functools.partial(
    jax.jit,
    static_argnames=("cell_type", "row_floats", "nv", "dtype"),
)
def _pack_cand_rows_jit(
    src, ids, count_vals, *, cell_type, row_floats, nv, dtype
):
    """Pack fused candidate rows ON DEVICE from the per-cell source
    record table (``src``, _pack_src_rows_jit) — one row gather per
    candidate slot.

    One row answers the whole cold query: containment (face planes),
    interpolation weights (per-face inverse heights -> barycentric), and
    the vertex data of the first ``nv`` live point-data variables.  The
    row is a sequence of K-wide ROLES (column ``role*K + k`` belongs to
    candidate ``k``), followed by one count column (``count_vals``):

      tri/tet: [nx_f ... | ny_f ... | nz_f ... | off_f ... | invm_f ...
                | id | data(var,vtx) ... | count]
      quad:    [nx_f ... | ny_f ... | nz_f ... | off_f ...
                | vtx(v,dim) ... | id | data(var,vtx) ... | count]

    ``invm_f = 1 / (off_f - n_f . p_v(f))`` with ``v(f) = (f-1) % npc``
    the vertex opposite face f, so the barycentric weight of vertex v is
    ``(off - n . r) * invm`` of face ``(v+1) % npc`` — linear, 1 at the
    vertex, 0 on the opposite face (simplices; quads instead carry their
    vertices for the inverse-bilinear kernel, :588-641).

    The K-wide-role layout keeps each role's K candidates contiguous:
    the probe reads one role as one (K,)-wide slice per query.

    Runs JITTED with every grid array as an explicit argument (closures
    would embed the arrays as compile-time constants); the wrapper pads
    the last chunk to a fixed shape so a multi-chunk repack costs ONE
    compile.

    Invalid (padding) slots get -huge offsets so their containment
    margin can never win."""
    from ..utils.config import huge_distance

    n_rows, k_max = ids.shape
    nf = npc = geometry.N_POINTS_PER_CELL[cell_type]

    g = src[jnp.maximum(ids, 0)]  # (n, K, S) — the ONE row gather
    normals, offs, cp, vtx_data = _split_src(g, nf, npc, nv)
    offs = jnp.where(
        (ids >= 0)[..., None], offs, jnp.asarray(-huge_distance(dtype), dtype)
    )

    def roles(x):  # (n_rows, K, m) -> (n_rows, m*K), column = j*K + k
        return x.transpose(0, 2, 1).reshape(n_rows, -1)

    parts = [
        roles(normals[..., 0]),
        roles(normals[..., 1]),
        roles(normals[..., 2]),
        roles(offs),
    ]
    if cell_type == "quad":
        parts.append(roles(cp.reshape(n_rows, k_max, npc * 3)))
    parts.append(ids.astype(dtype))
    if nv:
        if cell_type != "quad":
            # Premultiply by the inverse height of each vertex (face
            # (v+1)%npc's opposite vertex is v): the barycentric weight
            # of vertex v is margin_{(v+1)%npc} * inv_height_v, so the
            # query side forms values straight from margins x data —
            # no inverse-height role in the row.
            opp = (jnp.arange(nf) - 1) % npc
            p_opp = cp[:, :, opp]  # (n_rows, K, nf, 3)
            m_opp = offs - (normals * p_opp).sum(-1)
            inv_f = 1.0 / jnp.where(m_opp == 0, 1.0, m_opp)
            iv_vertex = inv_f[..., (jnp.arange(npc) + 1) % npc]
            vtx_data = vtx_data * iv_vertex[..., None]
        parts.append(
            roles(vtx_data.transpose(0, 1, 3, 2).reshape(n_rows, k_max, -1))
        )
    parts.append(count_vals.astype(dtype)[:, None])
    rows = jnp.concatenate(parts, axis=1)
    pad = max(row_floats, rows.shape[1]) - rows.shape[1]
    return jnp.pad(rows, ((0, 0), (0, pad)))

def _build_cand_tables(
    grid: UGrid, pack_chunk: int | None = None, nv: int | None = None
) -> dict:
    """Main + overflow-extension candidate tables (see _pack_cand_rows).

    The main table's count column encodes overflow redirection: the
    exact count where it fits K, else ``K + 1 + ext_slot`` — the query
    side recovers both the overflow flag and the extension row from the
    value it already reads.  The extension rows' count column carries
    the bin's exact total count (drives the residual-walk decision on
    grids where a bin exceeds K + k_ext).

    The physical row width is the NEEDED floats for this grid's K
    rounded up to a 512-byte multiple (fast gather DMA) — cover-all
    grids (K widened to the worst bin count, cand_cover_row_bytes)
    get wider rows than config.cand_row_bytes, small-K grids narrower
    ones.

    ``pack_chunk`` overrides the per-map-step row count.  The default
    is sized from the record width so the materialized (chunk, K, S)
    record gather stays ~<= 128 MB (_pack_source_chunk) — the round-4
    nv >= 2 gather-fusion blowup (28 GB of HLO temps at a fixed 2^18
    chunk) cannot recur because the packers now do ONE explicit record
    gather whose transient the chunk rule bounds directly.

    ``nv`` overrides the fused-variable count (clamped to capacity).
    load_grid passes the checkpointed ``cand_nv`` pin so a grid whose
    variables were added with ``fuse=False`` does not silently repack
    at full capacity — and pay the repack blowup the pin exists to
    avoid — on every save/load round-trip."""
    k_max = grid.cand_ids.shape[1]
    cap_nv = _cand_capacity_nv(grid)
    nv = cap_nv if nv is None or nv < 0 else min(nv, cap_nv)
    quantized = cand_is_quantized(grid.cell_type, grid.dtype, grid.config)
    step = 512 // jnp.dtype(grid.dtype).itemsize
    if quantized:
        per = _qcand_floats_per(grid.cell_type, nv)
        overhead = 2  # count + dscale columns
    else:
        per = _cand_floats_per(grid.cell_type, nv)
        overhead = 1
    row_floats = -(-(per * k_max + overhead) // step) * step

    def bin_centers(bin_idx):
        cx, cy, cz = geometry.cand_bin_center_cols(
            grid.cand_rmin, grid.cand_inv_h,
            *geometry.cand_bin_decode(
                bin_idx, grid.cand_shape[1], grid.cand_shape[2]
            ),
        )
        return jnp.stack([cx, cy, cz], axis=1)

    centers = (
        bin_centers(jnp.arange(grid.cand_ids.shape[0], dtype=jnp.int32))
        if quantized
        else None
    )
    if grid.cand_ext_ids is not None:
        count_enc = jnp.where(
            grid.cand_count > k_max,
            k_max + 1 + jnp.maximum(grid.cand_ext_slot, 0),
            grid.cand_count,
        )
    else:
        count_enc = grid.cand_count
    out = {
        "cand_table": _pack_cand_rows(
            grid, grid.cand_ids, count_enc, row_floats, nv,
            centers=centers, chunk=pack_chunk,
        ),
        # pin the packed nv so later add_point_data can never shift
        # the probe's column derivation (see cand_fused_nv)
        "cand_nv": nv,
        # any repack invalidates the accurate-mode df-plane rows (their
        # fused values/nv would go stale); prepare_accurate rebuilds
        # them lazily, and interpolate_at_acc falls back to the
        # correct at-known-cell path meanwhile
        "cand_df_table": None,
    }
    ds_max = 0.0
    if quantized:
        ds_max = float(out["cand_table"][:, per * k_max + 1].max())
    if grid.cand_ext_ids is not None:
        k_ext = grid.cand_ext_ids.shape[1]
        # pad extension rows to a 512-byte multiple (fast gather DMA)
        ext_floats = -(-(k_ext * per + overhead) // step) * step
        over_order = jnp.argsort(grid.cand_ext_slot < 0, stable=True)[
            : grid.cand_ext_ids.shape[0]
        ]
        # ^ overflow-bin indices in ext-slot order: ext_slot is
        # assigned in ascending bin order, and stable argsort of the
        # "not overflow" flag lists those bins first in that same order
        over_count = grid.cand_count[over_order]
        out["cand_ext_table"] = _pack_cand_rows(
            grid, grid.cand_ext_ids, over_count, ext_floats, nv,
            centers=bin_centers(over_order) if quantized else None,
            chunk=pack_chunk,
        )
        if quantized:
            ds_max = max(
                ds_max,
                float(out["cand_ext_table"][:, per * k_ext + 1].max()),
            )
    else:
        out["cand_ext_table"] = None
    if quantized:
        # Margin fuzz bound of the quantized probe: offset rounding
        # (0.5 dscale) + normal rounding over |r_local| <= h/2 per dim.
        # Widens the query-side inside tolerance (ops/locate).
        inv_h = np.asarray(grid.cand_inv_h, np.float64)
        h_sum = float(np.where(inv_h > 0, 1.0 / np.where(inv_h > 0, inv_h, 1), 0.0).sum())
        out["cand_qeps"] = 0.5 * ds_max + (0.25 / QCAND_NSCALE) * h_sum
    else:
        out["cand_qeps"] = 0.0
    return out




def cand_fused_nv(grid: UGrid) -> int:
    """How many leading point-data variables are fused into the
    candidate rows.

    Once tables are packed the value is PINNED in ``grid.cand_nv``
    (set by _build_cand_tables, stored in checkpoints): the
    capacity-derived fallback below depends on ``n_point_data``, so a
    later ``add_point_data`` would silently change it and make the
    probe read the wrong row columns — or force a multi-GB repack on
    every appended variable (round-4 OOM at 1M cells).  Variables
    added after the pack are simply not fused; the fused fast paths
    gate on ``slot < cand_fused_nv`` and fall through to the generic
    interpolation for them.

    The capacity fallback (legacy checkpoints / pre-pack grids): see
    :func:`_cand_capacity_nv`."""
    if grid.cand_ids is None:
        return 0
    if grid.cand_nv >= 0:
        return grid.cand_nv
    return _cand_capacity_nv(grid)


def _cand_capacity_nv(grid: UGrid) -> int:
    """Capacity-derived fused-variable count for THIS n_point_data —
    what a (re)pack would choose.  The budget is ``cand_row_bytes``
    normally; a grid whose K doesn't even fit that row bare (nv = 0)
    is a cover-all build (K widened to the worst bin count) and
    budgets ``cand_cover_row_bytes``."""
    if grid.cand_ids is None:
        return 0
    itemsize = jnp.dtype(grid.dtype).itemsize
    k_max = grid.cand_ids.shape[1]
    if cand_is_quantized(grid.cell_type, grid.dtype, grid.config):
        # Deterministic reconstruction of the build's choice.  K was
        # chosen jointly with nv at the BUILD-time variable count,
        # which may be smaller than the current n_point_data
        # (add_point_data appends without touching the lists): accept
        # the stored K as the capacity K of any count <= the current
        # one, largest first.
        for n_try in range(grid.n_point_data, -1, -1):
            k_t, nv_t = candidate_row_capacity(
                grid.cell_type, grid.dtype, grid.config, n_try
            )
            if k_t == k_max:
                # K can plateau across variable counts (integer division
                # of the row budget), in which case the build count is
                # not recoverable from K alone; only accept an nv that
                # round-trips (a build at exactly nv_t variables would
                # choose the same layout), else keep scanning down —
                # never report more fused variables than a pack at this
                # nv would itself produce.
                k_rt, nv_rt = candidate_row_capacity(
                    grid.cell_type, grid.dtype, grid.config, nv_t
                )
                if k_rt == k_max and nv_rt == nv_t:
                    return nv_t
        # No capacity K matches: the K was cover-widened to the worst
        # bin count; the capacity nv survives iff the widened row fits
        # the larger of the two row budgets (mirrors cover_ok_q).
        _, nv_cfg = candidate_row_capacity(
            grid.cell_type, grid.dtype, grid.config, grid.n_point_data
        )
        budget = (
            max(grid.config.cand_row_bytes, grid.config.cand_cover_row_bytes)
            // itemsize
        )
        ok = _qcand_floats_per(grid.cell_type, nv_cfg) * k_max + 2 <= budget
        return nv_cfg if ok else 0
    row_floats = grid.config.cand_row_bytes // itemsize
    if _cand_floats_per(grid.cell_type, 0) * k_max + 1 > row_floats:
        row_floats = grid.config.cand_cover_row_bytes // itemsize
    nv = 0
    while (
        nv < grid.n_point_data
        and _cand_floats_per(grid.cell_type, nv + 1) * k_max + 1 <= row_floats
    ):
        nv += 1
    return nv


def _build_walk_table(grid: UGrid):
    """Packed per-cell walk rows, assembled ON DEVICE from arrays that
    are already resident: face normals | face offsets | neighbor ids |
    cell vertex coords | volume, zero-padded to a 512-byte row.
    Building on device avoids copying ~0.5 GB of mostly-padding from
    the host on million-cell grids; jitted (arrays as arguments) so the
    assembly is one device call, not a string of eager dispatches."""
    return _pack_walk_rows_jit(
        grid.face_normals, grid.face_offsets, grid.neighbors,
        grid.cell_points, grid.cell_volume, dtype=grid.dtype,
    )


@functools.partial(jax.jit, static_argnames=("dtype",))
def _pack_walk_rows_jit(
    face_normals, face_offsets, neighbors, cell_points, cell_volume,
    *, dtype
):
    n_cells = face_normals.shape[0]
    nf = face_normals.shape[1]
    npc = cell_points.shape[1]
    cols = jnp.concatenate(
        [
            face_normals.reshape(n_cells, nf * 3),
            face_offsets,
            neighbors.astype(dtype),
            cell_points.reshape(n_cells, npc * 3),
            cell_volume[:, None],
        ],
        axis=1,
    )
    row_width = 512 // jnp.dtype(dtype).itemsize
    pad = max(row_width, cols.shape[1]) - cols.shape[1]
    return jnp.pad(cols, ((0, 0), (0, pad)))


def _refine_bin_seeds(grid: UGrid, centers: np.ndarray) -> UGrid:
    """Reseed the bin table with the cell *containing* each bin center.

    The kd-tree-style nearest-center seed (geometry.build_bin_seed_table)
    can sit a few face hops from the bin itself; one batched self-locate
    of all bin centers replaces it with the containing cell, so cold
    walks start at most a bin radius from their target.  Bin centers in
    holes / outside the domain keep their nearest-center seed.
    """
    from ..ops import locate

    nbx, nby, nbz = grid.bin_shape
    inv_h = np.asarray(grid.bin_inv_h)
    h = np.divide(1.0, inv_h, out=np.zeros(3), where=inv_h > 0)
    rmin = np.asarray(grid.bin_rmin)
    ax = rmin[0] + (np.arange(nbx) + 0.5) * h[0]
    ay = rmin[1] + (np.arange(nby) + 0.5) * h[1]
    az = rmin[2] + (np.arange(nbz) + 0.5) * h[2]
    gx, gy, gz = np.meshgrid(ax, ay, az, indexing="ij")
    bc = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    if h[2] == 0:  # 2D grids: probe in the mesh plane
        bc[:, 2] = centers[:, 2].mean() if len(centers) else 0.0

    bc_dev = jnp.asarray(bc, dtype=grid.dtype)
    ic, found = jax.jit(locate.get_cell, static_argnames=())(
        grid, bc_dev, grid.bin_table
    )
    new_table = jnp.where(found, ic, grid.bin_table).astype(jnp.int32)
    new_centers = jnp.asarray(centers, dtype=grid.dtype)[new_table]
    new_pack = jnp.concatenate(
        [new_table[:, None].astype(grid.dtype), new_centers], axis=1
    )
    return dataclasses.replace(grid, bin_table=new_table, bin_pack=new_pack)


def read_grid(
    filename,
    coord_scale_factor: float | None = None,
    dtype=None,
    config: IUConfig = DEFAULT_CONFIG,
    locate_mode: str = "auto",
) -> UGrid:
    """Load a grid from a mesh file (converted+cached to .binda) or a
    .binda container directly — parity with iu_read_grid (:820-927), but
    in-process instead of shelling out to a converter subprocess."""
    import os

    from ..io.binda import read_binda
    from ..io.convert import convert_to_binda

    filename = os.fspath(filename)
    if not filename.endswith(".binda"):
        filename = convert_to_binda(filename)

    bf = read_binda(filename)

    ix = bf.index("cells")
    if ix < 0:
        raise ValueError("cells not found in binda file")
    cells = bf.read_int32(ix)
    cell_type = bf.entries[ix].metadata
    if cell_type not in geometry.CELL_TYPES:
        raise ValueError(f"Cell type {cell_type!r} not supported")

    ix = bf.index("points")
    if ix < 0:
        raise ValueError("points not found in binda file")
    points = bf.read_float64(ix)

    ix = bf.index("cell_neighbors")
    if ix < 0:
        raise ValueError("cell_neighbors not found in binda file")
    neighbors = bf.read_int32(ix)

    point_data, cell_data, icell_data = {}, {}, {}
    for i, e in enumerate(bf.entries):
        if e.name == "point_data":
            point_data[e.metadata] = bf.read_float64(i)
        elif e.name == "cell_data":
            cell_data[e.metadata] = bf.read_float64(i)
        elif e.name == "icell_data":
            icell_data[e.metadata] = bf.read_int32(i)

    return build_grid(
        points,
        cells,
        neighbors,
        cell_type,
        point_data=point_data,
        cell_data=cell_data,
        icell_data=icell_data,
        coord_scale_factor=coord_scale_factor,
        dtype=dtype,
        config=config,
        locate_mode=locate_mode,
    )


# ---------------------------------------------------------------------------
# Data registry (functional; parity with :105-247)
# ---------------------------------------------------------------------------


def get_point_data_index(grid: UGrid, name: str) -> int:
    """Index of a point-data variable, -1 if absent (:106-116)."""
    try:
        return grid.point_data_names.index(name)
    except ValueError:
        return -1


def get_cell_data_index(grid: UGrid, name: str) -> int:
    try:
        return grid.cell_data_names.index(name)
    except ValueError:
        return -1


def get_icell_data_index(grid: UGrid, name: str) -> int:
    try:
        return grid.icell_data_names.index(name)
    except ValueError:
        return -1


def _reserve(data, n_extra):
    pad = jnp.zeros((data.shape[0], n_extra), dtype=data.dtype)
    return jnp.concatenate([data, pad], axis=1)


def reserve_point_data_storage(grid: UGrid, n: int) -> UGrid:
    """Grow point-data storage by n zero-initialized columns (:204-221).

    Reserved columns don't change ``n_point_data``; a later ``add`` fills
    them without reallocating (and so without changing traced shapes).
    """
    return dataclasses.replace(grid, point_data=_reserve(grid.point_data, n))


def reserve_cell_data_storage(grid: UGrid, n: int) -> UGrid:
    return dataclasses.replace(grid, cell_data=_reserve(grid.cell_data, n))


def reserve_icell_data_storage(grid: UGrid, n: int) -> UGrid:
    return dataclasses.replace(grid, icell_data=_reserve(grid.icell_data, n))


def _f32_residual(a64):
    """Exact f64->f32 downcast remainder, elementwise (any shape)."""
    a64 = np.asarray(a64, np.float64)
    return (a64 - a64.astype(np.float32).astype(np.float64)).astype(np.float32)


def _f32_residual_column(values, n_points):
    """Accurate-mode residual of one point-data column: the exact
    f64->f32 downcast remainder as an (n_points,) f32 array (zeros when
    the input carries no f64 information).  Single definition — the
    build-time registry residual, add_point_data and set_point_data
    must all agree or the hi+lo sums diverge between paths.

    Scalars broadcast; typed non-f64 arrays (incl. device arrays, whose
    dtype is probed WITHOUT a host transfer) short-circuit to zeros.
    """
    if values is None:
        return jnp.zeros((n_points,), jnp.float32)
    dt = getattr(values, "dtype", None)
    if dt is not None and np.dtype(dt) != np.float64:
        return jnp.zeros((n_points,), jnp.float32)
    v = np.asarray(values)
    if v.dtype != np.float64:
        return jnp.zeros((n_points,), jnp.float32)
    return jnp.asarray(_f32_residual(np.broadcast_to(v, (n_points,))))


def _add_column(data, names, name, values, n_rows):
    """Fill the first reserved column, or grow by one.

    Note: each family checks its *own* capacity — the reference reuses the
    point-data count in all three adders (capacity bug, :124/:139; see
    SURVEY.md §2.2 'known bug — don't replicate').
    """
    i_var = len(names)
    if values is None:
        col = jnp.zeros((n_rows,), dtype=data.dtype)
    else:
        col = jnp.asarray(values, dtype=data.dtype).reshape(n_rows)
    if data.shape[1] > i_var:  # reserved capacity available
        data = data.at[:, i_var].set(col)
    else:
        data = jnp.concatenate([data, col[:, None]], axis=1)
    return data, names + (name,), i_var


def _refresh_cand_data(
    grid: UGrid, i_var: int | None = None, extend: bool = True
) -> UGrid:
    """Re-pack the candidate rows after a point-data mutation — they
    carry fused copies of the leading variables' vertex values.

    Pass the mutated column as ``i_var`` to skip the (multi-GB on big
    grids) repack when that column would not be fused into the rows.
    With ``extend=True`` (add_point_data) the comparison uses the
    CAPACITY nv — appending a variable that fits extends the fusion.
    With ``extend=False`` (set_point_data) the fusion set must not
    change: only a column that is CURRENTLY fused triggers a repack,
    and the repack keeps the pinned nv — otherwise updating a variable
    added with ``fuse=False`` would both pay the repack the flag exists
    to avoid and silently fuse the opted-out column."""
    if grid.cand_ids is None:
        return grid
    nv_now = cand_fused_nv(grid)
    limit = _cand_capacity_nv(grid) if extend else nv_now
    if i_var is not None and i_var >= limit:
        return grid
    return dataclasses.replace(
        grid,
        **_build_cand_tables(grid, nv=None if extend else nv_now),
    )


def add_point_data(grid: UGrid, name: str, values=None, fuse: bool = True):
    """Append a named point-data variable (iu_add_point_data, :149-161).

    Returns ``(new_grid, i_var)``.  ``values`` defaults to zeros.

    ``fuse=False`` skips extending the fused candidate rows to the new
    variable (a multi-GB repack on million-cell grids): the variable
    still interpolates correctly through the generic path, it just
    doesn't ride the one-gather fused fast path.  Use it when the
    variable feeds the tracer or at-known-cell queries only.
    """
    data, names, i_var = _add_column(
        grid.point_data, grid.point_data_names, name, values, grid.n_points
    )
    grid = dataclasses.replace(
        grid, point_data=data, point_data_names=names
    )
    if grid.point_data_lo is not None:
        # Keep the accurate-mode residual registry aligned: exact f64
        # remainder when f64 values were given, zeros otherwise.
        lo, _, _ = _add_column(
            grid.point_data_lo, grid.point_data_names[:-1], name,
            _f32_residual_column(values, grid.n_points), grid.n_points,
        )
        grid = dataclasses.replace(grid, point_data_lo=lo)
    if grid.acc_table is not None:
        from ..ops.interp_acc import build_acc_table

        grid = dataclasses.replace(grid, acc_table=build_acc_table(grid))
    if not fuse:
        return grid, i_var
    return _refresh_cand_data(grid, i_var), i_var


def add_cell_data(grid: UGrid, name: str, values=None):
    data, names, i_var = _add_column(
        grid.cell_data, grid.cell_data_names, name, values, grid.n_cells
    )
    return (
        dataclasses.replace(grid, cell_data=data, cell_data_names=names),
        i_var,
    )


def add_icell_data(grid: UGrid, name: str, values=None):
    data, names, i_var = _add_column(
        grid.icell_data, grid.icell_data_names, name, values, grid.n_cells
    )
    return (
        dataclasses.replace(grid, icell_data=data, icell_data_names=names),
        i_var,
    )


def set_point_data(grid: UGrid, i_var: int, values) -> UGrid:
    """Overwrite one point-data column (test_tetra.f90:37-40 pattern)."""
    nv = grid.n_point_data
    i_var = int(i_var)
    if not -nv <= i_var < nv:
        raise ValueError(f"i_var {i_var} outside the live point-data range")
    i_var %= max(nv, 1)  # python-style wrap, normalized so the
    #                      fused-column skip below sees a real slot
    orig = values
    values = jnp.asarray(values, dtype=grid.point_data.dtype)
    grid = dataclasses.replace(
        grid, point_data=grid.point_data.at[:, i_var].set(values)
    )
    if grid.point_data_lo is not None:
        # Keep the accurate-mode residual column in sync (same policy
        # as add_point_data: exact f64 remainder when f64 was given).
        grid = dataclasses.replace(
            grid,
            point_data_lo=grid.point_data_lo.at[:, i_var].set(
                _f32_residual_column(orig, grid.n_points)
            ),
        )
    if grid.acc_table is not None:
        from ..ops.interp_acc import update_acc_table_column

        grid = dataclasses.replace(
            grid, acc_table=update_acc_table_column(grid, i_var)
        )
    return _refresh_cand_data(grid, i_var, extend=False)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def write_vtk(grid: UGrid, filename) -> None:
    """Write the grid and all live data arrays to a .vtu file — parity
    with iu_write_vtk (:929-985)."""
    from ..io.vtk import write_vtu

    write_vtu(
        filename,
        np.asarray(grid.points, dtype=np.float64),
        np.asarray(grid.cells),
        grid.cell_type,
        point_data={
            name: np.asarray(grid.point_data[:, i], dtype=np.float64)
            for i, name in enumerate(grid.point_data_names)
        },
        cell_data={
            name: np.asarray(grid.cell_data[:, i], dtype=np.float64)
            for i, name in enumerate(grid.cell_data_names)
        },
        icell_data={
            name: np.asarray(grid.icell_data[:, i])
            for i, name in enumerate(grid.icell_data_names)
        },
    )
