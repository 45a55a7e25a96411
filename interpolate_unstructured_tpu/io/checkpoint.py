"""Grid checkpointing: save/load a fully preprocessed ``UGrid``.

The reference's only persistence is the ``.binda`` cache of the
*converted* mesh (convert_to_binary.py:180-183) — preprocessing
(normals, volumes, kd-tree) reruns on every load.  Here the whole
preprocessed grid state — including the derived tables (face planes,
packed walk rows, bin seed table) — round-trips through the same binda
container format, so reloading a large grid costs one mmap-style read
instead of minutes of host preprocessing.

The container is self-describing: scalar metadata rides in the entry
metadata strings, data-family names in per-column entries, so the files
remain readable by any binda tool (including the Fortran reader).
"""

from __future__ import annotations

import dataclasses
import time

import jax.numpy as jnp
import numpy as np

from .binda import BindaWriter, read_binda

# v4 adds overflow-extension candidate lists; v5 sheds the two
# device-derivable heavyweights from the container: cell_points
# (= points[cells] — a pure gather, so deriving it at load is
# bit-exact in every dtype path) and the zero-padded cand_ids
# rectangle, stored ragged as cand_flat + cand_count instead (K=24
# cover-widened rows average ~10 live slots at 1M cells, so ~156 MB
# less is read and copied to the device on every load).
_FORMAT_VERSION = "5"

# UGrid array leaves stored verbatim (name -> attribute)
_ARRAY_FIELDS = [
    "points",
    "cells",
    "neighbors",
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
]

# Optional leaves: stored when present, reconstructed/None otherwise.
# The packed derived tables (walk_table, cand_table) are NOT stored —
# they are assembled on device from the arrays above at load time
# (models.grid._build_walk_table/_build_cand_table), saving ~1.5 GB of
# checkpoint size per million-cell grid.  Old checkpoints that do carry
# a grid/walk_table entry still load (it is simply used as saved).
_OPTIONAL_FIELDS = [
    "kd_node_points",
    "kd_node_ids",
    "cand_count",
    "cand_rmin",
    "cand_inv_h",
    "cand_ext_ids",
    "cand_ext_slot",
    # accurate-mode float64 residuals (f32 grids; ops.interp_acc).
    # acc_table itself is derived — rebuilt by prepare_accurate.
    "points_lo",
    "point_data_lo",
]


def _expand_cand_rows(flat, counts, k):
    """Re-expand ragged v5 candidate lists to the (bins, K) rectangle
    on device (row-major live slots -> zero-padded rows of -1)."""
    import functools

    import jax

    @functools.partial(jax.jit, static_argnames=("k",))
    def expand(flat, counts, *, k):
        # counts can exceed K (overflow-extension entries are counted);
        # the stored row carries the first min(count, K) slots
        eff = jnp.minimum(counts, k)
        offs = jnp.cumsum(eff) - eff
        kk = jnp.arange(k, dtype=jnp.int32)
        idx = offs[:, None] + kk[None, :]
        vals = jnp.take(flat, idx, mode="clip")
        return jnp.where(kk[None, :] < eff[:, None], vals, -1)

    if flat.size == 0:
        return jnp.full((counts.shape[0], k), -1, dtype=jnp.int32)
    return expand(flat, counts, k=k)


def save_grid(grid, filename) -> None:
    """Serialize a preprocessed grid (arrays + registry names +
    static metadata) into a binda container."""
    w = BindaWriter()
    meta = ",".join(
        [
            _FORMAT_VERSION,
            grid.cell_type,
            grid.locate_mode,
            "x".join(str(s) for s in grid.bin_shape),
            str(grid.kd_max_depth),
            "x".join(str(s) for s in grid.cand_shape),
            "1" if grid.cand_ext_covers else "0",
            str(grid.cand_nv),
            # v5: the padded candidate-list width K — cand_ids is
            # stored ragged, so its rectangle shape must ride here
            str(-1 if grid.cand_ids is None else grid.cand_ids.shape[1]),
        ]
    )
    w.add_entry("ugrid_header", np.zeros(1, dtype=np.int32), meta)
    fields = _ARRAY_FIELDS + _OPTIONAL_FIELDS
    for name in fields:
        value = getattr(grid, name)
        if value is None:  # optional leaves (kd-tree seed backend)
            continue
        arr = np.asarray(value)
        orig_dtype = str(arr.dtype)  # before the bool cast; one transfer
        if arr.dtype == np.bool_:
            arr = arr.astype(np.int32)
        w.add_entry(f"grid/{name}", arr, orig_dtype)
    if grid.cand_ids is not None:
        # Ragged candidate lists: live slots only, row-major.  The
        # (bins, K) rectangle is re-expanded on device at load from
        # cand_count (stored above).
        ids = np.asarray(grid.cand_ids)
        # cand_count counts ALL candidates of a bin including the
        # overflow-extension entries, so it can exceed K: the main row
        # holds the first min(count, K), front-packed
        cnt = np.minimum(np.asarray(grid.cand_count), ids.shape[1])
        mask = np.arange(ids.shape[1], dtype=np.int32)[None, :] < cnt[:, None]
        w.add_entry("grid/cand_flat", ids[mask], "int32")
    for i, nm in enumerate(grid.point_data_names):
        w.add_entry("point_data_name", np.array([i], dtype=np.int32), nm)
    for i, nm in enumerate(grid.cell_data_names):
        w.add_entry("cell_data_name", np.array([i], dtype=np.int32), nm)
    for i, nm in enumerate(grid.icell_data_names):
        w.add_entry("icell_data_name", np.array([i], dtype=np.int32), nm)
    w.write_to_file(filename)


def load_grid(filename, config=None, dtype=None, resave_on_rebuild=False,
              timings=None):
    """Reload a grid saved by :func:`save_grid` — no preprocessing.

    ``timings``: optional dict, filled with the load's phase split —
    ``read_s`` (checkpoint bytes -> host arrays), ``rebuild_s``
    (candidate-list rebuild, 0 on a config-matching load), and
    ``tables_s`` (on-device walk/candidate table repack, INCLUDING any
    one-off jit compile of the pack kernels — the first load after a
    code change compiles here, later loads hit the compile cache).

    The saved float dtype is restored exactly.  Loading a float64
    checkpoint in a session without ``jax_enable_x64`` raises instead
    of silently downcasting (which would also corrupt the float-encoded
    neighbor ids in the packed walk table on large grids); pass
    ``dtype=jnp.float32`` to downcast explicitly — that path re-applies
    ``build_grid``'s 2^24-cell float32 guard.

    When the stored candidate lists no longer match this session's
    config (capacity/bin-shape drift), they are rebuilt on load — a
    minutes-scale cost on million-cell grids.  ``resave_on_rebuild``
    writes the refreshed grid back to ``filename`` so the cost is paid
    once, not on every subsequent load.
    """
    import jax

    from ..models.grid import UGrid
    from ..utils.config import DEFAULT_CONFIG

    want_timings = timings is not None
    if timings is None:
        timings = {}
    t0 = time.perf_counter()
    bf = read_binda(filename)
    ix = bf.index("ugrid_header")
    if ix < 0:
        raise ValueError(f"{filename} is not a saved UGrid container")
    parts = bf.entries[ix].metadata.split(",")
    version, cell_type, locate_mode, bin_shape_s = parts[:4]
    if version not in ("1", "2", "3", "4", "5"):
        raise ValueError(f"Unsupported grid checkpoint version {version}")
    kd_max_depth = int(parts[4]) if len(parts) > 4 else 0
    bin_shape = tuple(int(s) for s in bin_shape_s.split("x"))
    cand_shape = (
        tuple(int(s) for s in parts[5].split("x"))
        if len(parts) > 5
        else (1, 1, 1)
    )
    ext_covers = parts[6] == "1" if len(parts) > 6 else True
    cand_nv = int(parts[7]) if len(parts) > 7 else -1
    cand_k = int(parts[8]) if len(parts) > 8 else -1  # v5 ragged width

    host_arrays = {}
    for i, e in enumerate(bf.entries):
        if e.name.startswith("grid/"):
            # binda readers widen (int64/float64); restore the exact
            # dtype recorded at save time
            host_arrays[e.name[len("grid/") :]] = bf.read(i).astype(e.metadata)

    saved_dtype = host_arrays["points"].dtype
    target = saved_dtype if dtype is None else np.dtype(dtype)
    if target == np.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            f"{filename} was saved in float64 but jax_enable_x64 is off; "
            "enable x64 or pass dtype=jnp.float32 to downcast explicitly"
        )
    n_cells = host_arrays["cells"].shape[0]
    if target == np.float32 and n_cells >= (1 << 24):
        raise ValueError(
            "float32 grids support up to 2^24 cells (packed walk table); "
            "load with dtype=jnp.float64"
        )

    arrays = {}
    for name, arr in host_arrays.items():
        if arr.dtype.kind == "f" and arr.dtype != target:
            arr = arr.astype(target)
        arrays[name] = jnp.asarray(arr)

    # v5 sheds device-derivable leaves from the container; they are
    # derived here on the device:
    if "cell_points" not in arrays:
        # points[cells] is a pure gather — casting commutes with
        # indexing, so deriving it here is bit-exact in every dtype
        # path (including the f64 -> f32 downcast load)
        arrays["cell_points"] = arrays["points"][arrays["cells"]]
    flat = arrays.pop("cand_flat", None)
    if flat is not None:
        arrays["cand_ids"] = _expand_cand_rows(
            flat, arrays["cand_count"], cand_k
        )

    def names_of(kind):
        return tuple(
            bf.entries[i].metadata for i in bf.indices(f"{kind}_name")
        )

    from ..utils.config import resolve_config

    config = resolve_config(
        config or DEFAULT_CONFIG,
        target,
        host_arrays["rmin"],
        host_arrays["rmax"],
    )
    timings["read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = UGrid(
        **arrays,
        cell_type=cell_type,
        bin_shape=bin_shape,
        cand_shape=cand_shape,
        cand_ext_covers=ext_covers,
        cand_nv=cand_nv,
        kd_max_depth=kd_max_depth,
        point_data_names=names_of("point_data"),
        cell_data_names=names_of("cell_data"),
        icell_data_names=names_of("icell_data"),
        locate_mode=locate_mode,
        config=config,
    )
    if grid.cand_ids is not None:
        from ..models.grid import candidate_row_capacity
        from ..ops.geometry import NDIM_OF_CELL_TYPE, _bin_grid_shape

        # Capacity is evaluated at the BUILD-time fused-variable count
        # (the cand_nv pin), not the current n_point_data: variables
        # appended after the build (fuse=False) shrink the capacity K
        # for a hypothetical repack but say nothing about the stored
        # lists — comparing against the inflated count manufactured a
        # spurious K mismatch that silently rebuilt the candidate
        # lists on EVERY load and discarded the pin (the multi-GB
        # repack fuse=False exists to avoid).  Pre-v4 checkpoints
        # (pin -1) keep the old n_point_data-based derivation.
        cap_n = (
            min(cand_nv, grid.n_point_data)
            if cand_nv >= 0
            else grid.n_point_data
        )
        k_max, _cap_nv = candidate_row_capacity(
            cell_type, target, config, n_point_data=cap_n
        )
        # The stored K is legitimate either as this session's capacity
        # K or as a cover-widened K (= the worst bin's exact count,
        # IUConfig.cand_cover_row_bytes) — recompute what this config
        # would choose so a cover checkpoint doesn't rebuild on every
        # load.
        from ..models.grid import _make_cover_ok

        cover_ok = _make_cover_ok(cell_type, target, config, _cap_nv, k_max)
        # host_arrays still holds the counts — reading them back off
        # the device would add a blocking round-trip to every load
        max_count = int(host_arrays["cand_count"].max(initial=0))
        want_k = max_count if cover_ok(max_count) else k_max
        # Bin shape this session's config would choose (deterministic
        # in (bbox, ndim, target count)) — a mismatch means the save
        # used a different cand_bins_per_cell / cand_max_bins
        want_shape, _, _, _ = _bin_grid_shape(
            host_arrays["rmin"].astype(np.float64),
            host_arrays["rmax"].astype(np.float64),
            NDIM_OF_CELL_TYPE[cell_type],
            min(
                max(int(config.cand_bins_per_cell * n_cells), 1),
                config.cand_max_bins,
            ),
        )
        # The save-time shape came from exact f64 point bounds while
        # rmin/rmax were stored in the grid dtype, so np.round inside
        # _bin_grid_shape can legitimately flip a dim by one on an f32
        # grid — tolerate that; real config changes move dims by >= 2.
        shape_changed = any(
            abs(int(w) - int(s)) > 1
            for w, s in zip(want_shape, grid.cand_shape)
        )
    rebuilt = grid.cand_ids is not None and (
        target != saved_dtype
        or grid.cand_ids.shape[1] != want_k
        or shape_changed
        or (grid.cand_ext_slot is None and config.cand_ext_max_k > 0)
    )
    if rebuilt:
        # Rebuild when the stored lists no longer match this session:
        # (a) a coarser load dtype widens the query-side inside
        # tolerance past the save-time inflation, which could admit
        # points into cells filtered out of their bin, (b) a K
        # mismatch (row layout/capacity changed since the save) would
        # silently overflow or underfill the packed rows, (c) a pre-v4
        # checkpoint lacks the overflow-extension lists.
        from ..models.grid import build_candidate_bins_dispatch
        from ..ops.geometry import NDIM_OF_CELL_TYPE

        if "cell_points" not in host_arrays:  # v5 container
            host_arrays["cell_points"] = host_arrays["points"][
                host_arrays["cells"]
            ]
        (
            cand_ids, cand_count, cand_shape, cand_rmin, cand_inv_h,
            ext_ids, ext_slot,
        ) = build_candidate_bins_dispatch(
            host_arrays["cell_points"].astype(np.float64),
            host_arrays["face_normals"].astype(np.float64),
            host_arrays["face_offsets"].astype(np.float64),
            host_arrays["rmin"].astype(np.float64),
            host_arrays["rmax"].astype(np.float64),
            NDIM_OF_CELL_TYPE[cell_type],
            k_max,
            target,
            config,
            cover_ok=cover_ok,
        )
        grid = dataclasses.replace(
            grid,
            cand_ids=jnp.asarray(cand_ids),
            cand_count=jnp.asarray(cand_count),
            cand_shape=cand_shape,
            cand_rmin=jnp.asarray(cand_rmin, dtype=target),
            cand_inv_h=jnp.asarray(cand_inv_h, dtype=target),
            cand_ext_ids=(
                jnp.asarray(ext_ids) if ext_ids.shape[1] else None
            ),
            cand_ext_slot=jnp.asarray(ext_slot),
            # cand_ids.shape[1], not the capacity k_max: the builder
            # may have cover-widened K to the worst bin
            cand_ext_covers=bool(
                int(np.asarray(cand_count).max(initial=0))
                <= cand_ids.shape[1] + ext_ids.shape[1]
            ),
            # The candidate lists changed, so the checkpointed fused-
            # variable pin no longer describes them: clear it BEFORE the
            # resave below, or the rebuilt file would permanently pin
            # the pre-rebuild count (and every later load — which sees
            # matching lists and honors the pin — would fuse fewer
            # variables than this session packs at).
            cand_nv=-1,
        )
        if resave_on_rebuild and target == saved_dtype:
            # Never resave across a dtype change: overwriting a float64
            # master checkpoint with a downcast grid would destroy the
            # higher-precision original.
            save_grid(grid, filename)
    timings["rebuild_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if grid.walk_table is None:  # build_grid always carries one
        from ..models.grid import _build_walk_table

        grid = dataclasses.replace(grid, walk_table=_build_walk_table(grid))
    if grid.cand_ids is not None:
        from ..models.grid import _build_cand_tables

        # Honor the checkpointed fused-variable pin (variables added
        # with fuse=False stay unfused across the round-trip); after a
        # candidate-list rebuild the row layout changed, so the pin is
        # stale and the pack re-derives capacity nv.
        grid = dataclasses.replace(
            grid,
            **_build_cand_tables(
                grid, nv=None if rebuilt else grid.cand_nv
            ),
        )
        if want_timings:
            # Only block when the caller asked for phase timings: a plain
            # load can overlap the async table repack (and its compile)
            # with subsequent host work.
            jax.block_until_ready(grid.cand_table)
    timings["tables_s"] = time.perf_counter() - t0
    return grid
