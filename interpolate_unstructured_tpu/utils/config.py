"""Framework configuration and numeric constants.

The reference configures behavior via per-call arguments and compile-time
flags (SURVEY.md §5.6); here the knobs live in one dataclass that can be
passed to ``read_grid``/``build_grid``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class IUConfig:
    """Tunables for grid construction and point location."""

    # Inside-test tolerance: point is inside a cell iff
    # (r_face - r) . n >= -eps_inside for all faces
    # (m_interp_unstructured.f90:773, small_number = 1e-10)
    eps_inside: float = 1e-10

    # Meshes up to this many cells use the matmul brute-force locate
    # (exact containment over all cells in one product); larger meshes
    # use candidate bins and neighbor walks.  The crossover has not been
    # re-measured on the H100.
    bruteforce_max_cells: int = 1024

    # Default step cap for the batched neighbor walk. The reference walks
    # unbounded (huge(1), :431); a bounded lax.while_loop needs a finite
    # cap. Seeded walks take <10 steps; 1024 covers domain-crossing warm
    # walks while bounding the cost of numerical face ping-pong.
    max_walk_steps: int = 1024

    # Step cap for the short walks inside RK sub-steps of the tracer
    # (each spans at most max_dx). A capped walk is treated as an
    # invalid position: the step shrinks and retries (:1081-1097).
    trace_walk_max_steps: int = 128

    # Cold-start seed backend: "bins" = O(1) uniform-grid seed table
    # (the default); "kdtree" = exact nearest-cell-center via the
    # stackless batched kd-tree (kdtree2-equivalent seeding quality,
    # m_interp_unstructured.f90:272-288, at O(log n) gather cost).
    seed_mode: str = "bins"

    # Bin-seed table sizing: bins ~= bins_per_cell * n_cells.
    # Finer bins give better cold-start seeds (shorter walks) at the
    # cost of seed-table memory (16 bytes/bin for the packed table).
    bins_per_cell: float = 4.0
    max_bins: int = 1 << 23

    # Per-bin candidate tables (walk-mode grids): each bin of a regular
    # grid stores the cells that intersect it, packed with their face
    # planes into one wide row — a cold query resolves containment with
    # a SINGLE row gather instead of a seeded multi-step walk (each walk
    # step is itself a full gather round).  Bins whose complete list
    # exceeds the row capacity fall back to a walk seeded at the best
    # candidate.  The row width (K=15 tet candidates at 1 KB) has not
    # been re-tuned on the H100.
    use_candidate_bins: bool = True
    # 2 bins/cell (vs 1) cuts the mean per-bin candidate count 14 -> 9
    # and the overflow-probe rate 4.8% -> 2.2% on a ~1M-cell tet mesh,
    # at 2x candidate-table memory. Gather traffic per query is
    # unchanged (row size is set by K, not the bin count).
    cand_bins_per_cell: float = 2.0
    cand_max_bins: int = 1 << 22
    cand_row_bytes: int = 1024
    # Quantized candidate rows (f32 tri/tet grids): the probe geometry
    # is stored as int16 — unit face normals at a fixed 1/32767 scale
    # and face offsets in the query bin's LOCAL frame at a per-row
    # scale — while interpolation comes from exact f32 per-cell value
    # PLANES (value = g . r_local + c, linear for simplices).  13 vs 21
    # floats per tet candidate cuts the gathered row ~1.5-2x.  The
    # quantization fuzz (~h/2e4, grid
    # scalar cand_qeps) widens the inside tolerance: sub-fuzz boundary
    # verdicts may differ from the f32 planes, interior points never
    # (their true margin >= 0 keeps every containing cell in reach).
    cand_quantized: bool = True
    # Overflow bins store their remaining candidates (rank K..K+k_ext)
    # in an extension table probed by the same kernel — the cold path
    # never walks unless a bin exceeds K + cand_ext_max_k candidates.
    cand_ext_max_k: int = 32
    # Candidate rows also carry interpolation payload (per-face inverse
    # heights for barycentric weights + vertex data of the first live
    # point-data variables), so a cold scalar interpolation resolves in
    # ONE gather.  Fusing variables costs candidate slots; stop fusing
    # before K drops below this floor (more candidates = fewer
    # fallback walks).  7 lets f32 quads (29+4*nv floats/candidate)
    # keep one fused variable; 2D bins rarely exceed 4-5 cells anyway.
    cand_min_k: int = 7
    # Cover-all rows: when the worst bin's COMPLETE candidate list fits
    # a row of at most this many bytes, K widens to that worst count
    # and the overflow machinery (extension table, miss compaction,
    # fallback probe) vanishes from the query path entirely — every
    # miss is exact.  Wider rows trade gathered bytes for the deleted
    # fallback; the trade has not been re-measured on the H100.  Set
    # to 0 to disable (always use K from cand_row_bytes).
    cand_cover_row_bytes: int = 2048
    # Candidate-bin construction backend: "auto" runs the device
    # pipeline (ops/cand_build.py, ~50x the single-core host loop on
    # million-cell meshes) above the cell-count threshold and the host
    # reference builder below it (or when the mesh's AABB spans exceed
    # the device offset budget); "host"/"device" force a backend.
    cand_build: str = "auto"
    cand_build_device_min_cells: int = 100_000
    # Fallback buffer: unresolved queries compact into
    # b / cand_fallback_divisor slots before the extension probe.  The
    # buffer sits just above the ~2.2% overflow-miss rate of uniform
    # queries on a ~1M-cell tet mesh; batches that overflow it take the
    # chunked full-width path (slower, still correct).
    cand_fallback_divisor: int = 32
    # Candidate-phase query tiling for the XLA probe: its gathered rows
    # materialize row_bytes per query (a 10M-query batch at 1KB rows
    # would need 10 GB unchunked).  The chunk is sized in gathered
    # BYTES and divided by the grid's physical row width at query time
    # (locate._cand_chunk): 1 KB rows -> 64k queries, 2 KB cover rows
    # -> 32k.  Not re-tuned on the H100.  The GPU kernel
    # (ops/pallas_cand.py) gathers nothing and ignores it.
    cand_chunk_bytes: int = 64 << 20
    # Explicit per-chunk query count; None derives it from
    # cand_chunk_bytes.
    cand_chunk_queries: int | None = None

    # Two-phase walk: run phase1 steps on the full batch, then compact
    # the (few) still-walking queries into a batch//divisor buffer so
    # straggler rounds stop paying full-batch gather cost.
    walk_phase1_steps: int = 2
    walk_compact_divisor: int = 8
    walk_compact_min_batch: int = 1 << 16

    # After building the grid, relocate every bin center with the walk
    # itself and reseed the bin table with the *containing* cell
    # (nearest-center seeds can sit a few hops away); shortens cold
    # walks at the cost of one batched locate at build time.
    refine_bin_seeds: bool = True


DEFAULT_CONFIG = IUConfig()


def resolve_config(config: IUConfig, dtype, rmin, rmax) -> IUConfig:
    """Scale ``eps_inside`` to the compute dtype and domain extent.

    The reference's fixed 1e-10 assumes float64 with O(1) coordinates;
    for float32 grids it sits below margin rounding noise, so near-face
    queries would be misreported as not-found.  The resolved tolerance
    is ``max(eps_inside, 32 * eps(dtype) * max|coord|)`` — a no-op in
    float64 on O(1) domains (3e-14 < 1e-10), a few-ulp band in float32.
    """
    extent = float(
        max(np.max(np.abs(np.asarray(rmin))), np.max(np.abs(np.asarray(rmax))))
    )
    eps = max(
        config.eps_inside, 32.0 * float(np.finfo(dtype).eps) * max(extent, 1.0)
    )
    if eps != config.eps_inside:
        config = dataclasses.replace(config, eps_inside=eps)
    return config


def tiny_distance(dtype) -> float:
    """Degenerate-walk short-circuit threshold (reference: 1e-100, :20).

    Scaled to the compute dtype: 1e-100 underflows float32, so use a value
    safely below any meaningful float32 distance instead.
    """
    if np.dtype(dtype) == np.float32:
        return 1e-30
    return 1e-100


def huge_distance(dtype) -> float:
    """Sentinel 'no face hit' distance (reference: 1e100, :738)."""
    if np.dtype(dtype) == np.float32:
        return 1e30
    return 1e100


def walk_tolerances(dtype, rmin, rmax):
    """(nudge, eps_arrive) shared by every walk consumer.

    ``nudge``: forward overshoot past a crossed face — under batched f32
    rounding the post-hop position can land on the wrong side of the
    face it just crossed, producing zero-length A<->B hop cycles
    (livelocks the tracer's shrink-and-retry).  A few-ulp overshoot
    guarantees progress and is far below the inside-test tolerance.

    ``eps_arrive``: arrival band absorbing the walk's own rounding so a
    target exactly ON a face can't coin-flip between "arrived" and
    "crossed" (hull points would randomly report as outside).
    Deliberately a few-ulp band like ``nudge`` — NOT eps_inside: at
    1e-10 the tracer would accept sub-step positions measurably outside
    their cell, where the unsigned-area kernels lose linearity
    (reflection at the face, m_interp_unstructured.f90:542-549).

    One definition on purpose: every walk consumer (ops/locate.py and
    the tracer's sub-step walks in trace.py) must agree on
    arrival/containment at faces.
    """
    import jax.numpy as jnp

    nudge = (
        16.0
        * jnp.finfo(dtype).eps
        * jnp.maximum(jnp.max(jnp.abs(rmin)), jnp.max(jnp.abs(rmax)))
    ).astype(dtype)
    return nudge, 4.0 * nudge
