"""Multi-chip scaling: query batches sharded over a device mesh.

The reference is strictly serial (SURVEY.md §2.3: no MPI/NCCL/OpenMP);
its batched replacement (SURVEY.md §5.8) is:

* mesh arrays **replicated** per device (small relative to HBM),
* query batches **sharded** over devices on a 1-D ``data`` mesh axis,
* ``shard_map`` so each device's neighbor-walk ``while_loop`` exits as
  soon as *its* shard converges (no per-step global all-reduce),
* communication is just the scatter/gather of query inputs and results
  — the hot loop needs no collectives because the grid is replicated.
  The mesh is 1-D: every device is treated alike, so it needs no
  topology-aware shaping.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import interp, locate
from .. import trace as trace_mod

DATA_AXIS = "data"


def make_mesh(devices=None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D device mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.array(devices), (axis_name,))


def replicate_grid(grid, mesh: Mesh):
    """Place every grid leaf fully replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(grid, jax.tree.map(lambda _: sharding, grid))


def shard_batch(x, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Shard the leading (batch) axis over the mesh, padding to a
    multiple of the device count.  Returns (sharded_x, original_b)."""
    n = mesh.shape[axis_name]
    b = x.shape[0]
    pad = (-b) % n
    if pad:
        x = jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)], axis=0)
    spec = P(axis_name, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec)), b


def _grid_spec(grid):
    return jax.tree.map(lambda _: P(), grid)


def sharded_interpolate_at(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Build a jitted, shard_mapped version of ``interpolate_at``.

    Returns ``f(grid, r, i_vars, guess=None) -> (values, i_cell, found)``
    with ``r``/``guess`` sharded on the batch axis and the grid
    replicated.  Each device walks only its own queries.

    ``i_vars`` must be concrete (python ints or a host/committed array):
    it is captured STATICALLY per (i_vars, has-guess) signature — a
    traced i_vars inside the shard_map body would silently disable the
    fused candidate-row fast path that answers locate AND interpolation
    in one gather (CLAUDE.md: static fast-path checks must read raw
    Python values).  Omit ``guess`` on cold batches for the same
    reason; pass the previous cells only when warm-starting.
    """
    import numpy as np

    cache = {}

    def run(grid, r, i_vars, guess=None):
        iv = tuple(int(v) for v in np.asarray(i_vars).reshape(-1))
        has_guess = guess is not None
        fn = cache.get((iv, has_guess))
        if fn is None:
            def local(grid, r, *g):
                return interp.interpolate_at(
                    grid, r, list(iv), g[0] if has_guess else None
                )

            spec_b = P(axis_name)
            fn = jax.jit(
                jax.shard_map(
                    local,
                    mesh=mesh,
                    check_vma=False,
                    in_specs=(_grid_spec(grid), P(axis_name, None))
                    + ((spec_b,) if has_guess else ()),
                    out_specs=(P(axis_name, None), spec_b, spec_b),
                )
            )
            cache[(iv, has_guess)] = fn
        return fn(*((grid, r) + ((guess,) if has_guess else ())))

    return run


def sharded_interpolate_at_acc(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Sharded accurate-mode (compensated-f32) interpolation.

    Returns ``f(grid, r, i_vars) -> (vals_hi, vals_lo, found, i_cell)``
    with the batch sharded and the grid (including the df-plane
    candidate table built by ``prepare_accurate``) replicated.
    ``i_vars`` is captured statically per signature like
    :func:`sharded_interpolate_at`.
    """
    import numpy as np

    from ..ops import interp_acc

    cache = {}

    def run(grid, r, i_vars):
        iv = tuple(int(v) for v in np.asarray(i_vars).reshape(-1))
        fn = cache.get(iv)
        if fn is None:
            def local(grid, r):
                return interp_acc.interpolate_at_acc(grid, r, iv)

            spec_b = P(axis_name)
            fn = jax.jit(
                jax.shard_map(
                    local,
                    mesh=mesh,
                    check_vma=False,
                    in_specs=(_grid_spec(grid), P(axis_name, None)),
                    out_specs=(
                        P(axis_name, None), P(axis_name, None),
                        spec_b, spec_b,
                    ),
                )
            )
            cache[iv] = fn
        return fn(grid, r)

    return run


def sharded_get_cell(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Sharded point location: ``f(grid, r, guess) -> (i_cell, found)``."""

    def local(grid, r, guess):
        return locate.get_cell(grid, r, guess)

    def run(grid, r, guess):
        f = jax.shard_map(
            local,
            mesh=mesh,
            check_vma=False,
            in_specs=(_grid_spec(grid), P(axis_name, None), P(axis_name)),
            out_specs=(P(axis_name), P(axis_name)),
        )
        return f(grid, r, guess)

    return jax.jit(run)


def sharded_get_cell_scalar_at(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Sharded piecewise-constant cell-data lookup
    (iu_get_cell_scalar_at, m_interp_unstructured.f90:436-448):
    ``f(grid, r, i_var, guess=None) -> (vals, i_cell, found)`` with the
    batch sharded and the grid replicated.  ``i_var`` is captured
    statically per (i_var, has-guess) signature — same rationale as
    :func:`sharded_interpolate_at`."""
    return _sharded_cell_lookup(mesh, axis_name, interp.get_cell_scalar_at)


def sharded_get_icell_scalar_at(mesh: Mesh, axis_name: str = DATA_AXIS):
    """Sharded integer cell-data lookup (iu_get_icell_scalar_at,
    m_interp_unstructured.f90:450-462); see
    :func:`sharded_get_cell_scalar_at`."""
    return _sharded_cell_lookup(mesh, axis_name, interp.get_icell_scalar_at)


def _sharded_cell_lookup(mesh, axis_name, lookup_fn):
    cache = {}

    def run(grid, r, i_var, guess=None):
        iv = int(i_var)
        has_guess = guess is not None
        fn = cache.get((iv, has_guess))
        if fn is None:
            def local(grid, r, *g):
                return lookup_fn(grid, r, iv, g[0] if has_guess else None)

            spec_b = P(axis_name)
            fn = jax.jit(
                jax.shard_map(
                    local,
                    mesh=mesh,
                    check_vma=False,
                    in_specs=(_grid_spec(grid), P(axis_name, None))
                    + ((spec_b,) if has_guess else ()),
                    out_specs=(spec_b, spec_b, spec_b),
                )
            )
            cache[(iv, has_guess)] = fn
        return fn(*((grid, r) + ((guess,) if has_guess else ())))

    return run


def sharded_trace(mesh: Mesh, axis_name: str = DATA_AXIS, **trace_kwargs):
    """Sharded field-line tracing over a batch of seed points.

    Returns ``f(grid, y0, i_field, trace_table=None) -> TraceResult``
    with trajectories sharded over devices; each device's RK23
    while_loop runs until its own trajectories terminate.

    The fused per-cell trace table is built ONCE outside the shard_map
    (replicated, like the grid) rather than per call inside each
    shard (a 1M-cell table is 244 MB in f32).  Pass a
    prebuilt :func:`~interpolate_unstructured_tpu.build_trace_table`
    result to reuse it across repeated calls over the same field.
    """

    def local(grid, table, y0, i_field):
        return trace_mod.integrate_along_field(
            grid, y0, i_field, trace_table=table, **trace_kwargs
        )

    def run(grid, y0, i_field, trace_table=None):
        if trace_table is None:
            trace_table = trace_mod.build_trace_table(grid, i_field)
        f = jax.shard_map(
            local,
            mesh=mesh,
            check_vma=False,
            in_specs=(_grid_spec(grid), P(), P(axis_name, None), P()),
            out_specs=trace_mod.TraceResult(
                y=P(axis_name, None, None),
                y_field=P(axis_name, None, None),
                n_steps=P(axis_name),
                boundary_material=P(axis_name),
                n_iterations=P(axis_name),
            ),
        )
        return f(grid, trace_table, y0, i_field)

    return jax.jit(run)

# ---------------------------------------------------------------------------
# Multi-host input pipeline (SURVEY.md §5.8: "multi-host DCN only for
# input distribution and result collection")
# ---------------------------------------------------------------------------


def distribute_queries(r_local, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Assemble a globally-sharded query batch from per-process blocks.

    Each host process contributes the queries it read/generated locally
    (``r_local``); the result is one global device array sharded over
    the mesh's batch axis, with each block resident on its contributing
    process's local devices — no host ever materializes the full batch,
    and the only cross-host traffic is metadata.  In a single-process
    run this degrades to :func:`shard_batch`.

    Local blocks are padded (repeating the last row) so every DEVICE
    shard is the same size on every process.  The per-device size is
    agreed on across processes (allgather of each process's ceil
    requirement): processes may contribute UNEQUAL query counts, but
    every process must construct the SAME global shape — per-process
    inferred shapes would make the processes compile different programs
    around any cross-process collective (undefined behavior under
    JAX's multi-controller SPMD contract).

    Returns ``(r_global, local_b)`` where ``local_b`` is this process's
    unpadded contribution (for :func:`collect_results` trimming).
    """
    import numpy as np

    r_local = np.asarray(r_local)
    b_local = r_local.shape[0]
    n_local = max(
        1, len([d for d in mesh.devices.flat if d.process_index
                == jax.process_index()]),
    )
    per_device = -(-b_local // n_local) if b_local else 1
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        per_device = int(
            np.max(
                multihost_utils.process_allgather(
                    np.asarray([per_device]), tiled=False
                )
            )
        )
    pad = per_device * n_local - b_local
    if pad:
        filler = (
            np.repeat(r_local[-1:], pad, axis=0)
            if b_local
            else np.zeros((pad,) + r_local.shape[1:], r_local.dtype)
        )
        r_local = np.concatenate([r_local, filler], axis=0)
    spec = P(axis_name, *([None] * (r_local.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    global_shape = (
        per_device * mesh.devices.size,
    ) + r_local.shape[1:]
    r_global = jax.make_array_from_process_local_data(
        sharding, r_local, global_shape
    )
    return r_global, b_local


def collect_results(x, local_b: int | None = None):
    """Bring a sharded result back to every host (numpy).

    Single-process: a plain device fetch.  Multi-host: an all-gather of
    the addressable shards over DCN (``multihost_utils``), so every
    process sees the full result — mirroring how the serial reference
    returns results to its (single) caller.  ``local_b`` trims the
    padding added by :func:`distribute_queries` /
    :func:`shard_batch` once the global batch is reassembled.
    """
    import numpy as np

    if jax.process_count() == 1:
        out = np.asarray(x)
        if local_b is not None:
            out = out[:local_b]
        return out

    # Processes may contribute UNEQUAL query counts (and hold unequal
    # device counts), so the per-process blocks have different sizes —
    # a direct allgather of the addressable data would be a collective
    # shape mismatch (gloo aborts).  Equal-shape protocol instead:
    # (1) allgather each process's (padded_block, valid) size pair,
    # (2) copy the local block into a max-size zero buffer,
    # (3) allgather the equal-size buffers, (4) trim each block with
    # its own sizes and concatenate in process order.  Padding sits at
    # the END of each process's block (distribute_queries), and meshes
    # built from jax.devices() order lay process blocks out
    # contiguously along the batch axis.
    from jax.experimental import multihost_utils

    shards = sorted(
        x.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    local = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
    padded_local = local.shape[0]
    valid_local = padded_local if local_b is None else local_b
    sizes = np.asarray(
        multihost_utils.process_allgather(
            np.asarray([padded_local, valid_local]), tiled=False
        )
    ).reshape(jax.process_count(), 2)
    max_padded = int(sizes[:, 0].max())
    buf = np.zeros((max_padded,) + local.shape[1:], dtype=local.dtype)
    buf[:padded_local] = local
    gathered = np.asarray(
        multihost_utils.process_allgather(buf, tiled=False)
    )
    return np.concatenate(
        [gathered[p, :valid] for p, (_, valid) in enumerate(sizes)],
        axis=0,
    )
