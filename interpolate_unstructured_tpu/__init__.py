"""interpolate_unstructured_tpu — batched unstructured-grid
interpolation and field-line tracing in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
jannisteunissen/interpolate_unstructured (reference surveyed in
SURVEY.md): efficient interpolation of point/cell data on unstructured
grids (triangles, quads, tetrahedra) plus an adaptive field-line tracer —
batch-first, SoA, fixed-shape, shardable over device meshes.

Public API mirrors the reference's ``iu_*`` surface
(m_interp_unstructured.f90:77-101) in functional, batched form.
"""

from .models.grid import (
    UGrid,
    add_cell_data,
    add_icell_data,
    add_point_data,
    build_grid,
    get_cell_data_index,
    get_icell_data_index,
    get_point_data_index,
    read_grid,
    reserve_cell_data_storage,
    reserve_icell_data_storage,
    reserve_point_data_storage,
    set_point_data,
    write_vtk,
)
from .ops.interp import (
    get_cell_scalar_at,
    get_icell_scalar_at,
    interpolate_at,
    interpolate_at_icell,
    interpolate_scalar_at,
)
from .ops.locate import (
    STATUS_ARRIVED,
    STATUS_BOUNDARY,
    STATUS_MASK_CHANGED,
    STATUS_STEP_CAP,
    bin_seed,
    get_cell,
    locate_bruteforce,
    point_is_inside_cell,
    walk,
)
from .io.checkpoint import load_grid, save_grid
from .ops.interp_acc import (
    interpolate_at_acc,
    interpolate_at_icell_acc,
    prepare_accurate,
)
from .ops.kdtree import KdTree, build_kdtree, nearest as kdtree_nearest
from .trace import (
    TraceResult,
    build_trace_table,
    integrate_along_field,
    write_trace_vtk,
)
from .utils.config import DEFAULT_CONFIG, IUConfig
from .utils.validate import validate_grid

__version__ = "0.1.0"

__all__ = [
    "UGrid",
    "build_grid",
    "read_grid",
    "write_vtk",
    "add_point_data",
    "add_cell_data",
    "add_icell_data",
    "set_point_data",
    "reserve_point_data_storage",
    "reserve_cell_data_storage",
    "reserve_icell_data_storage",
    "get_point_data_index",
    "get_cell_data_index",
    "get_icell_data_index",
    "interpolate_at",
    "interpolate_at_icell",
    "interpolate_scalar_at",
    "interpolate_at_acc",
    "interpolate_at_icell_acc",
    "prepare_accurate",
    "get_cell_scalar_at",
    "get_icell_scalar_at",
    "get_cell",
    "walk",
    "bin_seed",
    "locate_bruteforce",
    "point_is_inside_cell",
    "STATUS_ARRIVED",
    "STATUS_BOUNDARY",
    "STATUS_MASK_CHANGED",
    "STATUS_STEP_CAP",
    "IUConfig",
    "DEFAULT_CONFIG",
    "save_grid",
    "load_grid",
    "KdTree",
    "build_kdtree",
    "kdtree_nearest",
    "build_trace_table",
    "integrate_along_field",
    "TraceResult",
    "write_trace_vtk",
    "validate_grid",
]
