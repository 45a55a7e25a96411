"""ctypes driver for the independent serial C++ oracle.

``native/serial_oracle.cc`` reimplements the reference's point
location (nearest-point seed + neighbor walk,
m_interp_unstructured.f90:272-288, :664-763) and simplex interpolation
(:529-586) in plain serial C++ — independent of every JAX path in this
package.  It backs

* cross-validation tests (tests/test_serial_oracle.py): the candidate
  /walk/brute JAX paths must agree with it at 1e-12 in f64, and
* the compiled single-core baseline in bench.py's
  ``speedup_vs_serial`` (a fair stand-in for the unbuildable Fortran
  reference; pure-numpy walks understate compiled serial code).

The shared library is compiled on first use with ``g++ -O3`` into
``build/serial_oracle/`` at the repository root (listed in
.gitignore), keyed by a source hash, so a source edit triggers exactly
one rebuild.  If no C++ toolchain is present, :func:`available`
returns False (tests mark themselves skipped), and :func:`serial_query`
/ :func:`serial_trace` raise with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native",
    "serial_oracle.cc",
)
_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "build",
    "serial_oracle",
)
_lib = None
_build_error = None


def _machine_tag() -> str:
    """ISA component for the .so cache key: -march=native binaries are
    CPU-specific, so a checkout copied to another CPU must miss the
    cache."""
    import platform
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(line.strip())
                    break
    except OSError:
        pass
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:8]


def _build() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_CACHE_DIR, f"serial_oracle_{tag}_{_machine_tag()}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tmp = so + f".build{os.getpid()}"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
         "-o", tmp],
        check=True, capture_output=True, text=True,
    )
    os.replace(tmp, so)  # atomic: concurrent builders race safely
    return so


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_build())
    except subprocess.CalledProcessError as e:
        _build_error = RuntimeError(f"g++ failed: {e.stderr.strip()}")
        return None
    except OSError as e:
        _build_error = e
        return None
    f = lib.iu_serial_query
    f.restype = None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f.argtypes = [
        ctypes.c_int, ctypes.c_int,                # npc, is_quad
        ctypes.c_int, ctypes.c_int,                # n_points, n_cells
        f64p, i32p, i32p, f64p,                    # points, cells, nbrs, data
        ctypes.c_int, f64p,                        # n_q, queries
        ctypes.c_void_p, ctypes.c_int,             # guesses (or NULL), max_steps
        f64p, i32p, u8p,                           # out_vals, out_ic, out_found
    ]
    t = lib.iu_serial_trace
    t.restype = None
    t.argtypes = [
        ctypes.c_int, ctypes.c_int,                # npc, is_quad
        ctypes.c_int, ctypes.c_int,                # n_points, n_cells
        f64p, i32p, i32p,                          # points, cells, nbrs
        ctypes.c_int, f64p, ctypes.c_int,          # ndim, field (ndim,np), nvar
        ctypes.c_double, ctypes.c_double,          # min_dx, max_dx
        ctypes.c_int,                              # max_steps
        ctypes.c_double, ctypes.c_double,          # rtol, atol
        ctypes.c_int, ctypes.c_int,                # reverse, axisymmetric
        ctypes.c_void_p, ctypes.c_int,             # icell_mask (or NULL), mask_value
        ctypes.c_int, f64p, ctypes.c_int,          # n_traj, y0, max_iterations
        f64p, f64p, i32p, i32p,                    # out_y, out_yfield, nsteps, bm
    ]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the oracle library built (g++ present)."""
    return _load() is not None


def serial_query(points, cells, neighbors, data, queries, guesses=None,
                 max_steps=10_000, cell_type=None):
    """Serial reference-algorithm query pass.

    Args mirror the grid arrays (host numpy, any float dtype — widened
    to f64).  ``cell_type`` disambiguates 4-vertex cells: pass
    ``"quad"`` for planar quads (default: tetra when npc == 4).
    Returns ``(vals (n_q,), i_cell (n_q,), found (n_q,))``.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"serial oracle unavailable: {_build_error}")
    points = np.ascontiguousarray(points, np.float64)
    cells = np.ascontiguousarray(cells, np.int32)
    neighbors = np.ascontiguousarray(neighbors, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    queries = np.ascontiguousarray(queries, np.float64)
    n_q = queries.shape[0]
    npc = cells.shape[1]
    vals = np.empty(n_q, np.float64)
    ic = np.empty(n_q, np.int32)
    found = np.empty(n_q, np.uint8)
    gptr = None
    if guesses is not None:
        guesses = np.ascontiguousarray(guesses, np.int32)
        gptr = guesses.ctypes.data_as(ctypes.c_void_p)
    lib.iu_serial_query(
        npc, 1 if cell_type == "quad" else 0,
        points.shape[0], cells.shape[0],
        points, cells, neighbors, data,
        n_q, queries, gptr, max_steps,
        vals, ic, found,
    )
    return vals, ic, found.astype(bool)


def serial_trace(points, cells, neighbors, field, y0, *, nvar=0,
                 min_dx, max_dx, max_steps, rtol, atol, reverse=False,
                 axisymmetric=False, icell_mask=None, mask_value=-1,
                 max_iterations=None, cell_type=None):
    """Serial reference-algorithm field-line trace
    (iu_integrate_along_field, m_interp_unstructured.f90:987-1217).

    Args mirror :func:`trace.integrate_along_field`: ``field`` is
    (n_points, ndim) vertex vector data, ``y0`` is
    (n_traj, ndim + nvar) seeds (extra variables integrate
    d(var)/ds = 1, the arc-length sub-integral of
    test_trace_field.f90:57-64), ``icell_mask`` an optional
    (n_cells,) int array restricting integration to
    ``mask == mask_value`` cells.

    Returns ``(y (n_traj, max_steps, ndim+nvar),
    y_field (n_traj, max_steps, ndim), n_steps (n_traj,),
    boundary_material (n_traj,))`` with the same conventions as
    ``TraceResult`` (n_steps == max_steps + 1 means the buffer filled;
    boundary -1 = physical boundary, else the mask value entered,
    -2 = not reached).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"serial oracle unavailable: {_build_error}")
    points = np.ascontiguousarray(points, np.float64)
    cells = np.ascontiguousarray(cells, np.int32)
    neighbors = np.ascontiguousarray(neighbors, np.int32)
    field = np.ascontiguousarray(field, np.float64)
    y0 = np.ascontiguousarray(y0, np.float64)
    ndim = field.shape[1]
    n_traj = y0.shape[0]
    d = ndim + nvar
    if y0.shape[1] != d:
        raise ValueError(f"y0 must have shape (B, {d})")
    if max_iterations is None:
        max_iterations = 50 * max_steps + 1000
    # component-major (ndim, n_points), matching the C side
    field_t = np.ascontiguousarray(field.T)
    out_y = np.empty((n_traj, max_steps, d), np.float64)
    out_yf = np.empty((n_traj, max_steps, ndim), np.float64)
    nsteps = np.empty(n_traj, np.int32)
    bm = np.empty(n_traj, np.int32)
    mptr = None
    if icell_mask is not None:
        icell_mask = np.ascontiguousarray(icell_mask, np.int32)
        mptr = icell_mask.ctypes.data_as(ctypes.c_void_p)
    lib.iu_serial_trace(
        cells.shape[1], 1 if cell_type == "quad" else 0,
        points.shape[0], cells.shape[0],
        points, cells, neighbors,
        ndim, field_t, nvar,
        float(min_dx), float(max_dx), int(max_steps),
        float(rtol), float(atol), int(bool(reverse)),
        int(bool(axisymmetric)), mptr, int(mask_value),
        n_traj, y0, int(max_iterations),
        out_y, out_yf, nsteps, bm,
    )
    return out_y, out_yf, nsteps, bm
