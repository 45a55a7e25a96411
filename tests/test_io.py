"""IO layer tests: binda round-trip, VTU parsing, converter parity."""

import os

import numpy as np
import pytest

from interpolate_unstructured_tpu.io.binda import BindaWriter, read_binda
from interpolate_unstructured_tpu.io.convert import (
    convert_to_binda,
    get_cell_neighbors,
)
from interpolate_unstructured_tpu.io.vtu import read_vtu

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def test_binda_roundtrip(tmp_path):
    w = BindaWriter()
    pts = np.arange(12, dtype=np.float64).reshape(4, 3)
    cells = np.array([[0, 1, 2], [1, 3, 2]], dtype=np.int64)
    w.add_entry("points", pts)
    w.add_entry("cells", cells, "triangle")
    w.add_entry("point_data", np.linspace(0, 1, 4, dtype=np.float32), "Temp")
    fn = tmp_path / "t.binda"
    w.write_to_file(fn)

    bf = read_binda(fn)
    assert bf.names == ["points", "cells", "point_data"]
    ix = bf.index("cells")
    assert bf.entries[ix].metadata == "triangle"
    # int64 input narrowed to int32 at write time (convert_to_binary.py:48)
    assert bf.entries[ix].dtype == "int32"
    np.testing.assert_array_equal(bf.read_int32(ix), cells)
    np.testing.assert_array_equal(bf.read_float64(bf.index("points")), pts)
    # float32 widened on read (m_binda.f90:127-130)
    pd = bf.read_float64(bf.index("point_data"))
    assert pd.dtype == np.float64
    np.testing.assert_allclose(pd, np.linspace(0, 1, 4, dtype=np.float32))
    assert bf.index("missing") == -1


def test_binda_golden_byte_identity(tmp_path):
    """The writer reproduces the committed golden container
    byte-for-byte — catches any drift in the format (header field
    widths, dtype strings, offsets) without needing the Fortran reader."""
    import os

    golden = os.path.join(os.path.dirname(__file__), "data", "golden.binda")
    w = BindaWriter()
    pts = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=np.float64
    )
    cells = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    nbrs = np.array([[-1, 1, -1], [0, -1, -1]], dtype=np.int32)
    w.add_entry("points", pts)
    w.add_entry("cells", cells, "triangle")
    w.add_entry("cell_neighbors", nbrs)
    w.add_entry("point_data", pts.sum(axis=1) + 1.0, "Polynomial")
    fn = tmp_path / "regen.binda"
    w.write_to_file(fn)
    with open(golden, "rb") as f:
        want = f.read()
    assert fn.read_bytes() == want

    # And the reader parses the golden bytes back to the same arrays
    bf = read_binda(golden)
    np.testing.assert_array_equal(bf.read_float64(bf.index("points")), pts)
    np.testing.assert_array_equal(bf.read_int32(bf.index("cells")), cells)
    assert bf.entries[bf.index("cells")].metadata == "triangle"


def test_binda_header_layout(tmp_path):
    """Byte-level layout must match the Fortran reader's expectations."""
    w = BindaWriter()
    w.add_entry("xyz", np.zeros((2, 5)))
    fn = tmp_path / "h.binda"
    w.write_to_file(fn)
    raw = fn.read_bytes()
    assert raw[:5] == b"BINDA"
    n_entries = int.from_bytes(raw[8:16], "little")
    header_size = int.from_bytes(raw[16:24], "little")
    assert n_entries == 1
    entry_size = 128 * 3 + 8 + 8 * 8 + 8
    assert header_size == 24 + entry_size
    assert raw[24:27] == b"xyz"
    # offset field is absolute (m_binda.f90 reads at pos=offset+1)
    offset = int.from_bytes(raw[24 + entry_size - 8 : 24 + entry_size], "little")
    assert offset == header_size
    assert len(raw) == header_size + 2 * 5 * 8


def test_read_vtu_appended_raw():
    m = read_vtu(DATA + "/triangle.vtu")
    assert m.points.shape == (9, 3)
    assert len(m.cells) == 1
    assert m.cells[0].type == "triangle"
    assert m.cells[0].data.shape == (8, 3)
    assert set(m.point_data) == {"DistanceToCenter", "Polynomial"}
    # Known fixture content: Polynomial = x + y + z + 1 at the vertices
    np.testing.assert_allclose(
        m.point_data["Polynomial"], m.points.sum(axis=1) + 1, atol=1e-6
    )


def _ascii_vtu(m):
    """The mesh ``m`` (one cell block) as an ASCII-format VTU file."""
    vtk_id = {"triangle": 5, "quad": 9, "tetra": 10}[m.cells[0].type]
    conn = m.cells[0].data
    npc = conn.shape[1]

    def arr(values, dtype, name="", ncomp=1):
        text = " ".join(repr(float(v)) if dtype.startswith("Float")
                        else str(int(v)) for v in np.ravel(values))
        return (f'<DataArray type="{dtype}"'
                + (f' Name="{name}"' if name else "")
                + f' NumberOfComponents="{ncomp}" format="ascii">'
                + text + "</DataArray>")

    point_data = "".join(
        arr(v, "Float64", k) for k, v in m.point_data.items()
    )
    return (
        '<?xml version="1.0"?><VTKFile type="UnstructuredGrid" '
        'version="0.1" byte_order="LittleEndian"><UnstructuredGrid>'
        f'<Piece NumberOfPoints="{len(m.points)}" '
        f'NumberOfCells="{len(conn)}">'
        f"<Points>{arr(m.points, 'Float64', ncomp=3)}</Points><Cells>"
        + arr(conn, "Int32", "connectivity")
        + arr(np.arange(1, len(conn) + 1) * npc, "Int32", "offsets")
        + arr(np.full(len(conn), vtk_id), "UInt8", "types")
        + f"</Cells><PointData>{point_data}</PointData></Piece>"
        "</UnstructuredGrid></VTKFile>"
    )


def test_read_vtu_ascii(tmp_path):
    """quad.vtu and tetra.vtu (appended raw) re-encoded as ASCII VTU
    read back identically."""
    m = read_vtu(DATA + "/quad.vtu")
    assert m.cells[0].type == "quad"
    assert m.cells[0].data.shape == (4, 4)
    assert m.points.shape == (9, 3)
    np.testing.assert_allclose(
        m.point_data["Polynomial"], m.points.sum(axis=1) + 1, atol=1e-12
    )

    t = read_vtu(DATA + "/tetra.vtu")
    assert t.cells[0].type == "tetra"
    assert t.cells[0].data.shape == (48, 4)
    assert t.points.shape == (27, 3)

    for name, raw in (("quad", m), ("tetra", t)):
        fn = tmp_path / f"{name}_ascii.vtu"
        fn.write_text(_ascii_vtu(raw))
        a = read_vtu(fn)
        assert a.cells[0].type == raw.cells[0].type
        np.testing.assert_array_equal(a.cells[0].data, raw.cells[0].data)
        np.testing.assert_array_equal(a.points, raw.points)
        assert set(a.point_data) == set(raw.point_data)
        for k, v in raw.point_data.items():
            np.testing.assert_array_equal(a.point_data[k], v)


def test_neighbors_two_triangles():
    # Two triangles sharing edge (1,2): faces of cell 0 are (0,1),(1,2),(2,0)
    points = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], float)
    cells = np.array([[0, 1, 2], [1, 3, 2]])
    nb = get_cell_neighbors(cells, points, 2)
    np.testing.assert_array_equal(nb[0], [-1, 1, -1])
    # cell 1 = [1,3,2]: shared face (2,1) is face k=2
    np.testing.assert_array_equal(nb[1], [-1, -1, 0])


def test_neighbors_duplicate_points_merged():
    # Same two triangles but cell 1 references duplicated copies of the
    # shared points — duplicates must be merged (convert_to_binary.py:130)
    points = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0], [0, 1, 0]],
        float,
    )
    cells = np.array([[0, 1, 2], [4, 3, 5]])
    nb = get_cell_neighbors(cells, points, 2)
    assert nb[0, 1] == 1
    assert nb[1, 2] == 0


def test_neighbors_tetra_face_convention():
    # Two tets sharing face {1,2,3}: for cell 0 that's face k=1 (1,2,3)
    points = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], float
    )
    cells = np.array([[0, 1, 2, 3], [1, 2, 3, 4]])
    nb = get_cell_neighbors(cells, points, 3)
    assert nb[0, 1] == 1  # face (1,2,3) of cell 0
    assert nb[1, 0] == 0  # face (1,2,3) of cell 1
    assert (nb == -1).sum() == 6


def test_neighbors_match_reference_on_fixture():
    m = read_vtu(DATA + "/tetra.vtu")
    nb = get_cell_neighbors(m.cells[0].data, m.points, 3)
    # Every internal face is shared by exactly 2 cells; adjacency must be
    # symmetric: if nb[c,k] == d then some face of d points back at c.
    n_cells = len(nb)
    for c in range(n_cells):
        for k in range(4):
            d = nb[c, k]
            if d >= 0:
                assert c in nb[d], (c, k, d)


def test_convert_to_binda_caching(tmp_path):
    import shutil

    src = tmp_path / "triangle.vtu"
    shutil.copy(DATA + "/triangle.vtu", src)
    out = convert_to_binda(src)
    assert out.endswith(".binda")
    mtime1 = __import__("os").path.getmtime(out)
    out2 = convert_to_binda(src)  # cached: not rewritten
    assert __import__("os").path.getmtime(out2) == mtime1
    convert_to_binda(src, force=True)

    bf = read_binda(out)
    assert bf.index("points") >= 0
    assert bf.index("cells") >= 0
    assert bf.index("cell_neighbors") >= 0
    assert bf.entries[bf.index("cells")].metadata == "triangle"
    nb = bf.read_int32(bf.index("cell_neighbors"))
    assert nb.shape == (8, 3)
    # 8-triangle square mesh: 8 interior faces (4 diagonals shared x2)
    assert (nb >= 0).sum() == 16


def test_convert_rejects_mixed_blocks(tmp_path):
    from interpolate_unstructured_tpu.io.vtu import CellBlock, Mesh
    from interpolate_unstructured_tpu.io.convert import mesh_to_binda_writer

    pts = np.zeros((5, 3))
    mesh = Mesh(
        points=pts,
        cells=[
            CellBlock("triangle", np.array([[0, 1, 2]])),
            CellBlock("quad", np.array([[0, 1, 2, 3]])),
        ],
    )
    with pytest.raises(ValueError, match="Mixed cell types"):
        mesh_to_binda_writer(mesh)


def test_grid_checkpoint_roundtrip(tmp_path, triangle_grid):
    """save_grid/load_grid round-trips the fully preprocessed state."""
    import jax.numpy as jnp
    import interpolate_unstructured_tpu as iu
    from interpolate_unstructured_tpu.io.checkpoint import load_grid, save_grid

    grid, _ = iu.add_cell_data(
        triangle_grid, "rho", np.arange(triangle_grid.n_cells, dtype=float)
    )
    fn = tmp_path / "grid.binda"
    save_grid(grid, fn)
    g2 = load_grid(fn)
    assert g2.cell_type == grid.cell_type
    assert g2.point_data_names == grid.point_data_names
    assert g2.cell_data_names == ("rho",)
    assert g2.bin_shape == grid.bin_shape
    np.testing.assert_array_equal(
        np.asarray(g2.walk_table), np.asarray(grid.walk_table)
    )
    # Fully functional after reload (no preprocessing rerun)
    ivar = iu.get_point_data_index(g2, "Polynomial")
    r = jnp.asarray([[0.5, 0.5, 0.0], [1.7, 0.3, 0.0]])
    v, ic, f = iu.interpolate_scalar_at(g2, r, ivar)
    assert bool(f.all())
    np.testing.assert_allclose(
        np.asarray(v), np.asarray(r).sum(1) + 1, atol=1e-13
    )


def test_grid_checkpoint_v5_derived_leaves(tmp_path):
    """The v5 container sheds cell_points (derived as points[cells] at
    load — a pure gather, bit-exact) and stores candidate lists ragged
    (cand_flat + cand_count, counts may exceed K via the overflow
    extension); the loaded rectangle must equal the saved one slot for
    slot."""
    from interpolate_unstructured_tpu import build_grid
    from interpolate_unstructured_tpu.io.binda import read_binda
    from interpolate_unstructured_tpu.io.checkpoint import load_grid, save_grid
    from interpolate_unstructured_tpu.utils import meshgen

    points, cells, neighbors = meshgen.tet_box_mesh(6, 6, 6)
    grid = build_grid(
        points, cells, neighbors, "tetra",
        point_data={"vx": points[:, 0]}, locate_mode="walk",
    )
    assert int(np.asarray(grid.cand_count).max()) > grid.cand_ids.shape[1], (
        "fixture must exercise the overflow-extension count > K case"
    )
    fn = tmp_path / "grid.binda"
    save_grid(grid, fn)
    names = [e.name for e in read_binda(str(fn)).entries]
    assert "grid/cell_points" not in names
    assert "grid/cand_ids" not in names
    assert "grid/cand_flat" in names
    g2 = load_grid(fn)
    np.testing.assert_array_equal(
        np.asarray(g2.cand_ids), np.asarray(grid.cand_ids)
    )
    np.testing.assert_array_equal(
        np.asarray(g2.cell_points), np.asarray(grid.cell_points)
    )
    np.testing.assert_array_equal(
        np.asarray(g2.cand_table), np.asarray(grid.cand_table)
    )


def test_grid_checkpoint_dtype_and_kdtree(tmp_path):
    """Checkpoint restores the saved dtype exactly, downcasts only on
    explicit request, and round-trips the kd-tree seed arrays."""
    import jax.numpy as jnp
    import interpolate_unstructured_tpu as iu
    from interpolate_unstructured_tpu.io.checkpoint import load_grid, save_grid
    from interpolate_unstructured_tpu.utils import meshgen
    from interpolate_unstructured_tpu.utils.config import IUConfig

    points, cells, neighbors = meshgen.triangle_rect_mesh(4, 4)
    poly = points.sum(axis=1) + 1.0
    grid = iu.build_grid(
        points,
        cells,
        neighbors,
        "triangle",
        point_data={"Polynomial": poly},
        locate_mode="walk",
        config=IUConfig(seed_mode="kdtree"),
        dtype=jnp.float64,
    )
    fn = tmp_path / "kd.binda"
    save_grid(grid, fn)

    g64 = load_grid(fn)
    assert g64.dtype == jnp.float64  # saved dtype restored, not ambient
    assert g64.kd_max_depth == grid.kd_max_depth
    np.testing.assert_array_equal(
        np.asarray(g64.kd_node_ids), np.asarray(grid.kd_node_ids)
    )

    # Explicit downcast: float leaves cast, ints untouched, still works
    g32 = load_grid(fn, dtype=jnp.float32)
    assert g32.dtype == jnp.float32
    assert g32.cells.dtype == jnp.int32
    r = jnp.asarray([[0.5, 0.5, 0.0], [1.2, 0.8, 0.0]], dtype=jnp.float32)
    v, _, f = iu.interpolate_scalar_at(g32, r, 0)
    assert bool(f.all())
    np.testing.assert_allclose(
        np.asarray(v), np.asarray(r).sum(1) + 1, atol=1e-5
    )


def _b64_block(data, header_dtype=np.uint32):
    """VTK convention: size header and data as SEPARATE base64 blocks."""
    import base64

    head = np.asarray([len(data)], dtype=header_dtype).tobytes()
    return base64.b64encode(head) + base64.b64encode(data)


def _vtu_appended_base64(tmp_path, single_stream=False):
    """Two-triangle square with Polynomial data, appended base64 — the
    encoding VTK emits when binary XML safety is wanted."""
    import base64

    points = np.asarray(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype="<f8"
    )
    conn = np.asarray([0, 1, 2, 0, 2, 3], dtype="<i4")
    offs = np.asarray([3, 6], dtype="<i4")
    types = np.asarray([5, 5], dtype="<u1")
    poly = np.asarray([1, 2, 3, 2], dtype="<f8")

    blocks, offsets = [], []
    pos = 0
    for arr in (points, conn, offs, types, poly):
        raw = arr.tobytes()
        if single_stream:
            head = np.asarray([len(raw)], dtype=np.uint32).tobytes()
            b = base64.b64encode(head + raw)
        else:
            b = _b64_block(raw)
        offsets.append(pos)
        blocks.append(b)
        pos += len(b)
    o = offsets
    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
  <UnstructuredGrid>
    <Piece NumberOfPoints="4" NumberOfCells="2">
      <Points>
        <DataArray type="Float64" NumberOfComponents="3" format="appended" offset="{o[0]}"/>
      </Points>
      <Cells>
        <DataArray type="Int32" Name="connectivity" format="appended" offset="{o[1]}"/>
        <DataArray type="Int32" Name="offsets" format="appended" offset="{o[2]}"/>
        <DataArray type="UInt8" Name="types" format="appended" offset="{o[3]}"/>
      </Cells>
      <PointData>
        <DataArray type="Float64" Name="Polynomial" format="appended" offset="{o[4]}"/>
      </PointData>
    </Piece>
  </UnstructuredGrid>
  <AppendedData encoding="base64">
   _"""
    fn = tmp_path / ("b64_stream.vtu" if single_stream else "b64.vtu")
    fn.write_bytes(
        xml.encode() + b"".join(blocks) + b"\n  </AppendedData>\n</VTKFile>\n"
    )
    return fn


@pytest.mark.parametrize("single_stream", [False, True])
def test_read_vtu_appended_base64_multiarray(tmp_path, single_stream):
    """Offsets count ENCODED chars; each array's header/data blocks are
    independent (a whole-stream decode truncates at the first '='
    padding).  Both block conventions must parse."""
    fn = _vtu_appended_base64(tmp_path, single_stream)
    m = read_vtu(fn)
    np.testing.assert_array_equal(m.cells[0].data, [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_allclose(
        m.points, [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]
    )
    np.testing.assert_allclose(m.point_data["Polynomial"], [1, 2, 3, 2])


def test_read_vtu_inline_compressed(tmp_path):
    """format="binary" + vtkZLibDataCompressor, VTK block layout."""
    import base64
    import zlib

    def inline(arr):
        raw = arr.tobytes()
        comp = zlib.compress(raw)
        head = np.asarray(
            [1, len(raw), len(raw), len(comp)], dtype=np.uint32
        ).tobytes()
        return (base64.b64encode(head) + base64.b64encode(comp)).decode()

    points = np.asarray(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype="<f8"
    )
    conn = np.asarray([0, 1, 2, 0, 2, 3], dtype="<i4")
    offs = np.asarray([3, 6], dtype="<i4")
    types = np.asarray([5, 5], dtype="<u1")
    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian" compressor="vtkZLibDataCompressor">
  <UnstructuredGrid>
    <Piece NumberOfPoints="4" NumberOfCells="2">
      <Points>
        <DataArray type="Float64" NumberOfComponents="3" format="binary">{inline(points)}</DataArray>
      </Points>
      <Cells>
        <DataArray type="Int32" Name="connectivity" format="binary">{inline(conn)}</DataArray>
        <DataArray type="Int32" Name="offsets" format="binary">{inline(offs)}</DataArray>
        <DataArray type="UInt8" Name="types" format="binary">{inline(types)}</DataArray>
      </Cells>
    </Piece>
  </UnstructuredGrid>
</VTKFile>
"""
    fn = tmp_path / "inline_z.vtu"
    fn.write_text(xml)
    m = read_vtu(fn)
    np.testing.assert_array_equal(m.cells[0].data, [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_allclose(m.points[:, :2], points[:, :2])


def test_read_vtu_multi_piece(tmp_path):
    """Multiple <Piece> elements merge with per-piece point offsets."""
    xml = """<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
  <UnstructuredGrid>
    <Piece NumberOfPoints="3" NumberOfCells="1">
      <Points>
        <DataArray type="Float64" NumberOfComponents="3" format="ascii">
          0 0 0  1 0 0  0 1 0
        </DataArray>
      </Points>
      <Cells>
        <DataArray type="Int32" Name="connectivity" format="ascii">0 1 2</DataArray>
        <DataArray type="Int32" Name="offsets" format="ascii">3</DataArray>
        <DataArray type="UInt8" Name="types" format="ascii">5</DataArray>
      </Cells>
      <PointData>
        <DataArray type="Float64" Name="f" format="ascii">1 2 2</DataArray>
      </PointData>
    </Piece>
    <Piece NumberOfPoints="3" NumberOfCells="1">
      <Points>
        <DataArray type="Float64" NumberOfComponents="3" format="ascii">
          1 0 0  1 1 0  0 1 0
        </DataArray>
      </Points>
      <Cells>
        <DataArray type="Int32" Name="connectivity" format="ascii">0 1 2</DataArray>
        <DataArray type="Int32" Name="offsets" format="ascii">3</DataArray>
        <DataArray type="UInt8" Name="types" format="ascii">5</DataArray>
      </Cells>
      <PointData>
        <DataArray type="Float64" Name="f" format="ascii">2 3 2</DataArray>
      </PointData>
    </Piece>
  </UnstructuredGrid>
</VTKFile>
"""
    fn = tmp_path / "pieces.vtu"
    fn.write_text(xml)
    m = read_vtu(fn)
    assert len(m.points) == 6
    np.testing.assert_array_equal(
        m.cells[0].data, [[0, 1, 2], [3, 4, 5]]
    )
    np.testing.assert_allclose(m.point_data["f"], [1, 2, 2, 2, 3, 2])


def test_binda_rejects_int32_overflow(tmp_path):
    """Values outside int32 range must raise, not silently wrap
    (the format stores integers as int32, convert_to_binary.py:48-49)."""
    from interpolate_unstructured_tpu.io.binda import BindaWriter

    w = BindaWriter()
    with pytest.raises(ValueError, match="int32 range"):
        w.add_entry("big", np.asarray([2**31], dtype=np.int64))
