"""Multi-device query sharding: grid replicated, query batch sharded.

The grid is replicated on every device of a 1-D `jax.sharding.Mesh`;
the query batch is sharded over the devices and interpolated with a
`shard_map`-wrapped kernel — no collectives in the hot loop
(SURVEY.md §5.8).  It shards over the devices present (the GPUs of the
machine); with `--cpu-devices N` it runs on N virtual CPU devices
instead, for a machine without a GPU.

Run with `python examples/03_sharded_queries.py [--cpu-devices 8]`.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ap = argparse.ArgumentParser()
_ap.add_argument("--cpu-devices", type=int, default=0,
                 help="run on this many virtual CPU devices instead")
ARGS = _ap.parse_args()
if ARGS.cpu_devices:
    # must precede JAX's backend initialization
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={ARGS.cpu_devices}"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

import numpy as np
import jax.numpy as jnp

import interpolate_unstructured_tpu as iu
from interpolate_unstructured_tpu.io.convert import get_cell_neighbors
from interpolate_unstructured_tpu.parallel import sharding as ps


def main():
    print(f"devices: {jax.devices()}")

    # Same structured triangulation as example 01
    n = 32
    xs = np.linspace(0.0, 1.0, n + 1)
    px, py = np.meshgrid(xs, xs, indexing="ij")
    points = np.column_stack([px.ravel(), py.ravel(), np.zeros(px.size)])
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (i * (n + 1) + j).ravel()
    v10, v01 = v00 + (n + 1), v00 + 1
    v11 = v10 + 1
    cells = np.concatenate(
        [np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)]
    )
    neighbors = get_cell_neighbors(cells, points, n_points_face=2)
    grid = iu.build_grid(
        points, cells, neighbors, "triangle",
        point_data={"Polynomial": points[:, 0] + points[:, 1] + 1.0},
    )
    i_var = iu.get_point_data_index(grid, "Polynomial")

    mesh = ps.make_mesh()
    grid_r = ps.replicate_grid(grid, mesh)

    rng = np.random.default_rng(1)
    r = jnp.asarray(rng.uniform(0.05, 0.95, size=(1_000_003, 3)) * [1, 1, 0])
    r_sharded, b = ps.shard_batch(r, mesh)  # pads to a device multiple

    interp = ps.sharded_interpolate_at(mesh)
    values, i_cell, found = interp(grid_r, r_sharded, [i_var])
    values, found = values[:b], found[:b]

    exact = r[:, 0] + r[:, 1] + 1.0
    err = float(jnp.abs(values[:, 0] - exact).max())
    print(
        f"{b} queries over {len(jax.devices())} devices: "
        f"{int(found.sum())} found, max |err| = {err:.3e}"
    )


if __name__ == "__main__":
    main()
