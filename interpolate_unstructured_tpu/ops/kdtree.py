"""Stackless-layout batched kd-tree: exact 1-NN over cell centers.

Parity component for the reference's L0 spatial index (kdtree2
submodule; usage m_interp_unstructured.f90:251-288).  The
*default* cold-start seed is the O(1) uniform-grid bin table
(ops.geometry.build_bin_seed_table) — a kd-tree descent is inherently
pointer-chasing and gather-bound — but this module provides the exact
nearest-neighbor contract for users who want kdtree2-equivalent
seeding quality, implemented the XLA way:

* **left-balanced implicit layout** built on the host: node ``i``'s
  children are ``2i+1`` / ``2i+2``, split dimension cycles with depth,
  so traversal needs no pointers and the whole tree is two flat arrays;
* **fixed-size explicit stack** per query (depth <= ceil(log2 n)+2),
  batched over queries in a ``lax.while_loop`` with an active mask and
  best-distance pruning — no recursion, no dynamic shapes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class KdTree:
    """Implicit left-balanced kd-tree over a point set."""

    node_points: Any  # (M, 3) point coordinates per tree node
    node_ids: Any  # (M,) int32 original point index per node
    n_nodes: int  # static: number of real nodes (== n_points)
    max_depth: int  # static: stack bound for traversal

    def tree_flatten(self):
        return (self.node_points, self.node_ids), (self.n_nodes, self.max_depth)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1])


def _left_subtree_size(n: int) -> int:
    """Nodes in the left subtree of a left-balanced tree of n nodes."""
    if n <= 1:
        return 0
    h = n.bit_length() - 1  # complete-tree height
    last_row = n - (2**h - 1)
    return 2 ** (h - 1) - 1 + min(last_row, 2 ** (h - 1))


def build_kdtree(points: np.ndarray, dtype=None) -> KdTree:
    """Host-side construction (numpy): median splits on cycling dims.

    The reference builds its tree over cell centers with sort=False,
    rearrange=False (build_kdtree, :251-262); this layout instead
    left-balances so the device traversal needs only the implicit
    child indexing.
    """
    points = np.asarray(points, dtype=np.float64)
    n, k = points.shape
    if k != 3:
        raise ValueError("kd-tree expects (n, 3) points")
    node_ids = np.full(n, -1, dtype=np.int32)

    # Iterative construction: (node, ids, depth)
    stack = [(0, np.arange(n, dtype=np.int64), 0)]
    max_depth = 1
    while stack:
        node, ids, depth = stack.pop()
        m = len(ids)
        if m == 0:
            continue
        max_depth = max(max_depth, depth + 1)
        if m == 1:
            node_ids[node] = ids[0]
            continue
        dim = depth % 3
        s = _left_subtree_size(m)
        part = np.argpartition(points[ids, dim], s)
        ids = ids[part]
        node_ids[node] = ids[s]
        stack.append((2 * node + 1, ids[:s], depth + 1))
        stack.append((2 * node + 2, ids[s + 1 :], depth + 1))

    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return KdTree(
        node_points=jnp.asarray(points[node_ids], dtype=dtype),
        node_ids=jnp.asarray(node_ids),
        n_nodes=n,
        max_depth=max_depth + 1,
    )


def nearest(tree: KdTree, r, max_iters: int | None = None):
    """Batched exact 1-NN query.

    Args:
      r: (B, 3) query points.
      max_iters: optional cap on traversal rounds.  The default
        (2n + 2) provably covers every reachable node, so the result
        is the exact nearest neighbor.  A smaller user-supplied cap
        trades exactness for bounded latency: hitting it returns the
        best candidate found so far (fine as a walk seed, which only
        needs to be *near*).
    Returns:
      (idx, dist2): (B,) int32 original point index of the nearest
      neighbor and its squared distance.

    Equivalent contract to kdtree2_n_nearest(tree, r, 1, res)
    (find_nearby_cell_kdtree, :272-288).
    """
    b, _ = r.shape
    n = tree.n_nodes
    depth = tree.max_depth
    # Sentinel in the QUERY dtype: an f32-max sentinel under x64 would
    # silently return node 0 whenever all true distances exceed ~3.4e38
    big = jnp.asarray(np.finfo(np.dtype(r.dtype)).max, r.dtype)
    if max_iters is None:
        # Provable exactness bound: every node is pushed at most once
        # (only its parent's single visit can push it, plus the root),
        # so total pops <= total pushes <= 2n + 1.  Pruning exits far
        # earlier in practice; this cap only backstops the while_loop.
        max_iters = 2 * n + 2

    # Per-query stack of (node, squared plane distance at push time).
    # All stack reads/writes are one-hot broadcast-compare selects over
    # the (small) stack width — per-row take_along_axis / scatters in a
    # device loop are the slow path this repo's conventions forbid.
    width = depth + 2  # one slack column above the DFS depth bound
    cols = jnp.arange(width, dtype=jnp.int32)[None, :]
    stack_node = jnp.zeros((b, width), jnp.int32)
    stack_pd2 = jnp.zeros((b, width), r.dtype)
    sp = jnp.ones(b, jnp.int32)  # root pushed with pd2 = 0
    best_idx = jnp.zeros(b, jnp.int32)
    best_d2 = jnp.full(b, big)

    def cond(state):
        sp = state[2]
        it = state[5]
        return jnp.any(sp > 0) & (it < max_iters)

    def body(state):
        stack_node, stack_pd2, sp, best_idx, best_d2, it = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        sel_top = cols == top[:, None]
        node = jnp.sum(
            jnp.where(sel_top, stack_node, 0), axis=1, dtype=jnp.int32
        )
        pd2 = jnp.sum(
            jnp.where(sel_top, stack_pd2, 0), axis=1, dtype=stack_pd2.dtype
        )
        sp = jnp.where(active, sp - 1, sp)

        # Prune subtrees that cannot contain a closer point
        visit = active & (pd2 < best_d2) & (node < n)

        node_c = jnp.minimum(node, n - 1)
        p = tree.node_points[node_c]  # (B, 3) row gather
        diff = r - p
        d2 = jnp.sum(diff * diff, axis=1)
        closer = visit & (d2 < best_d2)
        best_d2 = jnp.where(closer, d2, best_d2)
        best_idx = jnp.where(closer, tree.node_ids[node_c], best_idx)

        # Split plane: dim cycles with depth = floor(log2(node+1)),
        # computed in pure integer arithmetic (bit-smear + popcount —
        # a float32 frexp would round node indices near 2^25)
        v = node + 1
        v = v | (v >> 1)
        v = v | (v >> 2)
        v = v | (v >> 4)
        v = v | (v >> 8)
        v = v | (v >> 16)
        dim = (lax.population_count(v) - 1) % 3
        delta = jnp.where(
            dim == 0, diff[:, 0], jnp.where(dim == 1, diff[:, 1], diff[:, 2])
        )
        near = jnp.where(delta < 0, 2 * node + 1, 2 * node + 2)
        far = jnp.where(delta < 0, 2 * node + 2, 2 * node + 1)
        plane_d2 = delta * delta

        # Push far child (pruned later via its plane distance), then
        # near child — one-hot column writes; masked pushes touch no
        # column (sel is all-False)
        def push(sn, sd, sp, do, node_val, pd2_val):
            sel = do[:, None] & (cols == sp[:, None])
            sn = jnp.where(sel, node_val[:, None], sn)
            sd = jnp.where(sel, pd2_val[:, None], sd)
            return sn, sd, jnp.where(do, sp + 1, sp)

        do_far = visit & (far < n)
        stack_node, stack_pd2, sp = push(
            stack_node, stack_pd2, sp, do_far, far, plane_d2
        )
        do_near = visit & (near < n)
        stack_node, stack_pd2, sp = push(
            stack_node, stack_pd2, sp, do_near, near,
            jnp.zeros_like(plane_d2),
        )

        return stack_node, stack_pd2, sp, best_idx, best_d2, it + 1

    state = (stack_node, stack_pd2, sp, best_idx, best_d2, jnp.int32(0))
    _, _, _, best_idx, best_d2, _ = lax.while_loop(cond, body, state)
    return best_idx, best_d2
