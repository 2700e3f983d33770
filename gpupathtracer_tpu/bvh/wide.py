"""Binary -> 8-wide BVH collapse and flattening.

A redesign of the reference's BFS binary serialization
(src/core/BVH.cpp:2224-2277): instead of 2-texel binary nodes, we collapse
the binary tree into nodes of up to 8 children so one traversal step reads a
single [8, 6] bounds block and slab-tests all children. Collapse policy:
repeatedly expand the largest-surface-area internal child (greedy SAH-area
heuristic), mirroring the reference's "larger child first" ordering
intuition (BVH.cpp:2237-2248).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gpupathtracer_tpu.bvh.types import (INVALID_ENTRY, BinaryBVH, WideBVH,
                                         encode_leaf_entry)

# Merged-table row width in f32: 512 bytes, room for 8 child boxes and
# entries or 10 triangles, and aligned for 16-byte loads of every field.
ROW_WIDTH = 128


def collapse_to_wide(bvh: BinaryBVH, arity: int = 8) -> Tuple[WideBVH, int]:
    """Collapse a binary BVH to an `arity`-wide flat BVH.

    Returns (wide_bvh, max_wide_depth). Leaf counts must fit in 4 bits
    (builders cap leaves at <= 15 refs).

    arity 16 still fits one 128-float row (16*6 bounds + 16 entries = 112
    floats) and halves internal node count. The row-table traversals (CUDA
    and XLA packets) read 8-wide nodes; other arities take the per-lane
    traversal.
    """
    assert 2 <= arity <= 16
    sa = _half_area(bvh.bmin, bvh.bmax)
    is_leaf = bvh.count > 0

    def expand(b: int) -> List[int]:
        """Greedy: pick up to `arity` binary subtree roots under node b."""
        if is_leaf[b]:
            return [int(b)]
        sel = [int(bvh.left[b]), int(bvh.right[b])]
        while len(sel) < arity:
            best, best_sa = -1, -1.0
            for i, s in enumerate(sel):
                if not is_leaf[s] and sa[s] > best_sa:
                    best, best_sa = i, float(sa[s])
            if best < 0:
                break
            s = sel.pop(best)
            sel.append(int(bvh.left[s]))
            sel.append(int(bvh.right[s]))
        return sel

    # BFS so siblings are adjacent (cache-friendly gathers, cf. BVH.cpp:2443).
    children_of: List[List[int]] = []
    wide_index_of_binary = {}
    order: List[int] = []

    queue = [0]
    while queue:
        b = queue.pop(0)
        wide_index_of_binary[b] = len(order)
        order.append(b)
        sel = expand(b)
        children_of.append(sel)
        for s in sel:
            if not is_leaf[s]:
                queue.append(s)

    W = len(order)
    child_bounds = np.zeros((W, arity, 6), np.float32)
    # Empty slots get an inverted box so any slab test misses.
    child_bounds[..., 0:3] = np.float32(np.inf)
    child_bounds[..., 3:6] = np.float32(-np.inf)
    child_entry = np.full((W, arity), INVALID_ENTRY, np.int32)

    for w, sel in enumerate(children_of):
        for j, s in enumerate(sel):
            child_bounds[w, j, 0:3] = bvh.bmin[s]
            child_bounds[w, j, 3:6] = bvh.bmax[s]
            if is_leaf[s]:
                child_entry[w, j] = encode_leaf_entry(int(bvh.first[s]),
                                                      int(bvh.count[s]))
            else:
                child_entry[w, j] = wide_index_of_binary[s]

    max_depth = _wide_depth(child_entry)
    wide = WideBVH(child_bounds=child_bounds, child_entry=child_entry,
                   refs=bvh.refs.astype(np.int32))
    return wide, max_depth


def pack_for_packets(wide: WideBVH, tri_p0: np.ndarray, tri_e1: np.ndarray,
                     tri_e2: np.ndarray, leaf_size: int = 4) -> WideBVH:
    """Attach the merged row layout read by the CUDA and packet traversals.

    One merged table: node rows (8 child AABBs + 8 bit-cast entries) followed
    by leaf rows (up to `leaf_size` MT-ready triangles + bit-cast prim ids),
    so a traversal pop reads exactly one row. One row packs 10 triangles;
    leaf_size > 10 spans ceil(leaf_size/10) CONSECUTIVE rows per leaf
    (entries encode the block's first row).
    """
    tris_per_row = ROW_WIDTH // 12                  # 10
    R = -(-leaf_size // tris_per_row)               # rows per leaf block
    assert leaf_size <= 15, "leaf count is 4-bit packed"
    W = wide.num_nodes
    entries = wide.child_entry
    arity = entries.shape[1]
    assert 7 * arity <= ROW_WIDTH, (arity, ROW_WIDTH)
    is_leaf = (entries != INVALID_ENTRY) & (entries < 0)

    # --- leaf rows -------------------------------------------------------
    leaf_pos = np.nonzero(is_leaf)
    packed = -(entries[leaf_pos] + 1)
    first = packed >> 4
    count = packed & 15
    if np.any(count > leaf_size):
        raise ValueError(f"leaf count {count.max()} exceeds leaf_size {leaf_size}")
    L = max(len(first), 1)
    leaf_rows = np.zeros((L * R, ROW_WIDTH), np.float32)
    refs = wide.refs
    rows_of = np.arange(len(first), dtype=np.int64) * R
    for k in range(leaf_size):
        have = k < count
        ridx = np.where(have, first + k, 0)
        tri = refs[np.clip(ridx, 0, len(refs) - 1)]
        r, base = divmod(k, tris_per_row)
        base *= 12
        rows = rows_of + r
        leaf_rows[rows, base:base + 3] = np.where(
            have[:, None], tri_p0[tri], 0.0)
        leaf_rows[rows, base + 3:base + 6] = np.where(
            have[:, None], tri_e1[tri], 0.0)  # degenerate (0 edges) never hits
        leaf_rows[rows, base + 6:base + 9] = np.where(
            have[:, None], tri_e2[tri], 0.0)
        leaf_rows[rows, base + 9] = np.where(
            have, tri.astype(np.int32), -1).astype(np.int32).view(np.float32)

    # --- entries referencing merged rows ---------------------------------
    packet_entry = entries.copy()
    merged_row_idx = W + rows_of
    packet_entry[leaf_pos] = (-((merged_row_idx << 4) | count) - 1).astype(np.int32)

    # --- merged table ------------------------------------------------------
    node_rows = np.zeros((W + L * R, ROW_WIDTH), np.float32)
    node_rows[:W, 0:6 * arity] = wide.child_bounds.reshape(W, 6 * arity)
    node_rows[:W, 6 * arity:7 * arity] = packet_entry.view(np.float32)
    node_rows[W:] = leaf_rows
    return wide._replace(node_rows=node_rows, packet_entry=packet_entry)


def _wide_depth(child_entry: np.ndarray) -> int:
    """Depth of the wide tree (for traversal stack sizing)."""
    W = child_entry.shape[0]
    depth = np.ones(W, np.int32)
    # Nodes are in BFS order, so a reverse sweep sees children first.
    for w in range(W - 1, -1, -1):
        for e in child_entry[w]:
            if e != INVALID_ENTRY and e >= 0:
                depth[w] = max(depth[w], 1 + depth[e])
    return int(depth[0]) if W else 0


def _half_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    d = np.maximum(bmax - bmin, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]
