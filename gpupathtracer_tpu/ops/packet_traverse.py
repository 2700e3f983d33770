"""Packet BVH traversal in plain XLA: the traversal on the CPU backend.

K rays share ONE traversal stack (a packet), P packets advance in
lockstep, and each `lax.while_loop` iteration executes U unrolled pops per
packet. A pop costs one row fetch from a merged node/leaf table
([P] row gather — the only gather in the loop) plus dense [P, 8, K] slab
math and [P, K] Moller-Trumbore tests. Keeping the loop count low (one
iteration per pop of the deepest packet, not per ray) is what makes the
lockstep formulation affordable without per-lane control flow.

This replaces the reference's per-thread if-if stacks
(src/shaders/common/BVH.glsl:634-854), which ops/cuda/traverse.cu runs
as written on the GPU. Packets map to Morton film tiles
(Renderer.cpp:568-592 ordering), so primary and shadow wavefronts are
coherent; divergent bounce packets visit the union of their rays' nodes.

Layouts: rays [P, 3, K] (K minor), per-ray state [P, K], stacks [P, D],
merged rows [W + L, 128] (see bvh/types.py WideBVH).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.bvh.types import INVALID_ENTRY

_INVALID = INVALID_ENTRY  # plain int: jnp module constants leak mesh avals
_INF = float('inf')  # plain float: jnp module constants leak mesh avals


def _safe_inv(d):
    eps = 1e-12
    mag = jnp.maximum(jnp.abs(d), eps)
    return jnp.where(d >= 0, 1.0, -1.0) / mag


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _mt_packet(p0, e1, e2, o, d, t_cur):
    """One shared triangle vs a packet. p0/e1/e2: [P, 3] (broadcast);
    o, d: [P, 3, K]. Returns (t, u, v, hit) each [P, K].
    Semantics match IntersectTriangleMT (Geometry.glsl:198-225)."""
    e1x, e1y, e1z = e1[:, 0:1], e1[:, 1:2], e1[:, 2:3]       # [P,1]
    e2x, e2y, e2z = e2[:, 0:1], e2[:, 1:2], e2[:, 2:3]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]                   # [P,K]
    px, py, pz = _cross(dx, dy, dz, e2x, e2y, e2z)
    det = e1x * px + e1y * py + e1z * pz
    idet = 1.0 / det
    tx = o[:, 0] - p0[:, 0:1]
    ty = o[:, 1] - p0[:, 1:2]
    tz = o[:, 2] - p0[:, 2:3]
    u = (tx * px + ty * py + tz * pz) * idet
    qx, qy, qz = _cross(tx, ty, tz, e1x, e1y, e1z)
    v = (dx * qx + dy * qy + dz * qz) * idet
    t = (e2x * qx + e2y * qy + e2z * qz) * idet
    hit = (u > 0.0) & (u < 1.0) & (v > 0.0) & (u + v < 1.0) & (t > 0.0) \
        & (t < t_cur)
    return t, u, v, hit


def _traverse_packets(rows, o, d, t_max, active,
                      stack_depth: int, leaf_size: int, any_hit_mode: bool,
                      unroll: int = 1, root=None, pass1_cap: int = 48,
                      prefix_div: int = 32, pass2_cap: int = 8192,
                      outer_cap: int = 64):
    """rows: merged [W+L, 128] table; o, d: [P, K, 3]; t_max, active: [P, K].
    root: scalar initial stack entry (default 0, the table's root row).

    Lockstep-tail compaction: measured on Sponza-class scenes, the deepest
    packet needs ~18x the median pop count (676 vs p50=14), and a single
    lockstep while pays full-width work for every iteration. So: (1) a
    pass capped at `pass1_cap` iterations over all P packets retires the
    ~90% of easy packets, then (2) an outer loop sorts alive packets to the
    front and drains them through a P/prefix_div prefix with inner caps —
    all shapes static, results exact (packets carry their stacks with them).
    """
    P, K = t_max.shape
    oT0 = jnp.transpose(o, (0, 2, 1))  # [P, 3, K]
    dT0 = jnp.transpose(d, (0, 2, 1))
    invT0 = _safe_inv(dT0)

    stack = jnp.zeros((P, stack_depth), jnp.int32)
    if root is not None:
        stack = stack.at[:, 0].set(jnp.asarray(root, jnp.int32))
    sp = jnp.where(jnp.any(active, axis=1), 1, 0).astype(jnp.int32)

    # Everything with a leading P axis lives in the carry so compaction can
    # permute packets (rays travel with their stacks).
    state = (stack, sp,
             t_max.astype(jnp.float32),
             jnp.full((P, K), -1, jnp.int32),
             jnp.zeros((P, K), jnp.float32),
             jnp.zeros((P, K), jnp.float32),
             jnp.zeros((P, K), bool),
             oT0, dT0, invT0, active,
             jnp.zeros((P,), jnp.int32),      # pops per packet
             jnp.arange(P, dtype=jnp.int32))  # original packet slot

    def step(st):
        stack, sp, t, prim, uu, vv, found, oT, dT, invT, act, pops, orig = st
        Pc = sp.shape[0]
        prow = jnp.arange(Pc, dtype=jnp.int32)
        live = sp > 0
        pops = pops + live.astype(jnp.int32)
        top = jnp.maximum(sp - 1, 0)
        entry = jnp.take_along_axis(stack, top[:, None], axis=1)[:, 0]
        sp = jnp.where(live, sp - 1, sp)
        is_leaf = live & (entry < 0)
        is_node = live & (entry >= 0)
        rays_on = act & ~found if any_hit_mode else act

        # ---- one merged-row fetch per packet --------------------------
        lpacked = jnp.where(is_leaf, -(entry + 1), 0)
        ridx = jnp.where(is_leaf, lpacked >> 4, jnp.where(is_node, entry, 0))
        row = rows[ridx]                          # [Pc, 128]

        # ---- node expansion: per-ray slab over 8 children --------------
        # (a conservative packet-frustum interval test was tried here and
        # lost 20x: per-ray `tmin < t` culling is what keeps the visit count
        # down for closest-hit)
        bounds = row[:, 0:48].reshape(Pc, 8, 6)
        centry = jax.lax.bitcast_convert_type(row[:, 48:56], jnp.int32)
        tmin = jnp.full((Pc, 8, K), -_INF)
        tmx = jnp.full((Pc, 8, K), _INF)
        for a in range(3):
            t0 = (bounds[:, :, a, None] - oT[:, None, a, :]) \
                * invT[:, None, a, :]
            t1 = (bounds[:, :, 3 + a, None] - oT[:, None, a, :]) \
                * invT[:, None, a, :]
            tmin = jnp.maximum(tmin, jnp.minimum(t0, t1))
            tmx = jnp.minimum(tmx, jnp.maximum(t0, t1))
        rhit = (tmin <= tmx) & (tmx > 0.0) & (tmin < t[:, None, :]) \
            & rays_on[:, None, :]                 # [Pc, 8, K]
        chit = jnp.any(rhit, axis=2) & (centry != _INVALID) & is_node[:, None]

        if any_hit_mode:
            s_entry, s_hit = centry, chit         # order is irrelevant
        else:
            near = jnp.min(jnp.where(rhit, tmin, _INF), axis=2)
            order = jnp.argsort(jnp.where(chit, near, _INF), axis=1)
            s_entry = jnp.take_along_axis(centry, order, axis=1)
            s_hit = jnp.take_along_axis(chit, order, axis=1)

        incl = jnp.cumsum(s_hit.astype(jnp.int32), axis=1)
        total = incl[:, -1]
        pos = sp[:, None] + total[:, None] - incl  # nearest ends up on top
        pos = jnp.where(s_hit, pos, stack_depth)   # out-of-range -> dropped
        for j in range(8):
            stack = stack.at[prow, pos[:, j]].set(s_entry[:, j], mode="drop")
        sp = jnp.where(is_node, jnp.minimum(sp + total, stack_depth), sp)

        # ---- leaf: shared triangles from the same row ------------------
        lcount = lpacked & 15
        for k in range(leaf_size):
            base = k * 12
            p0 = row[:, base:base + 3]
            e1 = row[:, base + 3:base + 6]
            e2 = row[:, base + 6:base + 9]
            pid = jax.lax.bitcast_convert_type(row[:, base + 9], jnp.int32)
            tt, tu, tv, th = _mt_packet(p0, e1, e2, oT, dT, t)
            ok = (is_leaf & (k < lcount))[:, None] & th & rays_on
            t = jnp.where(ok, tt, t)
            prim = jnp.where(ok, pid[:, None], prim)
            uu = jnp.where(ok, tu, uu)
            vv = jnp.where(ok, tv, vv)

        if any_hit_mode:
            found = found | (prim >= 0)
            packet_done = jnp.all(found | ~act, axis=1)
            sp = jnp.where(packet_done, 0, sp)

        return (stack, sp, t, prim, uu, vv, found, oT, dT, invT, act, pops,
                orig)

    def run_capped(st, cap):
        """while any packet live, up to `cap` iterations (cap<=0: unbounded)."""
        def cond(c):
            st, it = c
            alive = jnp.any(st[1] > 0)
            return alive & (it < cap) if cap > 0 else alive

        def body(c):
            st, it = c
            for _ in range(max(unroll, 1)):
                st = step(st)
            return st, it + max(unroll, 1)

        st, _ = jax.lax.while_loop(cond, body, (st, jnp.int32(0)))
        return st

    # Shadow/any-hit traversals are shallow (early exit): compaction's
    # sort/permute machinery costs more than the tail there.
    use_compaction = (not any_hit_mode) and P >= 4 * prefix_div

    if not use_compaction:
        final = run_capped(state, 0)
    else:
        # Pass 1: full width, capped.
        st = run_capped(state, pass1_cap)

        # Outer drain: alive packets to the front, process a prefix.
        Pc2 = P // prefix_div

        def outer_cond(c):
            st, rounds = c
            return jnp.any(st[1] > 0) & (rounds < outer_cap)

        def outer_body(c):
            st, rounds = c
            order = jnp.argsort((st[1] <= 0).astype(jnp.int32),
                                stable=True)
            st = tuple(a[order] for a in st)
            sub = tuple(a[:Pc2] for a in st)
            sub = run_capped(sub, pass2_cap)
            st = tuple(a.at[:Pc2].set(s) for a, s in zip(st, sub))
            return st, rounds + 1

        st, _ = jax.lax.while_loop(outer_cond, outer_body,
                                   (st, jnp.int32(0)))
        final = st

    _, _, t, prim, uu, vv, found, _, _, _, _, pops, orig = final
    # Undo the compaction permutation.
    inv = jnp.argsort(orig)
    t, prim, uu, vv, found, pops = (a[inv] for a in (t, prim, uu, vv, found,
                                                     pops))
    return t, prim, uu, vv, (found if any_hit_mode else prim >= 0), pops


def traverse_packets(rows, o, d, t_max, active, *, stack_depth: int,
                     leaf_size: int, packet_size: int, any_hit: bool,
                     root=None):
    """Packet traversal of [N] rays (N a multiple of packet_size) against
    a merged [M, 128] table of 8-wide nodes and single-row leaves.

    Returns (t, prim, u, v) each [N] and [N // packet_size] pops per
    packet. Any-hit lanes report prim >= 0 when occluded."""
    n = o.shape[0]
    assert n % packet_size == 0, (n, packet_size)
    P = n // packet_size
    t, prim, u, v, _, pops = _traverse_packets(
        rows, o.reshape(P, packet_size, 3), d.reshape(P, packet_size, 3),
        t_max.reshape(P, packet_size), active.reshape(P, packet_size),
        stack_depth, leaf_size, any_hit, root=root)
    return (t.reshape(n), prim.reshape(n), u.reshape(n), v.reshape(n),
            pops)
