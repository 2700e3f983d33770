"""Wide-BVH traversal: the per-lane XLA reference, and the one place that
picks a traversal for the backend.

Per-lane reference: a redesign of the reference's per-thread stack traversals (IfIfClosestHit /
IfIfAnyHit, src/shaders/common/BVH.glsl:634-854): instead of divergent
per-lane loops, the whole ray wavefront advances in lockstep through a
bounded `lax.while_loop`. Each step pops one stack entry per lane; lanes
holding an internal node gather its [8, 6] child-bounds block and slab-test
all 8 children at once (near-child-first push order, cf. BVH.glsl:707-717),
lanes holding a leaf run up to `leaf_size` Moller-Trumbore tests. Finished
lanes idle (masked) until the chunk drains — callers bound the waste by
chunking the wavefront.

The traversal stack is a fixed [N, DEPTH] int32 array: no recursion, no
atomics, static shapes throughout.

Dispatch (`resolve_traversal`): on a GPU backend every ray goes through the
per-thread CUDA kernel (ops/cuda_traverse.py); on the CPU backend through
the XLA packet traversal (ops/packet_traverse.py). Both read the merged
node/leaf table; trees that table cannot hold (arity other than 8, leaves
over 10 triangles) take the per-lane traversal on every backend.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gpupathtracer_tpu.bvh.types import INVALID_ENTRY
from gpupathtracer_tpu.ops.intersect import mt_intersect

_INVALID = INVALID_ENTRY  # plain int: jnp module constants leak mesh avals


class Hit(NamedTuple):
    """Closest-hit record (role of HitInfo, src/math/Ray.h:7-21)."""

    t: jnp.ndarray     # [N] f32; t_max on miss
    prim: jnp.ndarray  # [N] i32 triangle id; -1 on miss
    u: jnp.ndarray     # [N] f32 barycentric
    v: jnp.ndarray     # [N] f32 barycentric

    @property
    def miss(self):
        return self.prim < 0


def _safe_inv(d):
    """1/d with tiny components clamped (the reference relies on GLSL inf
    semantics, BVH.glsl:367-391; we avoid inf*0 NaNs explicitly)."""
    eps = 1e-12
    mag = jnp.maximum(jnp.abs(d), eps)
    return jnp.where(d >= 0, 1.0, -1.0) / mag


def _slab_test(bounds, o, inv_d, t_cur):
    """Vectorized madmann slab test over 8 children.

    bounds [N,8,6]; returns (t_near [N,8], hit [N,8]). Empty slots carry
    inverted boxes and always miss.
    """
    t0 = (bounds[..., 0:3] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (bounds[..., 3:6] - o[:, None, :]) * inv_d[:, None, :]
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (tmin <= tmax) & (tmax > 0.0) & (tmin < t_cur[:, None])
    return jnp.where(hit, jnp.maximum(tmin, 0.0), jnp.inf), hit


def _traverse(child_bounds, child_entry, refs, tri_geom,
              o, d, t_max, active,
              stack_depth: int, leaf_size: int, any_hit_mode: bool,
              visit_bucket=None, num_buckets: int = 0):
    """visit_bucket/num_buckets: optional [W] i32 node->bucket map — the
    traversal then also accumulates per-bucket node-pop counts (the
    pilot-batch demand attribution of bvh/partition.py hot selection)."""
    n = o.shape[0]
    lane = jnp.arange(n, dtype=jnp.int32)
    inv_d = _safe_inv(d)

    stack = jnp.zeros((n, stack_depth), jnp.int32)  # root entry = node 0
    sp = jnp.where(active, 1, 0).astype(jnp.int32)

    counting = visit_bucket is not None
    counts0 = jnp.zeros((num_buckets,), jnp.int32) if counting \
        else jnp.zeros((0,), jnp.int32)
    t0_state = (stack, sp,
                t_max.astype(jnp.float32),
                jnp.full((n,), -1, jnp.int32),
                jnp.zeros((n,), jnp.float32),
                jnp.zeros((n,), jnp.float32),
                counts0)

    def cond(state):
        _, sp, *_ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, t, prim, u, v, counts = state
        live = sp > 0
        top = jnp.maximum(sp - 1, 0)
        entry = jnp.take_along_axis(stack, top[:, None], axis=1)[:, 0]
        sp = jnp.where(live, sp - 1, sp)

        is_leaf = live & (entry < 0)
        is_node = live & (entry >= 0)

        # ---- internal expansion -------------------------------------
        nidx = jnp.where(is_node, entry, 0)
        if counting:
            counts = counts.at[visit_bucket[nidx]].add(
                is_node.astype(jnp.int32), mode="drop")
        bounds = child_bounds[nidx]          # [N,8,6] single gather
        centry = child_entry[nidx]           # [N,8]
        tnear, chit = _slab_test(bounds, o, inv_d, t)
        chit = chit & (centry != _INVALID) & is_node[:, None]

        if any_hit_mode:
            # Occlusion rays don't care about order: push unsorted.
            s_entry, s_hit, s_near = centry, chit, tnear
        else:
            order = jnp.argsort(jnp.where(chit, tnear, jnp.inf), axis=1)
            s_entry = jnp.take_along_axis(centry, order, axis=1)
            s_hit = jnp.take_along_axis(chit, order, axis=1)
            s_near = None

        incl = jnp.cumsum(s_hit.astype(jnp.int32), axis=1)
        total = incl[:, -1]
        # Nearest child must end up on top: position = sp + total - incl_j.
        pos = sp[:, None] + total[:, None] - incl
        pos = jnp.where(s_hit, pos, stack_depth)  # out-of-range -> dropped
        for j in range(child_entry.shape[-1]):
            stack = stack.at[lane, pos[:, j]].set(s_entry[:, j], mode="drop")
        sp = jnp.where(is_node, jnp.minimum(sp + total, stack_depth), sp)

        # ---- leaf intersection ---------------------------------------
        packed = jnp.where(is_leaf, -(entry + 1), 0)
        first = packed >> 4
        count = packed & 15
        for k in range(leaf_size):
            ok = is_leaf & (k < count)
            ridx = jnp.where(ok, first + k, 0)
            tidx = refs[ridx]
            tri = tri_geom[tidx]
            tt, tu, tv, th = mt_intersect(tri, o, d)
            closer = ok & th & (tt < t)
            t = jnp.where(closer, tt, t)
            prim = jnp.where(closer, tidx, prim)
            u = jnp.where(closer, tu, u)
            v = jnp.where(closer, tv, v)

        if any_hit_mode:
            sp = jnp.where(prim >= 0, 0, sp)  # lane done on first hit

        return stack, sp, t, prim, u, v, counts

    _, _, t, prim, u, v, counts = jax.lax.while_loop(cond, body, t0_state)
    if counting:
        return t, prim, u, v, counts
    return t, prim, u, v


def closest_hit(wbvh, tri_geom, o, d, t_max, active=None,
                stack_depth: int = 48, leaf_size: int = 4) -> Hit:
    """Closest-hit traversal (role of IfIfClosestHit, BVH.glsl:634-767).

    Args:
      wbvh: WideBVH of device arrays; tri_geom [T, 9] packed (p0, e1, e2).
      o, d: [N, 3] rays; t_max: [N] max distance; active: [N] bool or None.
    """
    if active is None:
        active = jnp.ones(o.shape[0], bool)
    t, prim, u, v = _traverse(wbvh.child_bounds, wbvh.child_entry, wbvh.refs,
                              tri_geom, o, d, t_max, active,
                              stack_depth, leaf_size, False)
    return Hit(t=t, prim=prim, u=u, v=v)


def any_hit(wbvh, tri_geom, o, d, t_max, active=None,
            stack_depth: int = 48, leaf_size: int = 4):
    """Any-hit traversal (role of IfIfAnyHit, BVH.glsl:769-854).

    Returns occluded [N] bool: True iff something lies within (0, t_max).
    """
    if active is None:
        active = jnp.ones(o.shape[0], bool)
    _, prim, _, _ = _traverse(wbvh.child_bounds, wbvh.child_entry, wbvh.refs,
                              tri_geom, o, d, t_max, active,
                              stack_depth, leaf_size, True)
    return prim >= 0


def count_entry_visits(wbvh, tri_geom, o, d, t_max, bucket_map,
                       num_buckets: int, stack_depth: int = 48,
                       leaf_size: int = 4):
    """Pilot-batch demand attribution: closest-hit traverse the pilot
    rays per-lane and return [num_buckets] node-pop counts, attributed
    through `bucket_map` ([W] i32 wide-node index -> bucket). The input
    of bvh/partition.py's pops-attributed hot-subtree selection — unlike
    the slab-entry estimate, this sees traversal DEPTH (PERF.md
    replicate-hot: camera rays enter many subtree boxes shallowly, the
    deep work concentrates in a few central subtrees)."""
    active = jnp.ones(o.shape[0], bool)
    out = _traverse(wbvh.child_bounds, wbvh.child_entry, wbvh.refs,
                    tri_geom, o, d, t_max, active, stack_depth, leaf_size,
                    False, visit_bucket=jnp.asarray(bucket_map, jnp.int32),
                    num_buckets=num_buckets)
    return out[4]


TRAVERSALS = ("cuda", "packet", "perray")


def resolve_traversal(name: str = "auto") -> str:
    """The traversal to run on the active backend.

    "auto" is the CUDA kernel on a GPU and the XLA packet path elsewhere.
    Asking for "cuda" off the GPU raises rather than running something
    else."""
    backend = jax.default_backend()
    if name == "auto":
        return "cuda" if backend == "gpu" else "packet"
    if name not in TRAVERSALS:
        raise ValueError(f"unknown traversal {name!r}; expected 'auto' or "
                         f"one of {TRAVERSALS}")
    if name == "cuda" and backend != "gpu":
        raise ValueError(f"the CUDA traversal needs a GPU backend, not "
                         f"{backend!r}")
    return name


def _pad_rays(o, d, t_max, active, multiple: int):
    """Pad a wavefront to a multiple of the packet size with dead rays."""
    n = o.shape[0]
    pad = (-n) % multiple
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        # Unit direction so inv-dir math stays finite on the padding.
        dpad = jnp.zeros((pad, 3), d.dtype).at[:, 0].set(1.0)
        d = jnp.concatenate([d, dpad])
        t_max = jnp.concatenate([t_max, jnp.zeros((pad,), t_max.dtype)])
        active = jnp.concatenate([active, jnp.zeros((pad,), bool)])
    return o, d, t_max, active, n


def trace_rows(rows, o, d, t_max, active, *, traversal: str,
               stack_depth: int, leaf_size: int, packet_size: int = 128,
               any_hit: bool = False, root=None):
    """Trace [N] rays against a merged [M, 128] node/leaf table with the
    "cuda" or "packet" traversal; `root` is a scalar initial stack entry
    (default 0). Returns (t, prim, u, v, pops): [N] hit arrays (prim >= 0
    on a hit; any-hit lanes report occlusion the same way) and an i32
    scalar of traversal work, stack pops summed over rays (cuda) or over
    packets (packet)."""
    if traversal == "cuda":
        from gpupathtracer_tpu.ops.cuda_traverse import traverse_rows_cuda
        t, prim, u, v, pops = traverse_rows_cuda(
            rows, o, d, t_max, active, stack_depth=stack_depth,
            any_hit=any_hit, root=root)
        return t, prim, u, v, jnp.sum(pops, dtype=jnp.int32)
    if traversal != "packet":
        raise ValueError(f"trace_rows runs 'cuda' or 'packet', not "
                         f"{traversal!r}")
    from gpupathtracer_tpu.ops.packet_traverse import traverse_packets
    ps = min(packet_size, o.shape[0])
    o, d, t_max, active, n = _pad_rays(o, d, t_max, active, ps)
    t, prim, u, v, pops = traverse_packets(
        rows, o, d, t_max, active, stack_depth=stack_depth,
        leaf_size=leaf_size, packet_size=ps, any_hit=any_hit, root=root)
    return t[:n], prim[:n], u[:n], v[:n], jnp.sum(pops, dtype=jnp.int32)


def _rows_hold(scene, leaf_size: int) -> bool:
    """Whether the merged table holds this tree: 8-wide nodes and leaves
    of one row (at most 10 triangles)."""
    return scene.bvh.child_entry.shape[1] == 8 and leaf_size <= 10


def trace_closest(scene, o, d, t_max, active, *, stack_depth: int,
                  leaf_size: int, traversal: str = "auto",
                  packet_size: int = 128) -> Hit:
    """Closest-hit query through the traversal chosen for the backend."""
    traversal = resolve_traversal(traversal)
    if traversal == "perray" or not _rows_hold(scene, leaf_size):
        return closest_hit(scene.bvh, scene.tri_geom, o, d, t_max, active,
                           stack_depth=stack_depth, leaf_size=leaf_size)
    t, prim, u, v, _ = trace_rows(
        scene.bvh.node_rows, o, d, t_max, active, traversal=traversal,
        stack_depth=stack_depth, leaf_size=leaf_size,
        packet_size=packet_size)
    return Hit(t=t, prim=prim, u=u, v=v)


def trace_occluded(scene, o, d, t_max, active, *, stack_depth: int,
                   leaf_size: int, traversal: str = "auto",
                   packet_size: int = 128):
    """Any-hit/occlusion query: [N] bool, True iff something lies within
    (0, t_max)."""
    traversal = resolve_traversal(traversal)
    if traversal == "perray" or not _rows_hold(scene, leaf_size):
        return any_hit(scene.bvh, scene.tri_geom, o, d, t_max, active,
                       stack_depth=stack_depth, leaf_size=leaf_size)
    _, prim, _, _, _ = trace_rows(
        scene.bvh.node_rows, o, d, t_max, active, traversal=traversal,
        stack_depth=stack_depth, leaf_size=leaf_size,
        packet_size=packet_size, any_hit=True)
    return prim >= 0
