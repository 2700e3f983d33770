"""Partitioned multi-device traversal — rays migrate, devices own subtrees.

Counterpart of bvh/partition.py at trace time: the merged BVH table is
split into D per-device subtree tables (sharded over the mesh's "chips"
axis), and ray shards ROTATE between the devices with `jax.lax.ppermute`.
Hop s has chip c traverse the resident ray block against its local
subtree, masked to rays whose slab entry into
this chip's forest bounds is closer than their current best hit; after D
hops every block is home with the globally closest hit.

Two migration schemes, both static-shaped:

- RING (trace_partitioned_local, the default): shards rotate via
  ppermute, D hops; uniform per-hop bandwidth (48 B/ray * shard size *
  (D-1) hops), the simplest exchange there is. The pruning mask
  plays the role of near-first descent across chips: most rays are
  masked on most hops (measured V ~ 1.8 of 8 actual subtree visits per
  incoherent ray). The dead weight — bytes and forced shard/chip barrier
  alignment for the D-V masked hops — grows linearly with D.
- DEMAND-ROUTED (trace_partitioned_routed): rays hop only to the chips
  they still need, nearest-unvisited-first, via fixed [D, B] buckets and
  one all_to_all per round; receiver capacity is credit-guaranteed (an
  all_gather of free-slot counts), rays denied transport retry, so no
  demand distribution can drop a ray. ~44 B * (V+1) per ray total and
  ~V+2 barrier rounds instead of D. Its sort/gather glue runs once per
  hop on D-fold smaller shards. On devices joined all to all (NVLink)
  every destination costs the same, which suits this scheme.

Role in the reference: none — single GPU. This is the multi-device design
the dispatch grid (Renderer.cpp:660) cannot express.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpupathtracer_tpu.bvh.partition import Partition, build_partition
from gpupathtracer_tpu.ops.traverse import (Hit, _safe_inv,
                                            resolve_traversal, trace_rows)


class RouteInfo(NamedTuple):
    """Replicated per-device routing metadata (a pytree; passes through
    shard_map with a P() spec). With hot-subtree replication
    (bvh/partition.py replicate_hot) hop 0 routes/traverses a different
    forest than later hops — steady hops start at `steady_root` and skip
    the replicated hot subtrees, which every ray already saw on its home
    chip."""

    dev_bounds: jax.Array   # [D, 6] steady forest union (hops >= 1)
    dev_bounds0: jax.Array  # [D, 6] hop-0 forest union (incl. hot)
    steady_root: jax.Array  # [D] i32 root row for hops >= 1


def shard_partition(part: Partition, mesh: Mesh, axis: str = "chips"):
    """Device-put the partition: tables sharded over `axis`, RouteInfo
    (bounds + steady roots) replicated."""
    tables = jax.device_put(
        jnp.asarray(part.tables),
        NamedSharding(mesh, P(axis)))
    rep = NamedSharding(mesh, P())
    db = jnp.asarray(part.dev_bounds)
    db0 = (jnp.asarray(part.dev_bounds0) if part.dev_bounds0 is not None
           else db)
    sroot = (jnp.asarray(part.steady_root, jnp.int32)
             if part.steady_root is not None
             else jnp.zeros((part.tables.shape[0],), jnp.int32))
    route = RouteInfo(dev_bounds=jax.device_put(db, rep),
                      dev_bounds0=jax.device_put(db0, rep),
                      steady_root=jax.device_put(sroot, rep))
    return tables, route


def _local_trace(table, o, d, t_max, active, *, stack_depth, leaf_size,
                 packet_size, any_hit, root=None):
    """One device's traversal of its local subtree (root = synthetic row 0,
    or the scalar `root` entry — the steady root on hops >= 1 when hot
    subtrees are replicated), with the traversal chosen for the backend.
    Also returns the traversal's pop count (nodes + leaves): the actual
    work, which the routed-ray count cannot stand in for once per-visit
    table sizes differ (hot replication)."""
    return trace_rows(table, o, d, t_max, active,
                      traversal=resolve_traversal("auto"),
                      stack_depth=stack_depth, leaf_size=leaf_size,
                      packet_size=packet_size, any_hit=any_hit, root=root)


def trace_partitioned_local(table, dev_bounds, o, d, t_max, active, *,
                            axis_name: str, num_devices: int,
                            stack_depth: int, leaf_size: int,
                            packet_size: int = 2048, any_hit: bool = False,
                            with_stats: bool = False):
    """Ring-rotation traversal; call INSIDE shard_map.

    Args:
      table: this chip's [M', 128] local subtree table.
      dev_bounds: [D, 6] forest bounds of every chip (replicated), or a
        RouteInfo carrying separate hop-0 bounds + steady roots (hot
        subtrees replicated on every chip, served at hop 0 only).
      o, d, t_max, active: this chip's resident ray shard [n].
    Returns (t, prim, u, v) for the rays that STARTED on this chip.
    With with_stats also returns a [3, D] i32 row: per-hop count of rays
    ROUTED into this chip's subtree (`here`), of rays whose best hit
    IMPROVED (`better`), and of kernel POPS (node + leaf — the actual
    traversal work; visits are not comparable when hot replication gives
    hop 0 a larger root) — the inputs of a migration cost model.
    """
    D = num_devices
    me = jax.lax.axis_index(axis_name)
    n = o.shape[0]
    if isinstance(dev_bounds, RouteInfo):
        steady_b, hop0_b, sroot = dev_bounds
    else:
        steady_b = hop0_b = dev_bounds
        sroot = None

    t = t_max.astype(jnp.float32)
    prim = jnp.full((n,), -1, jnp.int32)
    u = jnp.zeros((n,), jnp.float32)
    v = jnp.zeros((n,), jnp.float32)
    act = active

    state = (o, d, t, prim, u, v, act)
    perm = [(i, (i + 1) % D) for i in range(D)]
    routed, improved, pops = [], [], []

    for step in range(D):
        o_c, d_c, t_c, prim_c, u_c, v_c, act_c = state
        # Route: does this ray enter my forest closer than its current hit?
        # Hop 0 serves the home shard against the hop-0 root (steady +
        # replicated hot subtrees); later hops start at the steady root.
        bounds = hop0_b if step == 0 else steady_b
        root = None if (sroot is None or step == 0) else sroot[me]
        inv = _safe_inv(d_c)
        lo = bounds[me, 0:3][None, :]
        hi = bounds[me, 3:6][None, :]
        t0 = (lo - o_c) * inv
        t1 = (hi - o_c) * inv
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        here = (tn <= tf) & (tf > 0.0) & (tn < t_c) & act_c
        if any_hit:
            here = here & (prim_c < 0)

        tt, pp, uu, vv, np_ = _local_trace(
            table, o_c, d_c, t_c, here, stack_depth=stack_depth,
            leaf_size=leaf_size, packet_size=packet_size, any_hit=any_hit,
            root=root)
        better = here & (pp >= 0) & (tt < t_c)
        t_c = jnp.where(better, tt, t_c)
        prim_c = jnp.where(better, pp, prim_c)
        u_c = jnp.where(better, uu, u_c)
        v_c = jnp.where(better, vv, v_c)

        if with_stats:
            routed.append(jnp.sum(here, dtype=jnp.int32))
            improved.append(jnp.sum(better, dtype=jnp.int32))
            pops.append(np_)

        state = (o_c, d_c, t_c, prim_c, u_c, v_c, act_c)
        if step < D - 1:
            state = jax.lax.ppermute(state, axis_name, perm)
    # D-1 hops: rotate once more so blocks land back on their origin chip —
    # only the hit payload (t/prim/u/v); o/d/act are dead after the loop,
    # so shipping them home would waste ~64% of the last hop's bytes.
    t, prim, u, v = jax.lax.ppermute(
        (state[2], state[3], state[4], state[5]), axis_name, perm)
    if with_stats:
        return t, prim, u, v, jnp.stack([jnp.stack(routed),
                                         jnp.stack(improved),
                                         jnp.stack(pops)])
    return t, prim, u, v


def _chip_slab(steady_b, o, d, t):
    """Entry distance of every ray into every chip's steady forest.

    Returns (tn [n, D] f32, enter [n, D] bool): slab entry t of ray i into
    chip c's forest union, and whether the ray enters it closer than its
    current best hit (the same prune the ring applies per hop,
    trace_partitioned_local's `here` mask, vectorized over chips)."""
    inv = _safe_inv(d)
    lo = steady_b[None, :, 0:3]
    hi = steady_b[None, :, 3:6]
    t0 = (lo - o[:, None, :]) * inv[:, None, :]
    t1 = (hi - o[:, None, :]) * inv[:, None, :]
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    enter = (tn <= tf) & (tf > 0.0) & (tn < t[:, None])
    return tn, enter


def trace_partitioned_routed(table, dev_bounds, o, d, t_max, active, *,
                             axis_name: str, num_devices: int,
                             stack_depth: int, leaf_size: int,
                             packet_size: int = 2048,
                             any_hit: bool = False,
                             max_rounds: int | None = None,
                             bucket_cap: int | None = None,
                             with_stats: bool = False):
    """Demand-ROUTED partitioned traversal; call INSIDE shard_map.

    The ring (trace_partitioned_local) rotates every shard through every
    chip: N*44 B of traffic per hop for D-1 hops, and each hop is a
    barrier whose cost the rotation's forced shard/chip pairing sets.
    Counted on a CPU mesh: an incoherent ray actually needs V ~= 1.8 of 8
    subtree visits, so ~3/4 of the ring's bytes and barrier alignment is
    dead weight that grows linearly with D.

    This variant moves each ray ONLY to the chips it needs, nearest
    unvisited subtree first (the cross-chip analogue of near-first
    descent): per round, every resident ray picks argmin entry-t over the
    unvisited chip forests it still enters closer than its current hit,
    rays bucket by destination, and one `all_to_all` exchanges the
    buckets. Receiver capacity is guaranteed by a per-round credit
    (free-slot counts are all_gathered; each sender may send at most
    free_c // D rays to chip c), so no ray is ever dropped; rays denied
    transport retry the next round. Finished rays route home and deliver
    their hit payload into the slot-stable output.

    Bytes moved become ~44 B * (visits beyond home + 1) per ray instead of
    44 * (D-1); rounds (each one all_to_all barrier + one local service)
    replace D ppermute hops. Rounds repeat (a while loop) until no ray is
    in flight on any chip: a ray needs up to D transports, and rays denied
    credit wait, so the count depends on the demand. Shapes are static
    throughout: resident arrays have capacity NR = n + D*B, exchanges are
    [D, B] buckets.

    Args mirror trace_partitioned_local; additionally
      max_rounds: cap on the exchange rounds (default 8 * D). Rays still
        undelivered when the cap stops the loop keep their home hop's hit
        in the output and are counted in the last column of stats row 3
        (truncation is detectable, never silent).
      bucket_cap: per-destination bucket size B (default ceil(n / D)
        rounded up to a multiple of 8, so D*B >= n — one round can
        offload a whole shard).
    Returns (t, prim, u, v) for the rays that STARTED on this chip; with
    with_stats also a [4, R+1] i32 row: per-round kernel pops (col 0 =
    the home hop), rays transported, rays delivered, rays still in
    flight at round end (columns past the last round run stay 0).
    """
    D = num_devices
    assert D <= 32, "visited bitmask is uint32"
    me = jax.lax.axis_index(axis_name)
    n = o.shape[0]
    R = max_rounds if max_rounds is not None else 8 * D
    B = bucket_cap if bucket_cap is not None else -((-n) // D)
    B = max(8, -((-B) // 8) * 8)
    NR = n + D * B
    DB = D * B

    if isinstance(dev_bounds, RouteInfo):
        steady_b, hop0_b, sroot = dev_bounds
    else:
        steady_b = hop0_b = dev_bounds
        sroot = None

    # --- home hop: serve the resident shard against the hop-0 root
    # (steady members + replicated hot subtrees), identical to the ring's
    # step 0. Every later service uses the steady root and the steady
    # forest bounds, so the visited bit c means "chip c's steady forest
    # served or provably unneeded".
    t = t_max.astype(jnp.float32)
    inv = _safe_inv(d)
    lo0 = hop0_b[me, 0:3][None, :]
    hi0 = hop0_b[me, 3:6][None, :]
    t0_ = (lo0 - o) * inv
    t1_ = (hi0 - o) * inv
    tn0 = jnp.max(jnp.minimum(t0_, t1_), axis=-1)
    tf0 = jnp.min(jnp.maximum(t0_, t1_), axis=-1)
    here0 = (tn0 <= tf0) & (tf0 > 0.0) & (tn0 < t) & active
    tt, pp, uu, vv, pops0 = _local_trace(
        table, o, d, t, here0, stack_depth=stack_depth,
        leaf_size=leaf_size, packet_size=packet_size, any_hit=any_hit)
    better = here0 & (pp >= 0) & (tt < t)
    out_t = jnp.where(better, tt, t)
    out_prim = jnp.where(better, pp, jnp.full((n,), -1, jnp.int32))
    out_u = jnp.where(better, uu, 0.0)
    out_v = jnp.where(better, vv, 0.0)

    # Resident state, capacity NR; slots [0, n) start as the home rays.
    pad = NR - n

    def _pad(x, fill=0.0):
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)])

    res = {
        "o": _pad(o), "d": _pad(d, 1.0), "t": _pad(out_t, jnp.inf),
        "u": _pad(out_u), "v": _pad(out_v),
        "prim": _pad(out_prim, -1),
        "home": _pad(me * n + jnp.arange(n, dtype=jnp.int32), 0),
        "visited": _pad(
            jnp.full((n,), jnp.uint32(1) << me.astype(jnp.uint32),
                     jnp.uint32), 0),
    }
    done0 = (~active) | (any_hit & (out_prim >= 0))
    tn_all, enter_all = _chip_slab(steady_b, res["o"], res["d"], res["t"])
    unvisited = ((res["visited"][:, None]
                  >> jnp.arange(D, dtype=jnp.uint32)[None, :]) & 1) == 0
    pending0 = jnp.any(enter_all & unvisited, axis=1)[:n] & ~done0
    act = jnp.concatenate([pending0, jnp.zeros((pad,), bool)])

    root = None if sroot is None else sroot[me]
    b_idx = jnp.arange(B, dtype=jnp.int32)

    def one_round(carry):
        (res, act, out_t, out_prim, out_u, out_v, r, _,
         pops_h, sent_h, dlvr_h, live_h) = carry
        res = dict(res)
        # (a) route: nearest unvisited needed chip, else home.
        tn_all, enter_all = _chip_slab(steady_b, res["o"], res["d"],
                                       res["t"])
        unvisited = ((res["visited"][:, None]
                      >> jnp.arange(D, dtype=jnp.uint32)[None, :]) & 1) == 0
        cand = enter_all & unvisited
        if any_hit:
            cand = cand & (res["prim"] < 0)[:, None]
        key_t = jnp.where(cand, tn_all, jnp.inf)
        nxt = jnp.argmin(key_t, axis=1).astype(jnp.int32)
        seek = jnp.isfinite(jnp.min(key_t, axis=1)) & act
        home_chip = res["home"] // n
        home_local = res["home"] % n
        dest = jnp.where(seek, nxt, home_chip)

        # Deliver in place: finished rays already home leave now.
        in_place = act & ~seek & (home_chip == me)
        idx_ip = jnp.where(in_place, home_local, n)
        out_t = _deliver(out_t, idx_ip, res["t"], in_place, n)
        out_prim = _deliver(out_prim, idx_ip, res["prim"], in_place, n)
        out_u = _deliver(out_u, idx_ip, res["u"], in_place, n)
        out_v = _deliver(out_v, idx_ip, res["v"], in_place, n)
        act = act & ~in_place

        transport = act & (dest != me)

        # (b) credit: every sender may place at most free_c // D seeking
        # rays on chip c this round (home deliveries bypass slots and are
        # only bucket-bounded), so merges can never overflow.
        free_cnt = jnp.int32(NR) - jnp.sum(act, dtype=jnp.int32)
        free_all = jax.lax.all_gather(free_cnt, axis_name)  # [D]
        credit = jnp.minimum(free_all // D, B).astype(jnp.int32)

        # (c) bucket by (dest, kind): within a destination group the
        # home-bound rays sort first (kind 0) — they never consume slot
        # credit. Rank-in-group via the sorted order; everything below is
        # gathers off one argsort (house rule: no scatters).
        kind = seek.astype(jnp.int32)  # 0 = going home, 1 = seeking
        key = jnp.where(transport, dest * 2 + kind, 2 * D)
        order = jnp.argsort(key)
        skey = key[order]
        edges = jnp.searchsorted(skey, jnp.arange(2 * D + 1))
        cnt_home = (edges[1::2] - edges[0:-1:2]).astype(jnp.int32)   # [D]
        cnt_seek = (edges[2::2] - edges[1::2]).astype(jnp.int32)     # [D]
        grant_home = jnp.minimum(cnt_home, B)
        grant_seek = jnp.minimum(jnp.minimum(cnt_seek, credit),
                                 B - grant_home)
        # Send slot (c, b): the b-th transport ray of dest group c in
        # sorted order; valid while b < grant_home + grant_seek, except
        # seeking rays beyond grant_home + grant_seek are denied (they
        # sort after the home-bound block, so one prefix test suffices).
        g0 = edges[0:-1:2].astype(jnp.int32)                         # [D]
        gslot = g0[:, None] + b_idx[None, :]                         # [D,B]
        valid_send = b_idx[None, :] < (grant_home + grant_seek)[:, None]
        sid = order[jnp.clip(gslot, 0, NR - 1)]                      # [D,B]
        # Sent mask back on resident slots: position p in sorted order is
        # sent iff p - group_start < grant (inverse-perm GATHER).
        k_sorted = jnp.clip(skey, 0, 2 * D - 1)
        c_sorted = k_sorted // 2
        rank = jnp.arange(NR, dtype=jnp.int32) - g0[c_sorted]
        sent_sorted = (skey < 2 * D) & (
            rank < (grant_home + grant_seek)[c_sorted])
        inv_order = jnp.argsort(order)
        sent = sent_sorted[inv_order]
        act = act & ~sent

        # (d) exchange: one all_to_all of the [D, B] buckets per field.
        send = {k: res[k][sid] for k in res}
        send["valid"] = valid_send
        send["seek"] = seek[sid] & valid_send
        recv = jax.tree.map(
            lambda x: jax.lax.all_to_all(x, axis_name, 0, 0), send)

        # (e) arrivals going home deliver straight into the output.
        rflat = {k: v.reshape((DB,) + v.shape[2:]) for k, v in recv.items()}
        dely = rflat["valid"] & ~rflat["seek"]
        r_home_local = rflat["home"] % n
        idx_d = jnp.where(dely, r_home_local, n)
        out_t = _deliver(out_t, idx_d, rflat["t"], dely, n)
        out_prim = _deliver(out_prim, idx_d, rflat["prim"], dely, n)
        out_u = _deliver(out_u, idx_d, rflat["u"], dely, n)
        out_v = _deliver(out_v, idx_d, rflat["v"], dely, n)

        # (f) merge seeking arrivals into free slots (gather-based: the
        # k-th valid arrival fills the k-th free slot).
        mv = rflat["valid"] & rflat["seek"]
        rorder = jnp.argsort(~mv)                      # valid first
        n_arr = jnp.sum(mv, dtype=jnp.int32)
        forder = jnp.argsort(act)                      # free slots first
        invf = jnp.argsort(forder)                     # slot -> free rank
        take = (~act) & (invf < n_arr)
        arr_idx = rorder[jnp.clip(invf, 0, DB - 1)]
        for kf in ("o", "d", "t", "u", "v", "prim", "home", "visited"):
            src = rflat[kf][arr_idx]
            keep = res[kf]
            m = take.reshape((NR,) + (1,) * (keep.ndim - 1))
            res[kf] = jnp.where(m, src, keep)
        act = act | take

        # (g) service: every resident ray that still needs THIS chip's
        # steady forest (fresh arrivals and credit-denied stayers alike).
        tn_me, enter_me = _chip_slab(steady_b[me][None], res["o"],
                                     res["d"], res["t"])
        my_bit = (res["visited"] >> me.astype(jnp.uint32)) & 1
        here = act & enter_me[:, 0] & (my_bit == 0)
        if any_hit:
            here = here & (res["prim"] < 0)
        tt, pp, uu, vv, pops_r = _local_trace(
            table, res["o"], res["d"], res["t"], here,
            stack_depth=stack_depth, leaf_size=leaf_size,
            packet_size=packet_size, any_hit=any_hit, root=root)
        better = here & (pp >= 0) & (tt < res["t"])
        res["t"] = jnp.where(better, tt, res["t"])
        res["prim"] = jnp.where(better, pp, res["prim"])
        res["u"] = jnp.where(better, uu, res["u"])
        res["v"] = jnp.where(better, vv, res["v"])
        res["visited"] = res["visited"] | jnp.where(
            here, jnp.uint32(1) << me.astype(jnp.uint32), jnp.uint32(0))

        live = jnp.sum(act, dtype=jnp.int32)
        r = r + 1
        pops_h = pops_h.at[r].set(pops_r.astype(jnp.int32))
        sent_h = sent_h.at[r].set(jnp.sum(valid_send, dtype=jnp.int32))
        dlvr_h = dlvr_h.at[r].set(jnp.sum(in_place, dtype=jnp.int32)
                                  + jnp.sum(dely, dtype=jnp.int32))
        live_h = live_h.at[r].set(live)
        return (res, act, out_t, out_prim, out_u, out_v, r,
                jax.lax.psum(live, axis_name),
                pops_h, sent_h, dlvr_h, live_h)

    # Rounds run until no ray is in flight on any chip; the psum'd count
    # rides in the carry so every chip runs the same iterations.
    hist = jnp.zeros((R + 1,), jnp.int32)
    live0 = jnp.sum(act, dtype=jnp.int32)
    carry = (res, act, out_t, out_prim, out_u, out_v, jnp.int32(0),
             jax.lax.psum(live0, axis_name),
             hist.at[0].set(pops0.astype(jnp.int32)), hist,
             hist.at[0].set(jnp.sum(~pending0 & active, dtype=jnp.int32)),
             hist.at[0].set(live0))
    carry = jax.lax.while_loop(lambda c: (c[6] < R) & (c[7] > 0),
                               one_round, carry)
    out_t, out_prim, out_u, out_v = carry[2:6]

    if with_stats:
        return out_t, out_prim, out_u, out_v, jnp.stack(carry[8:12])
    return out_t, out_prim, out_u, out_v


def _deliver(out, idx, payload, mask, n):
    """Scatter `payload[mask]` into out[idx]; masked lanes aim at the
    sentinel slot n (one pad lane, sliced off). One scatter per delivered
    ray per traversal — amortized, unlike the per-pop paths where
    scatters are banned (PERF.md XLA op costs)."""
    pad = jnp.concatenate([out, jnp.zeros((1,), out.dtype)])
    return pad.at[idx].set(jnp.where(mask, payload, 0).astype(out.dtype),
                           mode="drop")[:n]


def strip_scene_bvh(scene):
    """Scene pytree for the partitioned render step: the merged BVH table
    is NOT replicated (that is the point — each chip holds only its
    subtree slice); every bvh array is cut to its first row, keeping the
    pytree shape valid and the root-bounds helper row the integrator's
    sort-cell code reads. Shading tables (tri_shade/mat_rows/light_rows),
    materials, and the environment stay replicated — they are small and
    any chip may shade a hit found in any other chip's subtree."""
    b = scene.bvh
    return scene._replace(bvh=b._replace(
        child_bounds=b.child_bounds[:1], child_entry=b.child_entry[:1],
        refs=b.refs[:1], node_rows=b.node_rows[:1],
        packet_entry=(b.packet_entry[:1]
                      if b.packet_entry is not None else None)))


def render_sample_partitioned(mesh: Mesh, tables, dev_bounds, scene, cam,
                              pixel_x, pixel_y, key, sample_base=0,
                              axis: str = "chips", **static):
    """One scene-PARTITIONED multi-chip frame: pixels sharded over the
    chips axis, the BVH table partitioned per chip, every traversal
    riding the ppermute ring (models/wavefront.py partition mode).

    The distributed-memory counterpart of parallel/mesh.py's replicated
    sharding: D devices hold D-fold smaller resident trees, at the cost
    of ~44 B/ray/hop of interconnect traffic.

    pixel_x/pixel_y are the FULL ray-ordered arrays [N]; N must divide
    the chips axis. Returns ([N, 3] radiance, scalar rays traced).

    With a 2-axis mesh ("samples", "chips") the step composes
    data-parallel sample sharding OVER the scene partition (e.g. 2
    sample replicas x 2 subtree owners on four devices): each
    samples-row renders an independent spp of the same pixels, the ring
    collectives stay within each row's chips sub-axis, and contributions
    psum over "samples". Callers then treat the result as
    `samples_axis_size` accumulated spp (parallel/mesh.py convention)."""
    from functools import partial as _partial

    from gpupathtracer_tpu.models.wavefront import render_sample_impl

    D = mesh.shape[axis]
    has_samples = "samples" in mesh.axis_names
    scene_s = strip_scene_bvh(scene)

    @_partial(jax.shard_map, mesh=mesh,
              in_specs=(P(), P(), P(axis), P(), P(axis), P(axis), P(), P()),
              out_specs=(P(axis), P()),
              check_vma=False)
    def step(scene, cam, table, bounds, px, py, key, sample_base):
        sidx = sample_base
        if has_samples:
            s = jax.lax.axis_index("samples")
            key = jax.random.fold_in(key, s)
            sidx = sample_base + s
        key = jax.random.fold_in(key, jax.lax.axis_index(axis) + 7177)
        contribution, rays = render_sample_impl(
            scene, cam, px, py, key,
            partition=(table[0], bounds), partition_axis=axis,
            num_chips=D, sample_idx=sidx, **static)
        if has_samples:
            contribution = jax.lax.psum(contribution, "samples")
            rays = jax.lax.psum(rays, "samples")
        return contribution, jax.lax.psum(rays, axis)

    return step(scene_s, cam, tables, dev_bounds, pixel_x, pixel_y, key,
                jnp.asarray(sample_base, jnp.int32))


def trace_closest_partitioned(mesh: Mesh, tables, dev_bounds, o, d, t_max,
                              active, *, stack_depth: int, leaf_size: int,
                              packet_size: int = 2048,
                              any_hit: bool = False,
                              with_stats: bool = False,
                              axis: str = "chips",
                              routing: str = "ring",
                              max_rounds: int | None = None,
                              bucket_cap: int | None = None):
    """shard_map wrapper: full [N] rays in, full [N] Hit out (N must divide
    the chips axis). with_stats additionally returns per-chip counters:
    routing="ring" gives a [D, 3, D] i32 array of per-(SERVING-chip, hop)
    routed/improved ray counts and kernel pops — row c holds chip c's
    counters over the shards resident on it each hop (the shard that
    originated on chip (c - hop) mod D), the per-chip LOAD convention
    tools/partition_bench.py reports; routing="routed" (demand-routed
    all_to_all exchange, trace_partitioned_routed) gives [D, 4, R+1]:
    per-(chip, round) kernel pops, rays transported, rays delivered, and
    rays still in flight (column 0 is the home hop)."""
    D = mesh.shape[axis]
    n_stats = (P(axis),) if with_stats else ()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis), P(), P(axis), P(axis), P(axis), P(axis)),
             out_specs=(P(axis),) * 4 + n_stats,
             check_vma=False)
    def run(table, bounds, o_l, d_l, tm_l, act_l):
        if routing == "routed":
            out = trace_partitioned_routed(
                table[0], bounds, o_l, d_l, tm_l, act_l, axis_name=axis,
                num_devices=D, stack_depth=stack_depth,
                leaf_size=leaf_size, packet_size=packet_size,
                any_hit=any_hit, max_rounds=max_rounds,
                bucket_cap=bucket_cap, with_stats=with_stats)
        else:
            out = trace_partitioned_local(
                table[0], bounds, o_l, d_l, tm_l, act_l, axis_name=axis,
                num_devices=D, stack_depth=stack_depth,
                leaf_size=leaf_size, packet_size=packet_size,
                any_hit=any_hit, with_stats=with_stats)
        if with_stats:
            t_, p_, u_, v_, cnt = out
            return t_, p_, u_, v_, cnt[None]  # [1, ...] -> gathers per chip
        return out

    out = run(tables, dev_bounds, o, d, t_max, active)
    stats = None
    if with_stats:
        t, prim, u, v, stats = out
    else:
        t, prim, u, v = out
    if any_hit:
        return (prim >= 0, stats) if with_stats else prim >= 0
    hit = Hit(t=t, prim=prim, u=u, v=v)
    return (hit, stats) if with_stats else hit
