"""Partitioned TRACE equivalence vs the replicated whole-tree traversal
on the 8-device CPU mesh (split from the original test_partition.py
monolith; structural tests live in test_partition.py, render-level in
test_partition_render.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from gpupathtracer_tpu.bvh.partition import build_partition
from gpupathtracer_tpu.ops.traverse import trace_closest, trace_occluded
from gpupathtracer_tpu.parallel.partition import (shard_partition,
                                                  trace_closest_partitioned)

from partition_util import load_bunny, random_rays

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def bunny():
    return load_bunny()


def test_partitioned_trace_matches_replicated(bunny):
    scene, meta = bunny
    rows = np.asarray(scene.bvh.node_rows)
    W = scene.bvh.child_bounds.shape[0]
    part = build_partition(rows, W, 8)
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("chips",))
    tables, dev_bounds = shard_partition(part, mesh)

    N = 1024
    o, d, act = random_rays(N, 7)
    tmax = jnp.full((N,), 1e20, jnp.float32)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              packet_size=128)

    ref = trace_closest(scene, o, d, tmax, act, traversal="perray", **kw)
    hit = trace_closest_partitioned(mesh, tables, dev_bounds, o, d, tmax,
                                    act, **kw)
    t_p, t_r = np.asarray(hit.t), np.asarray(ref.t)
    np.testing.assert_allclose(t_p, t_r, rtol=1e-5, atol=1e-5)
    # Exact-t ties between coplanar triangles may resolve to a different
    # (equally correct) prim across the ring order.
    same = np.asarray(hit.prim) == np.asarray(ref.prim)
    assert (same | np.isclose(t_p, t_r, rtol=1e-6, atol=1e-6)).all()


def test_partitioned_stats_counters(bunny):
    """with_stats: the per-(chip, hop) routed/improved counters are
    consistent — results unchanged, improved <= routed, every found hit
    implies at least one improving hop, and total routed/ray (the hops/ray
    V of the migration cost model, counted by tools/partition_bench.py) is
    bounded by the ring length."""
    scene, meta = bunny
    rows = np.asarray(scene.bvh.node_rows)
    W = scene.bvh.child_bounds.shape[0]
    part = build_partition(rows, W, 8)
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("chips",))
    tables, dev_bounds = shard_partition(part, mesh)

    N = 512
    o, d, act = random_rays(N, 3)
    tmax = jnp.full((N,), 1e20, jnp.float32)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              packet_size=128)

    plain = trace_closest_partitioned(mesh, tables, dev_bounds, o, d, tmax,
                                      act, **kw)
    hit, stats = trace_closest_partitioned(mesh, tables, dev_bounds, o, d,
                                           tmax, act, with_stats=True, **kw)
    np.testing.assert_array_equal(np.asarray(hit.t), np.asarray(plain.t))
    s = np.asarray(stats)
    assert s.shape == (8, 3, 8)
    routed, improved, pops = s[:, 0, :], s[:, 1, :], s[:, 2, :]
    assert (improved <= routed).all()
    n_hits = int((np.asarray(hit.prim) >= 0).sum())
    assert improved.sum() >= n_hits > 0
    n_act = int(np.asarray(act).sum())
    v = routed.sum() / n_act
    assert 0.0 < v <= 8.0
    # Kernel pops (node + leaf): real work happens exactly where rays
    # route — every hop with routed rays pops at least the local root.
    assert (pops[routed > 0] > 0).all()
    assert pops.sum() >= routed.sum() // 128  # >= one pop per packet


def test_partitioned_occlusion_matches_replicated(bunny):
    scene, meta = bunny
    rows = np.asarray(scene.bvh.node_rows)
    W = scene.bvh.child_bounds.shape[0]
    part = build_partition(rows, W, 8)
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("chips",))
    tables, dev_bounds = shard_partition(part, mesh)

    N = 512
    o, d, act = random_rays(N, 9, act_thresh=0.15)
    tmax = jnp.full((N,), 3.0, jnp.float32)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              packet_size=128)

    ref = trace_occluded(scene, o, d, tmax, act, traversal="perray", **kw)
    occ = trace_closest_partitioned(mesh, tables, dev_bounds, o, d, tmax,
                                    act, any_hit=True, **kw)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))


def test_partitioned_trace_replicate_hot(bunny):
    """Hot-subtree replication (build_partition(replicate_hot=K)): hop-0
    roots carry the K hottest subtrees on EVERY chip, steady roots drop
    them everywhere (including the former owner), so each ray still sees
    each subtree exactly once — results must match the replicated
    whole-tree traversal exactly, closest and any-hit. (Structural layout
    invariants are covered in test_partition.py.)"""
    scene, meta = bunny
    rows = np.asarray(scene.bvh.node_rows)
    W = scene.bvh.child_bounds.shape[0]
    part = build_partition(rows, W, 8, replicate_hot=2)

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("chips",))
    tables, route = shard_partition(part, mesh)

    N = 1024
    o, d, act = random_rays(N, 21)
    tmax = jnp.full((N,), 1e20, jnp.float32)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              packet_size=128)

    ref = trace_closest(scene, o, d, tmax, act, traversal="perray", **kw)
    hit = trace_closest_partitioned(mesh, tables, route, o, d, tmax,
                                    act, **kw)
    t_p, t_r = np.asarray(hit.t), np.asarray(ref.t)
    np.testing.assert_allclose(t_p, t_r, rtol=1e-5, atol=1e-5)
    same = np.asarray(hit.prim) == np.asarray(ref.prim)
    assert (same | np.isclose(t_p, t_r, rtol=1e-6, atol=1e-6)).all()

    tm3 = jnp.full((N,), 3.0, jnp.float32)
    occ_ref = trace_occluded(scene, o, d, tm3, act, traversal="perray",
                             **kw)
    occ = trace_closest_partitioned(mesh, tables, route, o, d, tm3, act,
                                    any_hit=True, **kw)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_ref))


def test_pilot_visit_counts(bunny):
    """count_entry_visits + node_bucket_map (pops-attributed pilot
    demand): counts land only in real buckets, and the counting traversal
    is the same traversal (hits unchanged vs trace_closest perray)."""
    from gpupathtracer_tpu.bvh.partition import (node_bucket_map,
                                                 partition_cut)
    from gpupathtracer_tpu.ops.traverse import closest_hit, \
        count_entry_visits

    scene, meta = bunny
    rows = np.asarray(scene.bvh.node_rows)
    W = scene.bvh.child_bounds.shape[0]
    cut_e, _ = partition_cut(rows, W, 8)
    C = len(cut_e)
    bucket = node_bucket_map(rows, W, cut_e)

    N = 256
    o, d, _ = random_rays(N, 5)
    tmax = jnp.full((N,), 1e20, jnp.float32)

    counts = np.asarray(count_entry_visits(
        scene.bvh, scene.tri_geom, o, d, tmax, bucket, C + 1,
        stack_depth=meta.stack_depth, leaf_size=meta.leaf_size))
    assert counts.shape == (C + 1,)
    assert counts[:C].sum() > 0

    # The counting traversal must not change traversal results.
    ref = closest_hit(scene.bvh, scene.tri_geom, o, d, tmax,
                      stack_depth=meta.stack_depth,
                      leaf_size=meta.leaf_size)
    assert np.isfinite(np.asarray(ref.t)).all()


def test_replicate_hot_two_level_roots(bunny):
    """D=3 partition with 6 replicated hot entries: hop-0 roots hold >8
    children, so they need a second synthetic level and the steady root
    lands past it (the _emit_root(at>0) layout). Equivalence vs the
    replicated tree on a 3-chip mesh."""
    scene, meta = bunny
    rows = np.asarray(scene.bvh.node_rows)
    W = scene.bvh.child_bounds.shape[0]
    part = build_partition(rows, W, 3, replicate_hot=6)
    # The layout actually grew second levels (else this test is vacuous).
    assert (part.steady_root > 1).any(), part.steady_root
    mesh = Mesh(np.array(jax.devices()[:3]), axis_names=("chips",))
    tables, route = shard_partition(part, mesh)

    N = 510  # divides the 3-chip axis
    o, d, _ = random_rays(N, 31)
    act = jnp.ones((N,), bool)
    tmax = jnp.full((N,), 1e20, jnp.float32)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              packet_size=128)

    ref = trace_closest(scene, o, d, tmax, act, traversal="perray", **kw)
    hit = trace_closest_partitioned(mesh, tables, route, o, d, tmax,
                                    act, **kw)
    t_p, t_r = np.asarray(hit.t), np.asarray(ref.t)
    np.testing.assert_allclose(t_p, t_r, rtol=1e-5, atol=1e-5)
    same = np.asarray(hit.prim) == np.asarray(ref.prim)
    assert (same | np.isclose(t_p, t_r, rtol=1e-6, atol=1e-6)).all()


def test_partitioned_trace_ici_contract(bunny):
    """HLO-level pin of the interconnect contract of the ring: the
    partitioned trace moves ray state ONLY via collective-permute (the
    static ring — uniform per-hop bandwidth), with NO all-reduce /
    all-gather / all-to-all / reduce-scatter anywhere, so a refactor
    cannot silently introduce demand-dependent exchanges or film-sized
    reductions into the traversal."""
    import re

    scene, meta = bunny
    rows = np.asarray(scene.bvh.node_rows)
    W = scene.bvh.child_bounds.shape[0]
    part = build_partition(rows, W, 8)
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("chips",))
    tables, route = shard_partition(part, mesh)

    N = 1024
    o = jnp.zeros((N, 3), jnp.float32)
    d = jnp.zeros((N, 3), jnp.float32).at[:, 0].set(1.0)
    tmax = jnp.full((N,), 1e20, jnp.float32)
    act = jnp.ones((N,), bool)

    def fn(tables, route, o, d, tmax, act):
        return trace_closest_partitioned(
            mesh, tables, route, o, d, tmax, act,
            stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
            packet_size=128)

    txt = (jax.jit(fn).lower(tables, route, o, d, tmax, act)
           .compile().as_text())
    assert re.search(r"collective-permute", txt), "ring ppermute missing"
    bad = [ln for ln in txt.splitlines()
           if re.search(r"all-reduce|all-gather|all-to-all|reduce-scatter",
                        ln)]
    assert not bad, f"unexpected collectives in the trace: {bad[:3]}"


def test_routed_trace_matches_ring(bunny):
    """Demand-routed exchange (trace_partitioned_routed) returns the SAME
    hits as the ring: a chip is skipped only when the ray's entry t into
    its forest is >= the final hit t, which cannot contribute, so t is
    bitwise-identical (same kernel, same table, same ray on the owning
    chip). Stats invariants: every ray delivered, pops concentrated in
    the early rounds, transported counts bounded by the bucket budget."""
    scene, meta = bunny
    rows = np.asarray(scene.bvh.node_rows)
    W = scene.bvh.child_bounds.shape[0]
    part = build_partition(rows, W, 8)  # replicate_hot default
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("chips",))
    tables, route = shard_partition(part, mesh)

    N = 1024
    o, d, act = random_rays(N, 11)
    tmax = jnp.full((N,), 1e20, jnp.float32)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              packet_size=128)

    ring = trace_closest_partitioned(mesh, tables, route, o, d, tmax,
                                     act, **kw)
    routed, stats = trace_closest_partitioned(
        mesh, tables, route, o, d, tmax, act, routing="routed",
        max_rounds=10, with_stats=True, **kw)

    s_pre = np.asarray(stats)
    assert int(s_pre[:, 3, -1].sum()) == 0, \
        "undelivered rays after max_rounds (truncation)"
    np.testing.assert_array_equal(np.asarray(routed.t), np.asarray(ring.t))
    same = np.asarray(routed.prim) == np.asarray(ring.prim)
    assert (same | np.isclose(np.asarray(routed.t), np.asarray(ring.t),
                              rtol=1e-6, atol=1e-6)).all()

    s = np.asarray(stats)                 # [D, 4, R+1]
    assert s.shape == (8, 4, 11)
    pops, sent, dlvr, live = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    n_act = int(np.asarray(act).sum())
    assert int(dlvr.sum()) == n_act       # every active ray delivered once
    assert pops.sum() > 0 and pops[:, 0].sum() >= pops[:, -1].sum()
    assert (sent >= 0).all()


def test_routed_occlusion_matches_ring(bunny):
    scene, meta = bunny
    rows = np.asarray(scene.bvh.node_rows)
    W = scene.bvh.child_bounds.shape[0]
    part = build_partition(rows, W, 8)
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("chips",))
    tables, route = shard_partition(part, mesh)

    N = 1024
    o, d, _ = random_rays(N, 13)
    act = jnp.ones((N,), bool)
    tmax = jnp.full((N,), 4.0, jnp.float32)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              packet_size=128, any_hit=True)

    occ_ring = trace_closest_partitioned(mesh, tables, route, o, d, tmax,
                                         act, **kw)
    occ_routed, stats = trace_closest_partitioned(
        mesh, tables, route, o, d, tmax, act, routing="routed",
        max_rounds=10, with_stats=True, **kw)
    np.testing.assert_array_equal(np.asarray(occ_routed),
                                  np.asarray(occ_ring))
    assert int(np.asarray(stats)[:, 3, -1].sum()) == 0
