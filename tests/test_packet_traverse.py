import jax.numpy as jnp
import numpy as np
import pytest

from gpupathtracer_tpu.bvh import WideBVH, build_wide_bvh
from gpupathtracer_tpu.bvh.wide import pack_for_packets
from gpupathtracer_tpu.ops.intersect import pack_tri_geom
from gpupathtracer_tpu.ops.traverse import Hit, any_hit, closest_hit, trace_rows


def closest_hit_packets(dev, o, d, tmax, active=None, *, stack_depth,
                        packet_size=128):
    if active is None:
        active = jnp.ones((o.shape[0],), bool)
    t, prim, u, v, _ = trace_rows(dev.node_rows, o, d, tmax, active,
                                  traversal="packet", stack_depth=stack_depth,
                                  leaf_size=4, packet_size=packet_size)
    return Hit(t=t, prim=prim, u=u, v=v)


def any_hit_packets(dev, o, d, tmax, *, stack_depth, packet_size=128):
    _, prim, _, _, _ = trace_rows(dev.node_rows, o, d, tmax,
                                  jnp.ones((o.shape[0],), bool),
                                  traversal="packet", stack_depth=stack_depth,
                                  leaf_size=4, packet_size=packet_size,
                                  any_hit=True)
    return prim >= 0

pytestmark = pytest.mark.slow  # render/traversal jits dominate; quick tier = -m 'not slow'


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(7)
    n = 700
    base = rng.uniform(-5, 5, (n, 1, 3))
    offs = rng.uniform(-0.6, 0.6, (n, 3, 3))
    tri = (base + offs).astype(np.float32)
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=4, builder="numpy")
    wide = pack_for_packets(wide, p0, (p1 - p0), (p2 - p0), leaf_size=4)
    dev = WideBVH(*(jnp.asarray(a) if a is not None else None
                    for a in wide))
    geom = jnp.asarray(pack_tri_geom(p0, p1 - p0, p2 - p0))
    depth = stats.max_depth * 7 + 2
    rng2 = np.random.RandomState(3)
    o = rng2.uniform(-8, 8, (512, 3)).astype(np.float32)
    tgt = rng2.uniform(-4, 4, (512, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dev, geom, depth, jnp.asarray(o), jnp.asarray(d)


def test_packet_closest_matches_perray(scene):
    dev, geom, depth, o, d = scene
    tmax = jnp.full((512,), 1e20, jnp.float32)
    ref = closest_hit(dev, geom, o, d, tmax, stack_depth=depth)
    for K in (64, 128, 512):
        got = closest_hit_packets(dev, o, d, tmax, stack_depth=depth,
                                  packet_size=K)
        np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                                   rtol=1e-5, atol=1e-5, err_msg=f"K={K}")
        np.testing.assert_array_equal(np.asarray(got.prim < 0),
                                      np.asarray(ref.prim < 0))


def test_packet_any_hit_matches_perray(scene):
    dev, geom, depth, o, d = scene
    ref_hit = closest_hit(dev, geom, o, d, jnp.full((512,), 1e20),
                          stack_depth=depth)
    short = jnp.where(ref_hit.prim >= 0, ref_hit.t * 0.99, 1e-3)
    past = jnp.where(ref_hit.prim >= 0, ref_hit.t * 1.01, 1e-3)
    for K in (64, 256):
        occ_s = any_hit_packets(dev, o, d, short, stack_depth=depth,
                                packet_size=K)
        assert not bool(occ_s.any()), f"K={K}"
        occ_p = any_hit_packets(dev, o, d, past, stack_depth=depth,
                                packet_size=K)
        np.testing.assert_array_equal(np.asarray(occ_p),
                                      np.asarray(ref_hit.prim >= 0))


def test_packet_inactive_rays(scene):
    dev, geom, depth, o, d = scene
    tmax = jnp.full((512,), 1e20, jnp.float32)
    active = jnp.arange(512) % 3 == 0
    got = closest_hit_packets(dev, o, d, tmax, active=active,
                              stack_depth=depth, packet_size=128)
    inact = ~np.asarray(active)
    assert (np.asarray(got.prim)[inact] == -1).all()
    ref = closest_hit(dev, geom, o, d, tmax, active=active, stack_depth=depth)
    np.testing.assert_allclose(np.asarray(got.t)[~inact],
                               np.asarray(ref.t)[~inact], rtol=1e-5)


def test_leaf_rows_roundtrip(scene):
    dev, *_ = scene
    # prim ids bit-cast through the float rows survive exactly; leaf rows
    # live after the W node rows in the merged table.
    W = dev.child_bounds.shape[0]
    lr = np.asarray(dev.node_rows)[W:]
    pids = lr[:, 9].view(np.int32)
    assert pids.max() < 700 and pids.min() >= -1


def test_compaction_path_matches(scene):
    """Enough packets to trigger the lockstep-tail compaction path; results
    must match the per-ray traversal exactly."""
    dev, geom, depth, o, d = scene
    import jax.numpy as jnp
    # Tile rays to 4096 so P = 64 packets of 64 rays (compaction active).
    o8 = jnp.tile(o, (8, 1))
    d8 = jnp.tile(d, (8, 1))
    tmax = jnp.full((4096,), 1e20, jnp.float32)
    ref = closest_hit(dev, geom, o8, d8, tmax, stack_depth=depth)
    got = closest_hit_packets(dev, o8, d8, tmax, stack_depth=depth,
                              packet_size=64)
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.prim < 0),
                                  np.asarray(ref.prim < 0))
