"""Demand-routed partitioned trace under bucket contention (quick tier).

Small buckets force rays to wait for transport credit, so delivering every
ray takes more exchange rounds than the D + 2 an uncontended ray needs.
The rounds must run until every ray is home: a fixed round count would
leave some rays with their home hop's hit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from gpupathtracer_tpu.bvh.partition import build_partition
from gpupathtracer_tpu.ops.traverse import trace_closest, trace_occluded
from gpupathtracer_tpu.parallel.partition import (shard_partition,
                                                  trace_closest_partitioned)

from partition_util import load_bunny

D = 4
N = 256


@pytest.fixture(scope="module")
def setup():
    """Bunny on its ground plane split over 4 devices with no replicated
    subtrees, and horizontal rays from a far circle through the bunny:
    most of them need several devices' subtrees."""
    scene, meta = load_bunny()
    part = build_partition(np.asarray(scene.bvh.node_rows),
                           scene.bvh.child_bounds.shape[0], D,
                           replicate_hot=0)
    mesh = Mesh(np.array(jax.devices()[:D]), axis_names=("chips",))
    tables, route = shard_partition(part, mesh)
    rng = np.random.RandomState(5)
    ang = rng.rand(N) * 2 * np.pi
    o = np.stack([60 * np.cos(ang), 0.3 + 2 * rng.rand(N),
                  60 * np.sin(ang)], 1)
    target = np.stack([rng.uniform(-3, 3, N), 0.3 + 2 * rng.rand(N),
                       rng.uniform(-3, 3, N)], 1)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.ones((N,), bool))
    return scene, meta, mesh, tables, route, rays


@pytest.mark.parametrize("any_hit", [False, True])
def test_routed_delivers_every_ray_under_contention(setup, any_hit):
    scene, meta, mesh, tables, route, (o, d, act) = setup
    tmax = jnp.full((N,), 60.0 if any_hit else 1e20, jnp.float32)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)

    out, stats = trace_closest_partitioned(
        mesh, tables, route, o, d, tmax, act, routing="routed",
        bucket_cap=8, with_stats=True, packet_size=64, any_hit=any_hit,
        **kw)

    s = np.asarray(stats)                       # [D, 4, R + 1]
    assert s.shape == (D, 4, 8 * D + 1)         # default cap: 8 * D rounds
    sent, dlvr, live = s[:, 1], s[:, 2], s[:, 3]
    if not any_hit:
        rounds = int(np.nonzero(sent.sum(0))[0].max())
        assert rounds > D + 2, "buckets this small must force extra rounds"
    assert int(live[:, -1].sum()) == 0, "rays left in flight"
    assert int(dlvr.sum()) == N                 # every ray delivered once
    if any_hit:
        ref = trace_occluded(scene, o, d, tmax, act, **kw)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    else:
        ref = trace_closest(scene, o, d, tmax, act, **kw)
        np.testing.assert_array_equal(np.asarray(out.t), np.asarray(ref.t))
