from gpupathtracer_tpu.ops.intersect import mt_intersect, pack_tri_geom, brute_force_closest_hit
from gpupathtracer_tpu.ops.traverse import closest_hit, any_hit, trace_closest, trace_occluded, Hit
from gpupathtracer_tpu.ops.tonemap import present, tonemap_uncharted2
from gpupathtracer_tpu.ops.texture import sample_atlas

__all__ = [
    "mt_intersect", "pack_tri_geom", "brute_force_closest_hit",
    "closest_hit", "any_hit", "trace_closest", "trace_occluded", "Hit",
    "present", "tonemap_uncharted2", "sample_atlas",
]
