from gpupathtracer_tpu.parallel.mesh import (make_device_mesh,
                                             render_sample_sharded)
from gpupathtracer_tpu.parallel.partition import (shard_partition,
                                                  trace_closest_partitioned)

__all__ = ["make_device_mesh", "render_sample_sharded",
           "shard_partition", "trace_closest_partitioned"]
