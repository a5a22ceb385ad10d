from gdpathtracing.parallel.sharding import (make_mesh,
                                                 render_radiance_sharded)
from gdpathtracing.parallel.fault import (inject_tile_fault,
                                              render_with_retry,
                                              tile_health)

__all__ = ["make_mesh", "render_radiance_sharded",
           "inject_tile_fault", "render_with_retry", "tile_health"]
