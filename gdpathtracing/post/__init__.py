from gdpathtracing.post.tonemap import aces_film
from gdpathtracing.post.progressive import (ProgressiveState,
                                                progressive_init,
                                                progressive_update)
from gdpathtracing.post.temporal import (TemporalState, temporal_init,
                                             temporal_update)

__all__ = [
    "aces_film", "ProgressiveState", "progressive_init", "progressive_update",
    "TemporalState", "temporal_init", "temporal_update",
]
