from gdpathtracing.utils.stats import FrameStats, frame_stats, steps_heatmap

__all__ = ["FrameStats", "frame_stats", "steps_heatmap"]
