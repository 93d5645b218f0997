"""Data of the LM's training and the geometric benchmarks (the port of
``repro.data``)."""
from .pipeline import TokenPipeline, point_cloud, synthetic_batch

__all__ = ["TokenPipeline", "synthetic_batch", "point_cloud"]
