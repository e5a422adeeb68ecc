"""The synthetic token pipeline: the port of ``repro.data``."""

from .pipeline import DataConfig, SyntheticPipeline, make_pipeline

__all__ = ["DataConfig", "SyntheticPipeline", "make_pipeline"]
