"""Continuous-batching serving over the port's models: the port of
``repro.serve``."""

from .decode import Request, ServeConfig, ServingEngine

__all__ = ["ServingEngine", "ServeConfig", "Request"]
