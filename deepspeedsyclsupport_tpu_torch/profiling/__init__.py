"""FLOPS profiling of the port (``profiling/flops_profiler.py``)."""
from .flops_profiler import FlopsProfiler, get_model_profile, profile_fn  # noqa: F401
