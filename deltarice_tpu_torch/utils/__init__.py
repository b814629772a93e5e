"""Utilities: kernel warm-up and profiling."""

from .profiling import device_trace, throughput

__all__ = ["device_trace", "throughput"]
