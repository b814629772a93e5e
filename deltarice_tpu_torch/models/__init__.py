"""Detector-dataset profiles: Nab, nEDM@SNS and NOPTREX geometries and
codec parameters, with synthetic waveform generators (numpy only)."""

from .profiles import PROFILES, DatasetProfile, get_profile

__all__ = ["PROFILES", "DatasetProfile", "get_profile"]
