"""Dry-run analysis (port of ``repro.analysis``): the roofline and the
report tables."""
from .roofline import RooflineReport  # noqa: F401
