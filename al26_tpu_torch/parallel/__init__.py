"""Parallel axes of the port. Single-device flattened ensembles
(`ensemble`); the device-mesh axes (sharded rows, the ring, the tree mesh,
the 2-D ensemble mesh) are not ported yet (ROADMAP queue 1, item 8)."""
from . import ensemble
