"""Parallel axes of the port: flattened ensembles on one device
(`ensemble`), and the device-mesh axes on torch.distributed: row-split
sweeps (`sharded`), ring-streamed sweeps (`ring`), the tree mesh
(`tree_mesh`) and the 1-D and 2-D ensemble meshes (`ensemble`)."""
from . import ensemble
