"""al26_tpu_torch: the PyTorch/CUDA port of al26_tpu.

Star-cluster N-body dynamics coupled to stellar evolution and
short-lived-radioisotope (26Al/60Fe) enrichment of protoplanetary discs,
as in al26_tpu (the JAX package beside it, which stays the reference),
with the direct-summation gravity sweeps and the Barnes-Hut tier's near
field as hand-written CUDA kernels for Hopper (ops/cuda_nbody.py,
ops/cuda_tree.py, csrc/). Same module layout and public names as
al26_tpu; plain functions on tensors with an explicit device.

The ported slice is the single-device run: the command line (cli, `python
-m al26_tpu_torch.cli`), the run driver with the JAX package's checkpoint
files, resume and extension (sim.driver.run / run_ensemble, io), and the
library API beneath it, Plummer or fractal initial conditions, exact
direct summation or force_impl="tree": sim.init_cluster, then
sim.run_steps / sim.run_steps_cached; and ensembles of realizations on
one device (parallel.ensemble: init_ensemble, then ensemble_run_steps or
ensemble_fresh_cache + ensemble_run_steps_cached), whose flattened step
sweeps block-diagonal groups through kernel 1's group windows; and the
analysis layer (plotting: the readers, the snapshot diagnostics on
tensors, the ensemble post-processor and the figure scripts).
"""
import torch

__version__ = "0.1.0"

# Full-f32 products everywhere (the einsums of the integrator's fast-group
# override, of the wind deposition and of the tree's far field, whose
# gram-form r^2 cancels): TF32 keeps ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import SimConfig  # noqa: E402
from .state import Cluster, SimState  # noqa: E402
