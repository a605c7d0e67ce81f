from .init import SimAux, init_cluster
from .step import run_steps, run_steps_cached, run_steps_traj, step
