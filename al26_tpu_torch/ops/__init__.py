from . import deposition, integrators, nbody
