# fractal initial conditions are not ported yet (ROADMAP queue 1)
from . import agb, discs, imf, plummer, yields
