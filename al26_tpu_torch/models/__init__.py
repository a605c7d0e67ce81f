from . import agb, discs, fractal, imf, plummer, yields
