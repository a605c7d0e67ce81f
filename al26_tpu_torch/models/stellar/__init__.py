from . import evolution
