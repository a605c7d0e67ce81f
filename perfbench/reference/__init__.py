"""The plain reference of the benchmark: plain torch and numpy, no code of
the program (al26_tpu_torch) or of the JAX package."""
