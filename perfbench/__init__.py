"""The benchmark of al26_tpu_torch on CUDA cards (run.py is the entry)."""
