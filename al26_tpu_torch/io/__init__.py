"""Checkpoint I/O in the reference's on-disk formats (the port of
al26_tpu.io, without its orbax backend and native UBJSON codec)."""
