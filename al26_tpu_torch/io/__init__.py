"""Checkpoint I/O in the reference's on-disk formats (the port of
al26_tpu.io: the native UBJSON codec built at first use, and a DCP tree in
place of its orbax backend)."""
