"""Checkpoint save/load in the reference's on-disk formats.

File layout per run (al26_nbody.py:347-439, filetypes.md):
  <base>-state-NNNNN.pkl.zst   zstd(pickle(State{cluster, converter, metadata}))
  <base>-yields.ubj.zst        zstd(ubjson(Yields.__dict__)), rewritten whole
  <base>-cluster-yields.csv    append-only global sums

The port's copy of al26_tpu/io/checkpoint.py: the state pickle names the
JAX package's classes (compat.dumps), so either package loads the other's
files. `load_state` reads the port's, the JAX package's and the ORIGINAL
reference's files (AMUSE pickles) through one unpickler (compat.loads).
"""
from __future__ import annotations

import glob
import os
import re
import time

from .compat import Metadata, Particles, State, dumps, loads
from .compression import compress, decompress
from .yields_store import Yields


def state_filename(base: str, nfile: int) -> str:
    return f"{base}-state-{str(nfile).zfill(5)}.pkl.zst"


def yields_filename(base: str) -> str:
    return f"{base}-yields.ubj.zst"


def yields_frames_filename(base: str) -> str:
    """Appendable framed yields store (O(N) per save instead of the
    reference's whole-blob rewrite; yields_store.marinate_frame)."""
    return f"{base}-yields.ubjf"


def most_recent_checkpoint(base: str) -> int:
    """Find the highest state-file number (al26_nbody.py:295-318)."""
    files = glob.glob(base + "-state-*")
    regex = re.compile(r"-state-(\d+)")
    highest = 0
    for file in files:
        m = regex.search(file)
        if m and int(m.group(1)) > highest:
            highest = int(m.group(1))
    path = state_filename(base, highest)
    if not os.path.isfile(path):
        raise IOError("Missing file! Somethings up!")
    return highest


def save_checkpoint(
    base: str, nfile: int, cluster_particles: Particles, converter,
    yields: Yields, metadata: Metadata, verbose: bool = False,
    yields_mode: str = "rewrite",
) -> None:
    """Write state + yields (al26_nbody.py:347-401).

    yields_mode: "rewrite" = the reference's whole-blob ubjson+zstd
    rewrite; "frames" = append one frame to <base>-yields.ubjf (O(N) per
    save); "both" = frame + blob (used for a run's FINAL save in frames
    mode, so completed runs stay readable by the reference's own
    post-processing)."""
    t0 = time.time()
    state = State(cluster_particles, converter, metadata)
    # atomic write: a crash mid-write (a window the async writer widens)
    # must not leave a torn state file that most_recent_checkpoint would
    # select and load_state could not read — bricking plain resume
    path = state_filename(base, nfile)
    with open(path + ".tmp", "wb") as f:
        f.write(compress(dumps(state)))
    os.replace(path + ".tmp", path)
    if yields_mode == "rewrite" and nfile == 0:
        # cold rewrite-mode run: a stale framed store from a previous
        # frames-mode run under the same base would be PREFERRED by
        # load_checkpoint on resume, poisoning the restored yields with
        # the old run's history (frames-mode cold saves truncate it
        # themselves, yields_store.marinate_frame)
        stale = yields_frames_filename(base)
        if os.path.exists(stale):
            os.remove(stale)
    if yields_mode in ("frames", "both"):
        yields.marinate_frame(yields_frames_filename(base))
    if yields_mode in ("rewrite", "both"):
        # a bounded store (frames runs) rebuilds the blob by streaming the
        # framed file back instead of holding the history in RAM
        yields.marinate(
            yields_filename(base),
            frames_path=(yields_frames_filename(base)
                         if yields_mode == "both" else None),
        )
    if verbose:
        print(
            f"Saving checkpoint #{str(nfile).zfill(5)}... Done! "
            f"Took {time.time() - t0:3f} seconds!"
        )


def load_state(path: str) -> State:
    """Load one state file — the port's, the JAX package's or one written
    by the reference (read_state, al26_plot.py:41-50) — into the port's
    classes. Reference files embed AMUSE classes; they unpickle through
    the tolerant stub loader and the cluster table / metadata quantities
    are rebuilt from the AMUSE object graph
    (compat.particles_from_amuse_stub)."""
    with open(path, "rb") as f:
        return loads(decompress(f.read()))


def load_checkpoint(base: str, nfile: int):
    """Load state + yields (al26_nbody.py:403-439).
    Returns (cluster_particles, converter, yields, metadata).

    Prefers the appendable framed yields file when the run that wrote the
    checkpoint used frames mode (it is written at EVERY save there, while
    the reference-format blob only lands at the final save). The
    preference is gated on the CHECKPOINT's own yields_frames arg: a
    stale .ubjf from an earlier frames-mode run under the same base must
    not poison a rewrite-mode run's resume. Reference-written runs have
    neither the flag nor the file — they load the blob."""
    state = load_state(state_filename(base, nfile))
    yields = Yields(base)
    frames_path = yields_frames_filename(base)
    wants_frames = bool(getattr(state.metadata.args, "yields_frames", True))
    if wants_frames and os.path.exists(frames_path):
        yields.plate_frames(frames_path)
    else:
        yields.plate(yields_filename(base))
    return state.cluster, state.converter, yields, state.metadata
