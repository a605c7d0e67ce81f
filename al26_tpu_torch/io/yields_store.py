"""Yields time-series store (the port's copy of al26_tpu/io/yields_store.py,
the same files byte for byte where zstandard is present).

Port of the reference `Yields` class (al26_nbody.py:125-279): append-only
per-checkpoint snapshots of every star's SLR reservoirs plus cluster-wide
sums, serialised as zstd-compressed UBJSON (`marinate`/`plate`), and an
append-only CSV of the global sums. Attribute names, file layout and the
CSV header are identical to the reference so its post-processing pipeline
(plotting/postprocess.py, plot_slr_statistics.py) consumes our files
unchanged.
Round-2 extra: an APPENDABLE framed variant (`marinate_frame` /
`plate_frames`, file `<base>-yields.ubjf`). The reference rewrites the
whole blob at every save (al26_nbody.py:242-264) — O(k) data per save,
O(k^2) over a run; the framed file appends one zstd frame per snapshot
(O(N) per save) and is crash-tolerant (a torn trailing frame is ignored
on read). The reference-format blob is still written at the end of a run
so the reference's own post-processing keeps working on completed runs.
"""
from __future__ import annotations

import os

import numpy as np

from ..state import ISO_NAMES
from . import ubjson
from .compression import compress, compress_stream, decompress

_FRAMES_MAGIC = b"AL26YF01"
_FRAME_TAG = b"FRME"

# time-series attributes: per-star snapshot lists (al26_nbody.py:134-155)
_SERIES = [
    f"{ch}_{iso}" for iso in ISO_NAMES
    for ch in ("local", "global", "sne", "agb", "agb_raw")
]
_SUMS = [
    f"sum_{ch}_{iso}" for iso in ISO_NAMES
    for ch in ("local", "global", "sne", "agb")
]
_FINALS = [
    f"{ch}_{iso}_final" for iso in ISO_NAMES
    for ch in ("local", "global", "sne", "agb")
]


def _iter_frames(filename: str, with_offsets: bool = False):
    """Yield decoded frame dicts from a framed yields file (optionally as
    (byte_offset, frame) pairs), reading ONE frame at a time — the file is
    never held in memory (it reaches ~200 MB at the flagship N=102400).
    A torn trailing frame — crash mid-append — is dropped; anything else
    malformed raises."""
    size = os.path.getsize(filename)
    with open(filename, "rb") as f:
        if f.read(8) != _FRAMES_MAGIC:
            raise IOError(f"{filename}: not an al26 framed yields file")
        off = 8
        while off < size:
            head = f.read(12)
            if len(head) < 12 or head[:4] != _FRAME_TAG:
                if off + 12 >= size:
                    break  # torn header at EOF
                raise IOError(f"{filename}: corrupt frame header @ {off}")
            ln = int.from_bytes(head[4:12], "little")
            if off + 12 + ln > size:
                break  # torn payload at EOF: keep the complete prefix
            frame = ubjson.loadb(decompress(f.read(ln)))
            yield (off, off + 12 + ln, frame) if with_offsets else frame
            off += 12 + ln


class Yields:
    def __init__(self, filename: str, bounded: bool = False) -> None:
        self.filename = filename
        self.time: list = []
        for name in _SERIES:
            setattr(self, name, [])
        for name in _SUMS:
            setattr(self, name, [])
        for name in _FINALS:
            setattr(self, name, [])
        self.first_write = True
        # bounded mode (frames runs): retain only the LATEST per-star
        # snapshot in host RAM — the full history lives in the framed file
        # and the reference blob is reconstructed by streaming it back
        # (_marinate_streamed). The reference instead keeps every snapshot
        # as boxed-float lists and documents the unbounded growth as a
        # known crash mode (al26_nbody.py:169-176); at N=102400 x 102
        # saves that is tens of GB of host RAM.
        self._bounded = bounded
        self._frame_offsets: list | None = None
        self._frames_end: int | None = None

    # -- state update (al26_nbody.py:169-220) ------------------------------
    def update_state(self, model_time_myr: float, particles) -> None:
        """Append a snapshot. `particles` is an io.compat.Particles
        table (or anything exposing the reference's mass_* attributes with
        .value_in)."""
        from ..units import msol

        self.time.append(float(model_time_myr))
        for iso in ISO_NAMES:
            for ch in ("local", "global", "sne", "agb", "agb_raw"):
                vals = getattr(particles, f"mass_{iso}_{ch}").value_in(msol)
                if self._bounded:
                    # numpy snapshot: encodes to the IDENTICAL UBJSON
                    # typed-array wire bytes as a float list, without
                    # boxing N floats per series per save (~50x faster at
                    # N=1e5; the unbounded store keeps the reference's
                    # list-of-floats attribute layout)
                    snap = np.asarray(vals, np.float64)
                else:
                    snap = list(map(float, vals))
                getattr(self, f"{ch}_{iso}").append(snap)
                if ch != "agb_raw":
                    getattr(self, f"sum_{ch}_{iso}").append(float(np.sum(vals)))
                    fin = getattr(
                        particles, f"mass_{iso}_{ch}_final"
                    ).value_in(msol)
                    setattr(
                        self, f"{ch}_{iso}_final",
                        np.asarray(fin, np.float64) if self._bounded
                        else list(map(float, fin)),
                    )
        if self.first_write:
            self.write_csv_header()
            self.first_write = False
        self.write_to_csv()
        if self._bounded:
            # keep only the latest per-star snapshot (marinate_frame reads
            # [-1]); time and the scalar sums stay whole — they are O(saves)
            for name in _SERIES:
                lst = getattr(self, name)
                if len(lst) > 1:
                    del lst[:-1]

    # -- CSV (al26_nbody.py:221-241) -------------------------------
    def write_csv_header(self) -> None:
        with open(f"{self.filename}-cluster-yields.csv", "w") as f:
            f.write("time,local_26al,global_26al,sne_26al,"
                    "local_60fe,global_60fe,sne_60fe\n")

    def write_to_csv(self) -> None:
        with open(f"{self.filename}-cluster-yields.csv", "a") as f:
            f.write(
                "{:.6e},{:.6e},{:.6e},{:.6e},{:.6e},{:.6e},{:.6e}\n".format(
                    self.time[-1],
                    self.sum_local_26al[-1],
                    self.sum_global_26al[-1],
                    self.sum_sne_26al[-1],
                    self.sum_local_60fe[-1],
                    self.sum_global_60fe[-1],
                    self.sum_sne_60fe[-1],
                )
            )

    # -- serialisation (al26_nbody.py:242-279) ----------------------------
    def marinate(self, filename: str, frames_path: str | None = None) -> None:
        """Serialise all attributes to zstd-compressed UBJSON.

        A bounded store no longer holds the per-star history, so the blob
        is reconstructed by streaming the framed file back
        (`frames_path` required; O(N) peak memory)."""
        if self._bounded:
            if frames_path is None:
                raise ValueError(
                    "bounded yields store: marinate needs frames_path to "
                    "rebuild the reference blob from the framed file"
                )
            self._marinate_streamed(filename, frames_path)
            return
        marinade = {k: v for k, v in self.__dict__.items()
                    if not k.startswith("_")}
        # atomic: rewrite mode replaces the whole blob every save — a
        # crash mid-write must not leave a torn blob that bricks resume
        with open(filename + ".tmp", "wb") as f:
            f.write(compress(ubjson.dumpb(marinade)))
        os.replace(filename + ".tmp", filename)

    def _marinate_streamed(self, filename: str, frames_path: str,
                           level: int = 8) -> None:
        """Write the reference-format blob without materialising the run
        history: ONE pass over the framed file decodes each frame once and
        spools every series' per-save encodings to its own temp file
        (UBJSON containers are compositional, ubjson.encode_key); the
        spools are then concatenated into the uncompressed object stream
        and zstd-compressed file-to-file with the content size recorded in
        the frame header (compression.compress_stream), so the reference's
        one-shot decompress (al26_nbody.py:335-345) still reads it. O(N) peak memory; decodes
        identically to the unbounded in-memory marinate (tests/test_io)."""
        import shutil

        tmp = filename + ".tmp-ubj"
        spools = {name: filename + f".tmp-{name}" for name in _SERIES}
        try:
            handles = {n: open(p, "wb") for n, p in spools.items()}
            try:
                for fr in _iter_frames(frames_path):
                    for name in _SERIES:
                        handles[name].write(ubjson.dumpb(fr[name]))
            finally:
                for h in handles.values():
                    h.close()
            with open(tmp, "wb") as out:
                out.write(b"{")

                def put(key, value):
                    out.write(ubjson.encode_key(key))
                    out.write(ubjson.dumpb(value))

                put("filename", self.filename)
                put("time", self.time)
                for name in _SERIES:
                    out.write(ubjson.encode_key(name))
                    out.write(b"[")
                    with open(spools[name], "rb") as sp:
                        shutil.copyfileobj(sp, out)
                    out.write(b"]")
                for name in _SUMS:
                    put(name, getattr(self, name))
                for name in _FINALS:
                    put(name, getattr(self, name))
                put("first_write", self.first_write)
                out.write(b"}")
            with open(tmp, "rb") as ifh, open(filename + ".tmp-z", "wb") as ofh:
                compress_stream(ifh, ofh, os.path.getsize(tmp), level)
            os.replace(filename + ".tmp-z", filename)  # atomic publish
        finally:
            for p in spools.values():
                if os.path.exists(p):
                    os.remove(p)
            for leftover in (tmp, filename + ".tmp-z"):
                if os.path.exists(leftover):
                    os.remove(leftover)

    def plate(self, filename: str) -> None:
        """Restore attributes from a marinated file (also reads files
        written by the reference's py-ubjson). The store's IDENTITY —
        `filename`, the base path future CSV/blob writes go to — is NOT
        restored: the blob records the base as of save time (possibly
        relative to a different cwd), and restoring it would redirect a
        path-qualified resume's writes into the wrong directory
        (plate_frames never restored it either)."""
        with open(filename, "rb") as f:
            preserve = ubjson.loadb(decompress(f.read()))
        for attr in self.__dict__:
            if attr in preserve and attr != "filename":
                self.__dict__[attr] = preserve[attr]

    # -- appendable framed format (round-2 extra; module docstring) --------
    def marinate_frame(self, filename: str) -> None:
        """Append the LATEST snapshot as one zstd frame: the last element
        of every time-series list plus the current *_final snapshots
        (finals are whole-cluster overwrites per save, so the last frame
        always carries the current ones)."""
        frame: dict = {"time": self.time[-1]}
        for name in _SERIES:
            frame[name] = getattr(self, name)[-1]
        for name in _SUMS:
            frame[name] = getattr(self, name)[-1]
        for name in _FINALS:
            frame[name] = getattr(self, name)
        payload = compress(ubjson.dumpb(frame))
        # a COLD run (exactly one snapshot in the store) truncates any
        # stale framed file from a previous run under the same base name —
        # the reference workflow overwrites state/CSV/blob in place, and
        # 'ab' would silently prepend the old run's time series (resumed
        # runs restore the full history first, so len(time) > 1 there)
        fresh = len(self.time) <= 1 or not os.path.exists(filename)
        with open(filename, "wb" if fresh else "ab") as f:
            if fresh:
                f.write(_FRAMES_MAGIC)
            f.write(_FRAME_TAG + len(payload).to_bytes(8, "little"))
            f.write(payload)

    def plate_frames(self, filename: str) -> None:
        """Restore the store from a framed file. A torn trailing frame
        (crash mid-append) is dropped; anything else malformed raises.
        Records each frame's byte offset so a resume from an earlier
        checkpoint can truncate stale future frames (truncate_frames)."""
        self.time = []
        for name in _SERIES + _SUMS:
            setattr(self, name, [])
        frames_tail = None
        self._frame_offsets = []
        self._frames_end = len(_FRAMES_MAGIC)
        for off, end, fr in _iter_frames(filename, with_offsets=True):
            self._frame_offsets.append(off)
            self._frames_end = end
            self.time.append(fr["time"])
            for name in _SERIES + _SUMS:
                getattr(self, name).append(fr[name])
            frames_tail = fr
        if frames_tail is not None:
            for name in _FINALS:
                setattr(self, name, frames_tail[name])
        self.first_write = frames_tail is None

    def bound(self) -> None:
        """Switch an (already loaded) store to bounded mode: the per-star
        history is dropped from RAM — safe only when the framed file holds
        the full history (driver resume path)."""
        self._bounded = True
        for name in _SERIES:
            lst = getattr(self, name)
            if len(lst) > 1:
                del lst[:-1]

    def truncate_memory(self, t_max: float) -> int:
        """Drop snapshots with time > t_max from the STORE only; returns
        the number kept. Finals are left as restored — used on blob-only
        resumes, where the blob carries only the final snapshot's finals
        (reference layout, al26_nbody.py:134-155), so there is nothing to
        roll them back to (the reference has the same wart)."""
        eps = 1e-9 * max(1.0, abs(t_max))
        k = sum(1 for t in self.time if t <= t_max + eps)
        if k < len(self.time):
            self.time = self.time[:k]
            for name in _SERIES + _SUMS:
                setattr(self, name, getattr(self, name)[:k])
            self.first_write = k == 0
        return k

    def truncate_csv(self, t_max: float) -> None:
        """Drop CSV rows with time > t_max. A resume from an earlier
        checkpoint re-appends the re-simulated rows; without this the
        append-only CSV (al26_nbody.py:221-241) keeps the stale tail and
        its time column goes non-monotonic — the same defect the framed
        file and blob paths truncate away (the reference itself leaves
        the duplicated tail; truncating is a strict improvement since
        its post-processing reads the blob, not the CSV)."""
        path = f"{self.filename}-cluster-yields.csv"
        if not os.path.exists(path):
            return
        # the CSV time column is written at %.6e (7 significant digits,
        # write_to_csv) — the tolerance must cover that quantisation
        # (~5e-7 relative; an f32 checkpoint time like 9.99499988...
        # rounds UP to 9.995000e+00) or the boundary row at the resume
        # time itself gets dropped. Stale rows sit >= one dt (~0.01 Myr)
        # above t_max, far outside this epsilon.
        eps = 1e-6 * max(1.0, abs(t_max))
        with open(path) as f:
            lines = f.readlines()
        keep = lines[:1]  # header
        for ln in lines[1:]:
            try:
                t = float(ln.split(",", 1)[0])
            except ValueError:
                keep.append(ln)
                continue
            if t <= t_max + eps:
                keep.append(ln)
        if len(keep) != len(lines):
            with open(path, "w") as f:
                f.writelines(keep)

    def truncate_frames(self, filename: str, t_max: float) -> None:
        """Drop snapshots with time > t_max from BOTH the store and the
        framed file, and ALWAYS truncate the file to the end of the last
        kept frame. A resume from an earlier checkpoint (-nc K) must not
        leave the later saves' frames in the file (the run re-simulates
        from K and appends fresh frames — a stale tail would make the
        series non-monotonic), and a resume after a crash mid-append must
        not leave the torn trailing fragment (appending after garbage
        bytes would corrupt every later read). The reference's whole-blob
        rewrite self-heals both cases only because it discards the file
        each save. Requires a plate_frames-loaded store (byte offsets)."""
        if self._frame_offsets is None:
            raise ValueError("truncate_frames needs a plate_frames-loaded store")
        n_frames = len(self._frame_offsets)
        k = self.truncate_memory(t_max)
        if 0 < k < n_frames:
            # finals roll back to the last kept frame's: seek straight to
            # it (the offsets are this method's precondition) instead of
            # decoding every earlier frame
            start = self._frame_offsets[k - 1]
            with open(filename, "rb") as f:
                f.seek(start)
                head = f.read(12)
                ln = int.from_bytes(head[4:12], "little")
                fr = ubjson.loadb(decompress(f.read(ln)))
            for name in _FINALS:
                setattr(self, name, fr[name])
        if k == 0:
            end = len(_FRAMES_MAGIC)
        elif k < n_frames:
            end = self._frame_offsets[k]
        else:
            end = self._frames_end  # keep all frames, drop any torn tail
        if os.path.getsize(filename) > end:
            with open(filename, "r+b") as f:
                f.truncate(end)
        self._frame_offsets = self._frame_offsets[:k]
        self._frames_end = end

    def backfill_frames(self, filename: str) -> None:
        """Write every in-memory snapshot as a frame (oldest first),
        truncating the file. Used when resuming a run that only has the
        reference-format blob (e.g. written by the reference itself): the
        framed file is seeded with the restored history so bounded mode
        and the final streamed blob see the complete series. Finals are
        whole-cluster overwrites (only the LAST frame's are ever read), so
        each backfilled frame carries the current ones."""
        with open(filename, "wb") as f:
            f.write(_FRAMES_MAGIC)
            for i in range(len(self.time)):
                frame: dict = {"time": self.time[i]}
                for name in _SERIES:
                    frame[name] = getattr(self, name)[i]
                for name in _SUMS:
                    frame[name] = getattr(self, name)[i]
                for name in _FINALS:
                    frame[name] = getattr(self, name)
                payload = compress(ubjson.dumpb(frame))
                f.write(_FRAME_TAG + len(payload).to_bytes(8, "little"))
                f.write(payload)

    def as_arrays(self) -> "Yields":
        """Convert list attributes to numpy arrays in place
        (read_yields behaviour, al26_plot.py:52-64)."""
        for attr, value in self.__dict__.items():
            if isinstance(value, list):
                self.__dict__[attr] = np.asarray(value)
        return self
