"""Build the port's CUDA sources (al26_tpu_torch/csrc/*.cu) at first use.

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface, in `al26_tpu_torch/_build/` (gitignored), named after a
hash of its source and of the shared headers (csrc/*.cuh), so an edited
.cu or header rebuilds and an unchanged one is reused. The kernel modules
bind the libraries with ctypes (ops.cuda_nbody, ops.cuda_tree). A missing
nvcc or a failed build raises; nothing falls back.

`build_all()` starts one nvcc per source at once and waits for all of
them, so a fresh checkout builds in the time of the slowest source; it
returns nvcc's output (the ptxas register and shared-memory lines) beside
each library. Each library is written under a temporary name and renamed
into place, so processes that build at once never load a partial file.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# library stem per source file
LIBS = {"nbody.cu": "al26nbody", "tree.cu": "al26tree"}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of al26_tpu_torch are built from csrc/ at first "
            "use and need the CUDA toolkit"
        )
    return path


def library_path(name: str) -> str:
    """Where the library built from csrc/<name> lives (it may not yet):
    named after a hash of the source and of every csrc/*.cuh header it
    can include, so an edited header rebuilds too."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name, *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read() + b"\0")
    return os.path.join(BUILD_DIR, f"lib{LIBS[name]}_{h.hexdigest()[:16]}.so")


def build_all(names=tuple(LIBS)) -> dict[str, tuple[str, str]]:
    """Compile every named source that has no library yet, one nvcc each,
    all started together; returns {name: (library path, nvcc output)},
    the output empty for a library that already existed."""
    out = {name: (library_path(name), "") for name in names}
    todo = {name: p for name, (p, _) in out.items()
            if not os.path.exists(p)}
    if not todo:
        return out
    exe = nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = f"{lib}.tmp{os.getpid()}"
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"csrc/{name}:\n{log}")
        else:
            os.replace(tmp, todo[name])
            out[name] = (todo[name], log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> str:
    """Compile csrc/<name> if its library does not exist yet; returns the
    library's path."""
    return build_all((name,))[name][0]
