"""Build the port's native UBJSON codec (io/native/ubjson_native.cpp) at
first use.

The source is compiled by the host's C++ compiler (`c++`, else `g++`;
`-O3 -std=c++17 -shared -fPIC`) against this interpreter's headers
(`sysconfig.get_paths()["include"]`) into `al26_tpu_torch/_build/`
(gitignored), as `_ubjson_native_torch_<hash><EXT_SUFFIX>`: the hash covers
the source, the flags, the compiler and the include directory, so an edited
source rebuilds and an unchanged one is reused. The library is written
under a temporary name and renamed into place, so processes that build at
once (test workers, mesh ranks) never load a partial file. It is loaded by
path under its own module name (`_ubjson_native_torch`), never by a bare
import, so it cannot be confused with the JAX package's `_ubjson_native`
in the same process.

`unavailable()` says why no build can be made here (no compiler, no
`Python.h`); io.ubjson then uses its Python codec. A compiler that is
present and fails raises RuntimeError: nothing falls back.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "io", "native", "ubjson_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
MODULE = "_ubjson_native_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def compiler() -> str | None:
    """The host C++ compiler, or None."""
    return shutil.which("c++") or shutil.which("g++")


def python_include() -> str:
    return sysconfig.get_paths()["include"]


def unavailable() -> str | None:
    """Why the codec cannot be built here, or None when it can."""
    if compiler() is None:
        return "no C++ compiler (neither c++ nor g++ is on PATH)"
    header = os.path.join(python_include(), "Python.h")
    if not os.path.exists(header):
        return f"no Python.h at {header}"
    return None


def library_path() -> str:
    """Where the build of the current source lives (it may not yet)."""
    h = hashlib.sha256()
    for part in (*CXX_FLAGS, compiler() or "", python_include()):
        h.update(part.encode() + b"\0")
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, f"{MODULE}_{h.hexdigest()[:16]}{suffix}")


def build() -> str:
    """Compile the source if its library does not exist yet; returns the
    library's path. Raises RuntimeError if it cannot be built."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    why = unavailable()
    if why is not None:
        raise RuntimeError(f"cannot build {MODULE}: {why}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    cmd = [compiler(), *CXX_FLAGS, f"-I{python_include()}", "-o", tmp,
           SOURCE]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {MODULE} failed ({r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):  # a failed build's partial output
            os.remove(tmp)
    return lib


def load():
    """Build (if needed) and load the codec module by path."""
    path = build()
    spec = importlib.util.spec_from_file_location(MODULE, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
