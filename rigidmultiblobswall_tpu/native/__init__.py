"""Native (C++) host-side components and their ctypes loader.

The reference ships compiled host-side helpers next to its Python code
(e.g. the radial-distribution executable
multi_bodies/examples/Radial_Dist_Test/gr_pseudo2D_single_blob.cpp and
the visit_writer C library).  This package holds this framework's
equivalents as plain C-ABI shared libraries: sources live here, are
compiled on first use with the system toolchain, and are cached by
source hash.  Every native entry point has a pure-numpy fallback in its
Python wrapper, so the framework works (slower) without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_LOADED: dict = {}


def _cache_dir() -> str:
    base = os.environ.get("RMBW_TPU_NATIVE_CACHE")
    if not base:
        xdg = os.environ.get("XDG_CACHE_HOME",
                             os.path.join(os.path.expanduser("~"), ".cache"))
        base = os.path.join(xdg, "rigidmultiblobswall_tpu")
    os.makedirs(base, exist_ok=True)
    return base


def load_library(name: str):
    """Compile `native/<name>.cpp` (if needed) and dlopen it.

    Returns the ctypes.CDLL, or None when no working C++ toolchain is
    available — callers must fall back to their numpy implementation.
    Results (including failure) are memoized per process.
    """
    if name in _LOADED:
        return _LOADED[name]

    src = os.path.join(_SRC_DIR, name + ".cpp")
    try:
        with open(src, "rb") as f:
            code = f.read()
    except OSError:
        _LOADED[name] = None
        return None

    tag = hashlib.sha256(code).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"{name}-{tag}.so")
    if not os.path.exists(out):
        cxx = os.environ.get("CXX", "g++")
        cmd = [cxx, "-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
               "-o", None, src]
        try:
            # build to a temp path then rename: atomic against concurrent
            # compiles from parallel test workers
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_cache_dir())
            os.close(fd)
            cmd[-2] = tmp
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        except (OSError, subprocess.SubprocessError):
            _LOADED[name] = None
            return None

    try:
        _LOADED[name] = ctypes.CDLL(out)
    except OSError:
        _LOADED[name] = None
    return _LOADED[name]
