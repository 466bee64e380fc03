"""Build and load the port's CUDA kernels.

Each ``mxtpu_torch/csrc/<name>.cu`` compiles at first use, with ``nvcc``
alone, into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<digest>.so \\
         csrc/<name>.cu

and is loaded with ``ctypes``.  The sources include no PyTorch header,
so a build takes seconds.  The library's file name carries a digest of
the sources (the ``.cu`` and every ``.cuh`` beside it), so an edited
kernel rebuilds and a stale library is never loaded.  ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them.

Nothing here runs at import: the CPU tests import every module of the
port, and a machine without ``nvcc`` never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..base import MXTPUError

__all__ = ["SOURCES", "build_all", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: kernel sources, one shared library each
SOURCES = ("paged_attention", "prefill_attention", "flash_attention",
           "conv_bwd", "rows_linear", "quantized")

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise MXTPUError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and the PATH): the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return found


def _library(name) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / (name + ".cu")] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / ("%s-%s.so" % (name, h.hexdigest()[:16]))


def build_all(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together.  Returns
    ``{name: {"seconds": s, "log": compiler output}}`` for the sources
    it built (``ptxas`` reports each kernel's registers and shared
    memory in the log); raises on the first failed compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in names:
        lib = _library(name)
        if lib.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = lib.with_suffix(".%d.tmp" % os.getpid())
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, lib, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, lib, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (name, proc.returncode, log))
            continue
        os.replace(tmp, lib)
        built[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise MXTPUError("nvcc failed for " + "\n".join(failed))
    return built


def load(name) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built first if its
    library is missing."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _library(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
