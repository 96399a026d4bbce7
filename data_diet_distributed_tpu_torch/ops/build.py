"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Each source compiles on first use into its own shared library with a plain C
interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

One ``nvcc`` per source, all started together, so a cold build costs the
slowest source, not the sum. Libraries go under ``ops/_build/<hash>/`` (listed
in ``.gitignore``), keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. ``ptxas``'s report (registers,
shared memory, spills per kernel) is kept beside each library as
``<name>.log``. A missing ``nvcc`` or a failed build raises: nothing falls
back to another route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

#: Kernel name -> its source file under ``csrc/``.
SOURCES = {
    "conv_grad_norm_direct": "conv_grad_norm_direct.cu",
    "conv_grad_norm_gram": "conv_grad_norm_gram.cu",
    "el2n": "el2n.cu",
    "grand_last_layer": "grand_last_layer.cu",
    "bn_grad_norm": "bn_grad_norm.cu",
    "conv_grad_norm_catdot": "conv_grad_norm_catdot.cu",
    "conv_bwd_grad_norm": "conv_bwd_grad_norm.cu",
}
#: Headers the sources include (``#include "..."``, resolved beside the source).
HEADERS = ("common.cuh", "conv_norm_common.cuh", "conv_norm_mma.cuh")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else
    ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built")


def build_dir() -> str:
    """``ops/_build/<hash>``: the hash covers every source, header and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES.values()) + sorted(HEADERS):
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16])


def library_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}.so")


def build_all() -> str:
    """Compile every source whose library is missing, all ``nvcc`` processes
    at once; returns the build directory. Raises with the compiler's output
    on the first failure."""
    out_dir = build_dir()
    todo = [n for n in sorted(SOURCES) if not os.path.exists(library_path(n))]
    if not todo:
        return out_dir
    nvcc = nvcc_path()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = os.path.join(out_dir, f"lib{name}.so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(out_dir, f"{name}.log"), "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            failures.append(f"--- {SOURCES[name]} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building every kernel first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name not in SOURCES:
                raise KeyError(f"unknown kernel {name!r}; known: {sorted(SOURCES)}")
            build_all()
            lib = ctypes.CDLL(library_path(name))
            lib.ddt_error_string.argtypes = [ctypes.c_int]
            lib.ddt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """``nvcc``/``ptxas`` output of the last build of kernel ``name``."""
    path = os.path.join(build_dir(), f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()
