"""Host batch assembly through the repo's native engine (the port's copy of
``data_diet_distributed_tpu/data/native.py``).

``native/datadiet_native.cpp`` is built with ``g++`` on first use into
``_build/`` beside this file (ignored by git) and loaded with ``ctypes``;
``DATADIET_NO_NATIVE=1`` turns it off, and without ``g++`` the NumPy versions
below run instead. Both give the same bytes: the NumPy gather repeats the C++
arithmetic, ``(x · (1/255) − mean) · (1/std)`` in float32 with ``1/std``
computed on the host, where ``ArrayDataset.dense`` divides as the JAX
package's ``dense`` does (the two can differ in the last ulp).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native",
                    "datadiet_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libdatadiet_native.so")
#: The JAX package's flags, and no contraction of ``x * a - b`` into an FMA on
#: targets that have one, so the NumPy version stays bitwise the library's.
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-ffp-contract=off")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

_INV_255 = np.float32(1.0) / np.float32(255.0)   # the C++ constant 1.0f / 255.0f


def _build() -> bool:
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Built under a name of its own and renamed: processes that build at once
    # never load a half-written library.
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXXFLAGS, src, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def load() -> ctypes.CDLL | None:
    """The native library (built on first use), or None when it is off or
    cannot be built or loaded."""
    global _lib, _tried
    if os.environ.get("DATADIET_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(LIB_PATH)
            lib.dd_abi_version.restype = ctypes.c_int32
            if lib.dd_abi_version() != 1:
                return None
            lib.dd_gather_f32.restype = None
            lib.dd_gather_f32.argtypes = [
                _f32p, ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int64, _f32p]
            lib.dd_gather_i32.restype = None
            lib.dd_gather_i32.argtypes = [
                _i32p, _i64p, ctypes.c_int64, ctypes.c_int64, _i32p]
            lib.dd_gather_normalize_u8.restype = None
            lib.dd_gather_normalize_u8.argtypes = [
                _u8p, ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int64,
                _f32p, _f32p, ctypes.c_int64, _f32p]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def _pad_rows(take: np.ndarray, batch_size: int) -> np.ndarray:
    """``take`` padded with row 0 up to ``batch_size`` rows."""
    pad = batch_size - len(take)
    return np.concatenate([take, np.zeros(pad, np.int64)]) if pad else take


def _inv_std(std: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(1.0 / np.asarray(std, np.float32), np.float32)


def normalize_u8_numpy(images_u8: np.ndarray, take: np.ndarray, mean: np.ndarray,
                       std: np.ndarray, batch_size: int) -> np.ndarray:
    """``dd_gather_normalize_u8`` in NumPy, bitwise: rows ``take`` padded with
    row 0, ``(x · (1/255) − mean) · (1/std)`` in float32."""
    x = np.asarray(images_u8[_pad_rows(take, batch_size)]).astype(np.float32)
    return ((x * _INV_255 - np.asarray(mean, np.float32)) * _inv_std(std)).astype(
        np.float32, copy=False)


def gather_normalize_u8(images_u8: np.ndarray, take: np.ndarray, mean: np.ndarray,
                        std: np.ndarray, batch_size: int) -> np.ndarray | None:
    """Fused gather and uint8 -> normalized float32 in the native engine; None
    when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    row_shape = images_u8.shape[1:]
    out = np.empty((batch_size, *row_shape), np.float32)
    lib.dd_gather_normalize_u8(
        np.ascontiguousarray(images_u8), int(np.prod(row_shape)),
        np.ascontiguousarray(take, np.int64), len(take), batch_size,
        np.ascontiguousarray(mean, np.float32), _inv_std(std),
        images_u8.shape[-1], out)
    return out


class BatchAssembler:
    """Gather-and-pad batch assembly: ``assemble(images, labels, indices, take,
    batch_size, norm)`` returns ``(image, label, index, mask)`` for the rows
    ``take`` padded to ``batch_size`` (tail rows: row 0's image, label and
    index 0, mask 0), normalizing a lazy dataset's rows on the way. A fresh
    image buffer each call: the caller may still be reading the last one."""

    def assemble_images(self, images: np.ndarray, take: np.ndarray, batch_size: int,
                        norm: tuple[np.ndarray, np.ndarray] | None = None) -> np.ndarray:
        if norm is not None:
            mean, std = norm
            if images.dtype == np.uint8:
                if not isinstance(images, np.ndarray):
                    # Shard-backed images: gather the batch's rows through the
                    # bounded shard cache first (handing the object to the
                    # native engine would materialize all of it), then
                    # normalize them with an identity take, so the sharded
                    # plane gives the npz and mmap planes' bytes.
                    images = np.ascontiguousarray(images[_pad_rows(take, batch_size)])
                    take = np.arange(batch_size, dtype=np.int64)
                image = gather_normalize_u8(images, take, mean, std, batch_size)
                if image is None:
                    image = normalize_u8_numpy(images, take, mean, std, batch_size)
                return image
            if images.dtype == np.float32:
                return ((np.asarray(images[_pad_rows(take, batch_size)], np.float32)
                         - mean) / std)
            raise ValueError(
                f"lazy normalization expects uint8/float32 images, got {images.dtype}")
        lib = load()
        if (lib is not None and images.dtype == np.float32
                and isinstance(images, np.ndarray)):
            row_shape = images.shape[1:]
            out = np.empty((batch_size, *row_shape), np.float32)
            lib.dd_gather_f32(np.ascontiguousarray(images), int(np.prod(row_shape)),
                              np.ascontiguousarray(take, np.int64), len(take),
                              batch_size, out)
            return out
        return np.asarray(images[_pad_rows(take, batch_size)])

    def assemble(self, images: np.ndarray, labels: np.ndarray, indices: np.ndarray,
                 take: np.ndarray, batch_size: int,
                 norm: tuple[np.ndarray, np.ndarray] | None = None):
        n_take = len(take)
        if n_take > batch_size:
            raise ValueError(f"{n_take} rows exceed the batch geometry B={batch_size}")
        mask = np.zeros(batch_size, np.float32)
        mask[:n_take] = 1.0
        image = self.assemble_images(images, take, batch_size, norm)
        lib = load()
        if lib is not None:
            rows = np.ascontiguousarray(take, np.int64)
            label = np.empty(batch_size, np.int32)
            index = np.empty(batch_size, np.int32)
            lib.dd_gather_i32(np.ascontiguousarray(labels, np.int32), rows, n_take,
                              batch_size, label)
            lib.dd_gather_i32(np.ascontiguousarray(indices, np.int32), rows, n_take,
                              batch_size, index)
        else:
            rows_padded = _pad_rows(take, batch_size)
            label = np.asarray(labels[rows_padded], np.int32).copy()
            index = np.asarray(indices[rows_padded], np.int32).copy()
            label[n_take:] = 0
            index[n_take:] = 0
        return image, label, index, mask
