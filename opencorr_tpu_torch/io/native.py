"""ctypes bridge to the native table codec (``native/opencorr_native.cpp``
at the repository root).

At first use the library is built with ``g++ -O3 -shared -fPIC -std=c++17``
from that source into ``opencorr_tpu_torch/_build/``, under a file name
keyed on a hash of the source.  Where the source or a compiler is missing,
or the build fails, every caller falls back to the Python path: this is
host I/O, and the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "opencorr_native.cpp"
BUILD_DIR = _PKG / "_build"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libopencorr_native-{digest}.so"


def _build(so: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o",
                        str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if tmp.exists():
            tmp.unlink()
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not SOURCE.exists():
        return None
    so = lib_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.oc_write_table.restype = ctypes.c_int
    lib.oc_write_table.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, f32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char]
    lib.oc_read_table.restype = ctypes.c_int64
    lib.oc_read_table.argtypes = [
        ctypes.c_char_p, ctypes.c_int, f32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char, ctypes.POINTER(ctypes.c_int64)]
    lib.oc_write_volume_bin.restype = ctypes.c_int
    lib.oc_write_volume_bin.argtypes = [
        ctypes.c_char_p, f32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library is loaded (built first if needed)."""
    return _load() is not None


def write_table(path: str, header: str, data: np.ndarray,
                delimiter: str = ",") -> bool:
    """Write ``header`` and the rows of ``data`` [N, C] as fixed
    8-decimal cells, each followed by ``delimiter``.  False when the
    library is missing or the write failed."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(data, np.float32)
    rc = lib.oc_write_table(path.encode(), header.encode(), arr,
                            arr.shape[0], arr.shape[1], delimiter.encode())
    return rc == 0


def read_table(path: str, skip_header: bool = True, max_cols: int = 64,
               delimiter: str = ",") -> Optional[np.ndarray]:
    """A numeric table as float32 [rows, columns of the first row], or
    None when the library is missing or the file cannot be read."""
    lib = _load()
    if lib is None:
        return None
    try:
        max_rows = 1  # an exact bound: one row a newline
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                max_rows += chunk.count(b"\n")
        out = np.zeros((max_rows, max_cols), np.float32)
        ncols = ctypes.c_int64(0)
        rows = lib.oc_read_table(path.encode(), int(skip_header), out,
                                 max_rows, max_cols, delimiter.encode(),
                                 ctypes.byref(ncols))
    except (OSError, MemoryError):
        return None
    if rows < 0 or ncols.value <= 0:
        return None
    return out[:rows, :ncols.value].copy()

