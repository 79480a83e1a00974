"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.  A library is built at first use,
from the sources in the package only, into ``_build/`` under a file name
keyed on a hash of its source and of the ``csrc`` headers it includes, so
an edited kernel is rebuilt and an unchanged one is reused.
:func:`build` compiles several kernels at once, one ``nvcc`` process
each.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output of the builds made by this process (register and shared
# memory use from -Xptxas=-v), by kernel name
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME to the CUDA toolkit)")


def lib_path(name: str) -> Path:
    """The library of kernel ``name``, keyed on its source and the
    ``csrc`` headers it includes."""
    text = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(text)
    for header in re.findall(rb'#include "([^"]+)"', text):
        digest.update((CSRC / header.decode()).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes running at once.  Returns build seconds by name (0 for a
    library that already existed)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    secs = {}
    try:
        for name in names:
            so = lib_path(name)
            if so.exists():
                secs[name] = 0.0
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOGS[name] = out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            os.replace(tmp, so)
            secs[name] = time.perf_counter() - t0
    finally:
        for proc, tmp, _so in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def on_device(device):
    """``torch.cuda.device(device)`` where ``device`` is not the current
    CUDA device, else a context that does nothing."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch(wrapper, call, shape) -> None:
    """Run ``call``, one kernel launch through ctypes that returns a
    cudaError_t code, raise on an error, and count it on ``wrapper``:
    in ``wrapper.launches``, and while ``wrapper.shapes`` is a dict, there
    under ``shape`` (the launch's problem shape, as the wrapper gives it).
    A wrapper with an ``events`` attribute can also be timed a launch:
    while it is a list, the launch is bracketed by two CUDA events
    appended to it with ``shape`` as (start, end, shape).  A pair holds
    the host's launch latency whenever the stream has run dry, so it
    overstates a kernel of a few microseconds; it serves kernels whose
    launches take milliseconds."""
    events = getattr(wrapper, "events", None)
    if events is not None:
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    check(call(), wrapper.__name__)
    if events is not None:
        end.record()
        events.append((start, end, shape))
    if wrapper.shapes is not None:
        wrapper.shapes[shape] = wrapper.shapes.get(shape, 0) + 1
    wrapper.launches += 1
