"""Build and bind the Hopper kernels of ``multiyolov5_tpu_torch/csrc``.

Each ``csrc/*.cu`` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes.  The build runs at the first kernel
launch of a process, into ``build/kernels/`` at the repository root, under
a name that carries a hash of the sources and flags, so an edited source is
never served by a stale library.  A failed build raises with nvcc's output.

The caching rule is ``utils/shared_library.py``'s, which the host JPEG
codec (``data/jpeg.py``, g++ into ``build/host/``) shares.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

from ...utils.shared_library import CachedLibrary

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    deps = sorted(CSRC.glob("*.cuh"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs, deps


def _inputs() -> bytes:
    srcs, deps = _sources()
    return b"".join([" ".join(NVCC_FLAGS).encode()]
                    + [p.name.encode() + p.read_bytes() for p in srcs + deps])


def _compile(out: Path) -> str:
    """nvcc each source to an object in parallel, then link ``out``;
    returns nvcc's output (the ptxas report), raises on a failure."""
    srcs, _ = _sources()
    objs = [out.with_name(f"{out.name}.{p.stem}.o") for p in srcs]
    procs = [(subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
              p) for p, o in zip(srcs, objs)]
    log, failed = [], []
    for proc, src in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "".join(log))
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(out), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(log)


_LIB = CachedLibrary(BUILD_DIR, "libmultiyolov5_kernels", _inputs, _compile)


def library() -> ctypes.CDLL:
    """The kernel library, built from the sources if this process has not
    loaded it yet."""
    return _LIB.load()


def build_info():
    """(library path, nvcc's log of the build this process ran, or "")."""
    return _LIB.path, _LIB.build_log


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared.
    Every entry point returns the launch's ``cudaError_t`` as an int."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = library().mk_cuda_error_string
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {err}: {msg(err).decode()}")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(cond: bool, what: str) -> None:
    """Input validation for a kernel wrapper: raise ValueError, not assert."""
    if not cond:
        raise ValueError(what)


def on_device(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel and no plain path for device {t.device}")
