"""Build and bind the Hopper kernels of ``multiyolov5_tpu_torch/csrc``.

Each ``csrc/*.cu`` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes.  The build runs at the first kernel
launch of a process, into ``build/kernels/`` at the repository root, under
a name that carries a hash of the sources and flags, so an edited source is
never served by a stale library.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()


class _Library:
    """The process's loaded kernel library (built on first use)."""

    def __init__(self):
        self.cdll: Optional[ctypes.CDLL] = None
        self.build_log = ""
        self.path: Optional[Path] = None


_LIB = _Library()


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


def library() -> ctypes.CDLL:
    """The kernel library, built from the sources if this process has not
    loaded it yet."""
    with _LOCK:
        if _LIB.cdll is not None:
            return _LIB.cdll
        srcs, deps = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in srcs + deps:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        path = BUILD_DIR / f"libmultiyolov5_kernels_{h.hexdigest()[:16]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _LIB.build_log = _compile(srcs, path)
        _LIB.cdll = ctypes.CDLL(str(path))
        _LIB.path = path
        return _LIB.cdll


def _compile(srcs, path: Path) -> str:
    """nvcc each source to an object in parallel, then link ``path``;
    returns nvcc's output (the ptxas report), raises on a failure."""
    tag = f"{os.getpid()}.tmp"
    objs = [path.with_name(f"{path.stem}.{p.stem}.{tag}.o") for p in srcs]
    procs = [(subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
              p) for p, o in zip(srcs, objs)]
    log, failed = [], []
    for proc, src in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = path.with_suffix(f".{tag}")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "".join(log))
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(log)


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
