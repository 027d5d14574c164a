"""Build a shared library at its first use and load it once a process.

The port's native libraries share this rule: the Hopper kernels
(``ops/kernels/build.py``, nvcc into ``build/kernels/``) and the host parts
of the image codecs (``data/jpeg.py`` and ``data/host_codecs.py``, g++ into
``build/host/`` through :func:`host_library`).  No torch here, so the
numpy-only data modules can use it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

HOST_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
HOST_CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


class CachedLibrary:
    """A shared library built at its first use in a process and loaded once,
    under a lock.  Its file, ``<build_dir>/<stem>_<hash>.so``, carries a
    hash of ``inputs()`` (the sources and flags); ``compile_to(path)``
    builds it to a temporary name, returning the compiler's log, and the
    file is renamed into place, so processes that build at once share one
    library and an edited source is never served by a stale one.
    ``bind(cdll)`` declares the entry points once after the load."""

    def __init__(self, build_dir: Path, stem: str, inputs: Callable[[], bytes],
                 compile_to: Callable[[Path], str],
                 bind: Optional[Callable[[ctypes.CDLL], None]] = None):
        self.build_dir, self.stem = build_dir, stem
        self.inputs, self.compile_to, self.bind = inputs, compile_to, bind
        self.cdll: Optional[ctypes.CDLL] = None
        self.build_log = ""
        self.path: Optional[Path] = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self.cdll is not None:
                return self.cdll
            tag = hashlib.sha256(self.inputs()).hexdigest()[:16]
            path = self.build_dir / f"{self.stem}_{tag}.so"
            if not path.exists():
                self.build_dir.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
                try:
                    self.build_log = self.compile_to(tmp)
                    os.replace(tmp, path)
                finally:
                    tmp.unlink(missing_ok=True)
            cdll = ctypes.CDLL(str(path))
            if self.bind is not None:
                self.bind(cdll)
            self.cdll, self.path = cdll, path
            return cdll


def host_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on PATH, else
    ``/usr/bin/g++``."""
    for cand in (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("g++ not found (looked at $CXX, on PATH and at /usr/bin/g++)")


def host_library(source: Path, stem: str,
                 bind: Callable[[ctypes.CDLL], None]) -> CachedLibrary:
    """A :class:`CachedLibrary` of one C++ source with a plain C interface,
    built by :func:`host_cxx` into ``build/host/``; a failed build raises
    with the compiler's output."""
    def compile_to(out: Path) -> str:
        cmd = [host_cxx(), *HOST_CXX_FLAGS, "-o", str(out), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        return res.stdout + res.stderr

    return CachedLibrary(HOST_BUILD_DIR, stem,
                         lambda: " ".join(HOST_CXX_FLAGS).encode() + source.read_bytes(),
                         compile_to, bind)
