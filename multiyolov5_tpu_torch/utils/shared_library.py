"""Build a shared library at its first use and load it once a process.

The port's two native libraries share this rule: the Hopper kernels
(``ops/kernels/build.py``, nvcc into ``build/kernels/``) and the host JPEG
codec (``data/jpeg.py``, g++ into ``build/host/``).  No torch here, so the
numpy-only data modules can use it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from pathlib import Path
from typing import Callable, Optional


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
