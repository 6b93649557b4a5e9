"""Builds a CUDA source of ``ops/csrc`` at first use and loads it.

A ``csrc/*.cu`` has a plain C interface and compiles with ``nvcc`` for
``sm_90a`` into a shared library under ``neuraltexttospeech_torch/_build/``,
named by a hash of the source and flags, so an edit rebuilds and an
unchanged tree reuses the library. The library is loaded with ``ctypes``;
the wrappers pass ``tensor.data_ptr()`` and PyTorch's current stream. Sources
include no PyTorch header, which keeps a build to seconds.

A failed build raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Dict

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "load"]

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    with _lock:
        if source not in _libs:
            src = CSRC_DIR / source
            digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes())
            lib = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
            if not lib.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                     capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {source} "
                                       f"(exit {out.returncode}):\n{out.stderr}")
                os.replace(tmp, lib)
            _libs[source] = ctypes.CDLL(str(lib))
        return _libs[source]
