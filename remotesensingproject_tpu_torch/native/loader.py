"""ctypes binding of the native stack loader (``loader.cpp``).

Counterpart of ``remotesensingproject_tpu/native/loader.py``.  The
library is built at first use with the flags of the JAX package's
Makefile (``g++ -O2 -std=c++17 -fPIC -Wall -shared ... -lpng -ljpeg -lz
-lpthread``) into ``build/native/`` beside the package (listed in
``.gitignore``); its file name carries a hash of the source and the
command, so an edited source is rebuilt and an unchanged one is not.  A
failed build raises with the compiler's output.  Nothing is built or
loaded when this module is imported.

The C side decodes into float32 and reports the source dtype, which
:func:`read_stack` restores: the reference's normalization depends on it
(u8 / 255 against float / global max, rslf_depth_computation.hpp:269-289).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "native"
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]
LDLIBS = ["-lpng", "-ljpeg", "-lz", "-lpthread"]
_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.float32}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native loader is built with "
                           "a C++17 compiler, libpng and libjpeg")
    return cxx


def library_path() -> Path:
    """Where the built library lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDLIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librslf_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library if it is not built yet; returns its path.  Raises
    RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXXFLAGS, "-o", str(tmp), str(SOURCE), *LDLIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native loader failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.rslf_read_stack
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_char_p,                  # folder
                ctypes.POINTER(ctypes.c_char_p),  # names
                ctypes.c_int,                     # count
                ctypes.c_char_p,                  # extension
                ctypes.c_void_p,                  # out buffer (float32)
                ctypes.POINTER(ctypes.c_int),     # dims [H, W, C, dtype]
                ctypes.c_int,                     # probe_only
            ]
            _lib = lib
        return _lib


def read_stack(folder: str, names: List[str],
               extension: str) -> Optional[np.ndarray]:
    """Read the frames ``folder/<name>.<extension>`` as one stack ``[S, H,
    W, C]`` in the source dtype (uint8, uint16 or float32).

    Returns None when the decoder cannot read them (an unsupported format,
    a corrupt file, or frames of different shapes); raises when the
    library cannot be built or loaded."""
    lib = load()
    if not names:
        return None
    cnames = (ctypes.c_char_p * len(names))(*[n.encode() for n in names])
    dims = (ctypes.c_int * 4)()
    args = (os.fsencode(folder), cnames, len(names), extension.encode())
    if lib.rslf_read_stack(*args, None, dims, 1) != 0:
        return None
    H, W, C, code = dims[0], dims[1], dims[2], dims[3]
    out = np.empty((len(names), H, W, C), np.float32)
    if lib.rslf_read_stack(*args, out.ctypes.data_as(ctypes.c_void_p), dims,
                           0) != 0:
        return None
    dt = _DTYPES.get(code, np.float32)
    return out if dt is np.float32 else out.astype(dt)
