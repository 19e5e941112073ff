"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, into ``build/kernels/`` beside the package
(listed in ``.gitignore``); the file name carries a hash of the sources
and flags, so an edited kernel is rebuilt and an unchanged one is not.
Nothing is built or loaded when this module is imported.

A wrapper calls a library's C functions through :class:`Entry`, which
declares each one once: every launch passes its tensors as pointers,
appends the current stream, raises on a CUDA error and counts itself in
:data:`launches`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
#: the kernel libraries, one a ``csrc/*.cu``
KERNELS = tuple(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    # keep a*b + c as two roundings, like the plain PyTorch versions
    "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: the bound C functions, by (library, symbol)
_bound: Dict[Tuple[str, str], Any] = {}
#: kernel launches by library since the count was last cleared
launches = collections.Counter()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc")


def _sources(name: str):
    return [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]


def library_path(name: str) -> Path:
    """Where the built library of kernel ``name`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(name):
        h.update(p.read_bytes())
    return BUILD_DIR / f"librslf_{name}-{h.hexdigest()[:16]}.so"


def set_build_dir(path) -> None:
    """Build and load the kernels under ``path`` from now on; the
    libraries loaded so far are dropped, so the next launch of each kernel
    builds it there (``BENCH_NO_CACHE=1`` of the bench)."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = Path(path)
        _libs.clear()
        _bound.clear()


def use_library(name: str, path) -> None:
    """Load kernel ``name`` from the library at ``path`` from now on, in
    place of the one built from ``csrc/`` (designs side by side)."""
    with _lock:
        _libs[name] = ctypes.CDLL(str(path))
        _bound.clear()


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Build the named kernels that are not built yet, one ``nvcc``
    process each, all started together.  Returns seconds per kernel
    built (0.0 for one already built); raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def build_log(name: str) -> Optional[str]:
    """nvcc's output (ptxas register and shared-memory report) of the
    last build of ``name``, if it was built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not library_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


#: cudaErrorInvalidConfiguration: what a sweep launcher returns when no
#: block size of its kernel fits the card's shared memory
_NO_CONFIGURATION = 9
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "s": ctypes.c_void_p}


def check(err: int, name: str, what: str, no_fit: Optional[str] = None):
    """Raise if a call into library ``name`` returned a CUDA error:
    NotImplementedError with ``no_fit`` (the size at fault) where a
    launcher found no block size that fits, RuntimeError with the text of
    the library's ``rslf_<name>_error_string`` otherwise."""
    if err == _NO_CONFIGURATION and no_fit is not None:
        raise NotImplementedError(f"{what}: {no_fit}: one item's samples "
                                  f"exceed a block's shared memory")
    if err != 0:
        fn = getattr(load(name), f"rslf_{name}_error_string")
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} failed with CUDA error {err}: "
                           f"{fn(err).decode()}")


def _stream_handle(device: Optional[torch.device]) -> int:
    """The current stream of ``device`` (None: the current device) as the
    raw ``cudaStream_t`` a launch takes, without building a
    ``torch.cuda.Stream`` a call (a pass makes four launches)."""
    if device is None or device.index is None:
        index = torch.cuda.current_device()
    else:
        index = device.index
    return torch._C._cuda_getCurrentRawStream(index)


class Entry:
    """One C function of kernel library ``lib``, returning a CUDA error
    code.  ``signature`` spells its arguments, spaces aside: ``p`` a
    pointer (a tensor, None for NULL, or a ctypes buffer), ``i`` an int,
    ``f`` a float, and a last ``s`` for the stream of a kernel launch.

    A call binds the function at its first use.  A launch (``s``) takes
    ``device=`` and appends that device's current stream; once it returned
    no error it counts in ``launches[lib]``.  A host query (a launcher's
    plan) takes no stream and counts nothing."""

    def __init__(self, lib: str, symbol: str, signature: str):
        self.lib, self.symbol = lib, symbol
        self.signature = signature.replace(" ", "")
        self.launch = self.signature.endswith("s")
        self._key = (lib, symbol)

    def _bind(self):
        fn = getattr(load(self.lib), self.symbol)
        fn.argtypes = [_CTYPES[c] for c in self.signature]
        fn.restype = ctypes.c_int
        _bound[self._key] = fn
        return fn

    def __call__(self, *args, device: Optional[torch.device] = None,
                 no_fit: Optional[str] = None) -> None:
        fn = _bound.get(self._key)
        if fn is None:
            fn = self._bind()
        vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        if self.launch:
            vals.append(_stream_handle(device))
        err = fn(*vals)
        if err:
            check(err, self.lib, self.symbol, no_fit)
        if self.launch:
            launches[self.lib] += 1


def read_plan(entry: Entry, *args, size: str) -> dict:
    """A sweep launcher's plan as a dict: ``entry(*args, out)`` fills five
    ints; ``resident_warps`` (an SM's) is threads x blocks_per_sm / 32."""
    out = (ctypes.c_int * 5)()
    entry(*args, out, no_fit=size)
    keys = ("threads", "window_items", "smem_bytes", "blocks_per_sm", "sms")
    plan = dict(zip(keys, out))
    plan["resident_warps"] = plan["threads"] * plan["blocks_per_sm"] // 32
    return plan


def require(name: str, t: torch.Tensor, device: torch.device,
            dtype=torch.float32):
    """Check a kernel operand: on ``device``, of ``dtype``, contiguous."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")
