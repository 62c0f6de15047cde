"""Shared kernel utilities: device choice, the nvcc build, launch counts.

Kernels are CUDA C++ sources under ``repro_torch/csrc/``, compiled at
first use with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface (``build/kernels/`` at the repository root, named by
a hash of source and flags, so an edited source is rebuilt), and called
through ``ctypes``.  Every C entry point takes raw device pointers and
the stream as ``c_void_p``, launches on that stream without
synchronising, and returns ``cudaGetLastError()``; a non-zero code
raises here.  Nothing is compiled or loaded at import time.

Each kernel keeps a launch count (``CudaKernel.launches``), raised by
one on every successful launch and nowhere else, so a run can show that
its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"   # <repo>/build/kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_BUILD_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Asking for CUDA where there is none raises:
    nothing quietly carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                       "kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source and flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together.  Returns each compiled
    library's ``nvcc`` output (``-Xptxas=-v``: registers, shared memory,
    spills); raises with the compiler's output if a build fails."""
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in dict.fromkeys(names):
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        logs, failed = {}, []
        for name, (p, tmp, out) in procs.items():
            logs[name] = p.communicate()[0]
            if p.returncode != 0:
                failed.append(name)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(
                f"{n}:\n{logs[n]}" for n in failed))
        return logs


class CudaKernel:
    """One C entry point ``<symbol>`` of ``csrc/<source>.cu``, counted
    under ``name`` (``source`` defaults to ``name``; two entry points of
    one source, such as a forward and a backward, share its library).

    ``argtypes`` are the ctypes of the entry's arguments (pointers and
    the stream as ``c_void_p``).  The library is built and loaded at the
    first launch.  ``launch`` raises on a non-zero
    ``cudaGetLastError()`` and counts the launch only if it succeeded.
    """

    def __init__(self, name: str, symbol: str,
                 argtypes: Sequence[type], source: Optional[str] = None):
        self.name = name
        self.source = source or name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None
        KERNELS[name] = self

    def _load(self):
        if self._fn is None:
            build([self.source])
            lib = ctypes.CDLL(str(library_path(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.source}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._err, self._fn = lib, err, fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} "
                               f"({self._err(rc).decode()})")
        self.launches += 1


# every kernel of the package, by name (filled as kernel modules import)
KERNELS: Dict[str, CudaKernel] = {}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_ptr(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               ndim: Optional[int] = None) -> None:
    """A kernel wrapper's input check: a contiguous CUDA tensor of the
    given type (and rank).  Raises on anything the kernel does not
    take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
