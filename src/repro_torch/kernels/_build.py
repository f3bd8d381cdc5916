"""Build and bind the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), loaded
with ``ctypes``.  Libraries are built at first use into
``<repo>/build/kernels/<hash>/`` where the hash covers every source under
``csrc/`` and the compiler flags, so an edited source rebuilds and an
unchanged one loads the cached library.  A library may be built as
several units of its source (the same ``.cu`` under different ``-D``
flags, each an object file, linked into the one library), so that a
source with many kernel instantiations compiles in parallel.
:func:`build_all` starts one ``nvcc`` per unit of every library at once
and waits for all of them.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:meth:`KernelLib.launch` raises on a non-zero code and is the one place
each kernel's launch count goes up.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
F32 = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


class KernelLib:
    """One ``csrc/<name>.cu`` shared library and its launch counts: in
    all (``launches``), per C entry point (``by_symbol``) and per kernel
    (``by_kernel``: the name the caller gives the kernel its arguments
    select behind an entry point, else the entry point's).  ``units``,
    when given, lists the extra ``nvcc`` flags of each unit the source is
    compiled as (one object file each, compiled in parallel)."""

    def __init__(self, name: str, signatures: Dict[str, list],
                 units: Optional[List[tuple]] = None):
        self.name = name
        self.signatures = signatures
        self.units = units
        self.launches = 0
        self.by_symbol: Dict[str, int] = {}
        self.by_kernel: Dict[str, int] = {}
        self._lib: Optional[ctypes.CDLL] = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.by_symbol = {}
        self.by_kernel = {}

    @property
    def so_path(self) -> Path:
        return build_dir() / f"lib{self.name}.so"

    def _logs(self) -> List[Path]:
        if self.units is None:
            return [self.so_path.with_suffix(".log")]
        return [self.so_path.with_suffix(f".{i}.log")
                for i in range(len(self.units))]

    def _start_build(self):
        """The nvcc processes building this library (None when built)."""
        if self.so_path.exists():
            return None
        self.so_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.so_path.with_suffix(f".{os.getpid()}.tmp")
        src = str(CSRC / f"{self.name}.cu")
        common = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC)]
        if self.units is None:
            cmds = [common + ["-shared", "-o", str(tmp), src]]
            objs = []
        else:
            objs = [tmp.with_suffix(f".{i}.o") for i in range(len(self.units))]
            cmds = [common + ["-c", *flags, "-o", str(o), src]
                    for flags, o in zip(self.units, objs)]
        procs = []
        for cmd, log_path in zip(cmds, self._logs()):
            log = open(log_path, "w")
            procs.append((subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT), log,
                          log_path))
        return procs, tmp, objs

    def _finish_build(self, job) -> None:
        if job is None:
            return
        procs, tmp, objs = job
        failed = []
        for proc, log, log_path in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(f"exit {rc}:\n{log_path.read_text()[-4000:]}")
        if not failed and objs:
            link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                                   str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(f"link exit {link.returncode}:\n"
                              f"{(link.stdout + link.stderr)[-4000:]}")
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed for {self.name}.cu: "
                               + "\n".join(failed))
        os.replace(tmp, self.so_path)

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self._finish_build(self._start_build())
            lib = ctypes.CDLL(str(self.so_path))
            for sym, argtypes in self.signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, symbol: str, *args, kernel: Optional[str] = None
               ) -> None:
        """Call the C entry point ``symbol``; raise on a CUDA error code;
        count the launch, under ``kernel`` (default ``symbol``) too."""
        rc = getattr(self.lib(), symbol)(*args)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name}:{symbol} failed to launch "
                f"(cudaError {rc})")
        self.launches += 1
        self.by_symbol[symbol] = self.by_symbol.get(symbol, 0) + 1
        kernel = kernel or symbol
        self.by_kernel[kernel] = self.by_kernel.get(kernel, 0) + 1

    def ptxas_report(self) -> str:
        """What ``nvcc -Xptxas -v`` said (registers, shared memory,
        spills) when this library was built in this checkout."""
        return "".join(log.read_text() for log in self._logs()
                       if log.exists())


_LIBS: List[KernelLib] = []


def register(lib: KernelLib) -> KernelLib:
    _LIBS.append(lib)
    return lib


def build_all() -> float:
    """Build every registered library, one ``nvcc`` per unit, all
    started together.  Returns the wall-clock seconds it took."""
    t0 = time.perf_counter()
    jobs = [(lib, lib._start_build()) for lib in _LIBS]
    for lib, job in jobs:
        lib._finish_build(job)
    for lib in _LIBS:
        lib.lib()
    return time.perf_counter() - t0


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address for a C entry point (NULL for None)."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


# The formats the kernels specialise at compile time (fmt_code in csrc/);
# any other (e, m) runs the generic decode of its container width.
_FMT_CODES = {(5, 2): 1, (4, 3): 2, (5, 10): 3, (8, 7): 4}


def fmt_code(fmt) -> int:
    """``fmt_code`` of the C entry points for a format (None = f32)."""
    if fmt is None or fmt.is_binary32:
        return 0
    code = _FMT_CODES.get((fmt.e, fmt.m))
    if code is not None:
        return code
    return {1: 5, 2: 6, 4: 7}[fmt.container_bytes]


def check_operands(what: str, device, **tensors) -> None:
    """Every operand a contiguous tensor on ``device`` (None skipped),
    and none that autograd would need a gradient of (``check_no_grad``)."""
    for name, t in tensors.items():
        if t is not None and (t.device != device or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous tensor "
                             f"on {device}, got {t.device}")
    check_no_grad(what, **tensors)


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on these operands (None skipped):
    grad mode on and one of them requiring grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_no_grad(what: str, **tensors) -> None:
    """Raise when grad mode is on and an operand requires grad: a kernel
    launch records nothing for autograd, so its output would silently
    drop the gradient.  A differentiable call goes through the kernel's
    ``torch.autograd.Function`` (whose forward runs with grad mode off)."""
    if not torch.is_grad_enabled():
        return
    for name, t in tensors.items():
        if t is not None and t.requires_grad:
            raise RuntimeError(
                f"{what}: {name} requires grad, and a kernel launch "
                f"records no gradient; call it through its "
                f"torch.autograd.Function, or under torch.no_grad()")
