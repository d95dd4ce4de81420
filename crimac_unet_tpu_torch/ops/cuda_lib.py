"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together) and linked into ONE shared library with
a plain C interface, loaded with ``ctypes``.  The build runs at the first
kernel launch, never at import, and writes into ``.kernel_build/`` beside
the package; the library's name carries a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads the cached file.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception.  ``launches`` counts, per kernel, the launches the wrappers
made — a run resets it and reads it to show which kernels carried it.

Every kernel is also an operator of the ``crimac::`` namespace
(:func:`define_op`): its CUDA implementation is the ctypes launch, its
CPU implementation the plain PyTorch version, and its fake
implementation allocates the outputs only, so ``torch.export`` records
the launch in an exported graph (pipeline/export.py) and a loaded
artifact dispatches it to the kernel.  The public wrappers check their
arguments and call the operator; the dispatcher picks the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / ".kernel_build"
# no fast math: gather_db needs the full-precision log10f and IEEE division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of csrc/common.cuh CrimacDtype
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}

launches = {"gather_db": 0, "maxpool2x2": 0, "relu_pool_skip": 0,
            "binary_closing": 0}

_lock = threading.Lock()
_lib = None
build_log = ""         # nvcc's output (ptxas register / spill report)


# one Library object owns the namespace; each kernel module adds its op
LIB = torch.library.Library("crimac", "DEF")


def define_op(schema: str, cuda, cpu, fake):
    """Define ``crimac::<name>`` from ``schema`` with its CUDA, CPU and
    fake implementations; returns the operator overload to call."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"crimac::{name}", fake, lib=LIB)
    return getattr(torch.ops.crimac, name).default


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(cand):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda): the CUDA kernels are built "
                           "at first use and need the CUDA toolkit")
    return cand


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcrimac_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless the library already exists."""
    global build_log
    so = library_path()
    if so.is_file():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)]
        logs, failed = [], []
        for s, p in zip(sources, procs):
            out, _ = p.communicate()
            logs.append(f"--- {s.name}\n{out}")
            if p.returncode:
                failed.append(s.name)
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)  # atomic: concurrent builders never see half
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            L.crimac_gather_db.argtypes = [P, I, I, I, I, P, P, I, I, I,
                                           I, I, I, I, I, I, P, I, P]
            L.crimac_maxpool2x2.argtypes = [P, P, I, I, I, I, I, I, P]
            L.crimac_relu_pool_skip.argtypes = [P, P, P, I, I, I, I, I, I,
                                                P]
            L.crimac_binary_closing.argtypes = [P, P, P, I, I, I, P]
            for fn in (L.crimac_gather_db, L.crimac_maxpool2x2,
                       L.crimac_relu_pool_skip, L.crimac_binary_closing):
                fn.restype = I
            L.crimac_error_string.argtypes = [I]
            L.crimac_error_string.restype = ctypes.c_char_p
            _lib = L
    return _lib


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err:
        msg = lib().crimac_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def require_device(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for tensors that all lie on one device; raises on
    mixed or other devices (the wrappers launch on CUDA, fall to the plain
    version only on the CPU)."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on different devices: "
                         f"{sorted(map(str, kinds))}")
    kind = next(iter(kinds)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {kind!r}")
    return kind
