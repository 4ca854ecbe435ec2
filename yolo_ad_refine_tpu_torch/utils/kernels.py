"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``csrc/build/lib<name>-<hash>.so`` at first use
and loaded with ``ctypes``; the hash covers the source and the flags, so an
edited source is rebuilt. Nothing here runs at import time, and nothing is
built on a machine without ``nvcc``: the CPU path never asks for a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = CSRC / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# per-kernel extra flags: the NMS IoU must round like the reference's
# separate fp32 ops, so nvcc may not contract a*b+c into an FMA there
EXTRA_FLAGS = {"deform_conv": [], "deform_window": [], "gather": [], "lap": [],
               "nms": ["-fmad=false"]}

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the kernels")
    return found


def _flags(name: str) -> list[str]:
    return [*ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", *EXTRA_FLAGS[name]]


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, dict]:
    """Compile the named kernels that are not built yet, one ``nvcc`` each,
    all started together. Returns {name: {"seconds", "log"}} for each build
    run (``-Xptxas -v`` register and shared-memory report in ``log``)."""
    names = names or tuple(EXTRA_FLAGS)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    report = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        lib.yat_cuda_error_string.restype = ctypes.c_char_p
        lib.yat_cuda_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a kernel's C entry."""
    if status != 0:
        msg = lib.yat_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg}) at launch")
