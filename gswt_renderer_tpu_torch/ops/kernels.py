"""Building, loading and counting the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds one module's kernels behind a plain C
interface. It is compiled with nvcc for sm_90a into ``build/lib<name>.so`` at
first use (or by ``build_all``, which starts one nvcc per source at once) and
loaded with ctypes. A C entry returns ``cudaGetLastError()``; ``check`` raises if it is
not 0, since a refused launch never runs and a later synchronize would not
report it.

``LAUNCHES`` counts kernel launches by name: every wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
KERNELS = ("blockgather", "raster", "trirast", "bilinear", "miptrilinear",
           "mergesorted", "micro_raster", "micro_blockgather")

LAUNCHES: collections.Counter = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA must be present when asked
    for: there is no quiet fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _so_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _compile_cmd(name: str, out: str) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", out, os.path.join(CSRC, f"{name}.cu"),
    ]


def _stale(name: str) -> bool:
    so = _so_path(name)
    src = os.path.join(CSRC, f"{name}.cu")
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def _report_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.ptxas.txt")


def ptxas_report(name: str) -> str:
    """The -Xptxas -v report (registers, shared memory and spill of every
    kernel) of the build of `name` in BUILD, or "" if there is none."""
    try:
        with open(_report_path(name)) as f:
            return f.read()
    except FileNotFoundError:
        return ""


def build_all(names=KERNELS) -> dict:
    """Compile every stale kernel library, all nvcc processes at once, and
    keep each one's ptxas report beside it (ptxas_report). Returns {name:
    ptxas report} for the ones it compiled."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        if _stale(name):
            tmp = _so_path(name) + f".{os.getpid()}.tmp"
            procs[name] = (tmp, subprocess.Popen(
                _compile_cmd(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    reports = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        with open(_report_path(name), "w") as f:
            f.write(out)
        os.replace(tmp, _so_path(name))
        reports[name] = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str, **entries) -> ctypes.CDLL:
    """The kernel library `name`, built first if it is missing or stale.
    `entries` maps each C entry to its argtypes; every entry returns int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all((name,))
            lib = ctypes.CDLL(_so_path(name))
            for fn_name, argtypes in entries.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, for a launch. It
    reads PyTorch's raw accessor of the current stream (CUDA builds only):
    a far cheaper call on every launch than torch.cuda.current_stream(),
    which builds a Stream object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
