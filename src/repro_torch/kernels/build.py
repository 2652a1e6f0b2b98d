"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC -Xptxas -v`` into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), then bound with ``ctypes``.
``flash_attention`` also links ``-lcuda``: it encodes its TMA tensor maps
with ``cuTensorMapEncodeTiled`` from libcuda.  The library name carries a
hash of its source and flags, so an edited kernel is always rebuilt; the
compiler's output (ptxas's registers, shared memory and spills per kernel)
is kept beside it as ``.log`` (``build_log``).  ``build_all()`` starts one
``nvcc`` per source at once and waits for all.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("race_lookup", "fleet_read", "leaf_probe", "flash_attention",
           "paged_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = {"flash_attention": ["-lcuda"]}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if path is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        path = os.path.join(home, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the GPU")
    return path


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + LINK_FLAGS.get(name, [])
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
           *LINK_FLAGS.get(name, [])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_log(name: str) -> str:
    """What nvcc printed when it built ``csrc/<name>.cu`` (ptxas -v)."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def build_all(names: List[str] = SOURCES) -> Dict[str, Path]:
    """Compile every listed source that has no up-to-date library, one
    ``nvcc`` process per source, all started together."""
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        _finish(n, job)
    return {n: _lib_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _index(device) -> int:
    import torch
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``device`` (the
    stream every kernel of the port launches on), read through
    ``torch._C``'s raw getter, which builds no Python stream object as
    ``torch.cuda.current_stream`` does."""
    import torch
    return torch._C._cuda_getCurrentRawStream(_index(device))


_streams: Dict[tuple, object] = {}


def current_stream(device):
    """``torch.cuda.current_stream(device)``, cached by device and raw
    handle, so that synchronising the stream a kernel just launched on
    builds no Python stream object per call."""
    key = (_index(device), stream_ptr(device))
    stream = _streams.get(key)
    if stream is None:
        import torch
        stream = _streams[key] = torch.cuda.current_stream(device)
    return stream
