"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``nis_sar_amtigmti_video_tpu_torch/csrc`` are compiled at
first use with ``nvcc`` into one shared library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/libnis_kernels_<hash>.so csrc/*.cu

and loaded with ``ctypes``. ``build/kernels/`` sits at the root of the
checkout; the file name carries a hash of the sources and flags, so a second
run reuses the library and an edited source rebuilds it. No fast math: the
kernels rely on the accurate ``sincosf``/``atan2f`` and IEEE division.

Each C launcher takes its tensor pointers, then its int arguments, then the
CUDA stream, and returns ``cudaGetLastError()`` after the launch;
:func:`launch` raises on a non-zero code. Nothing here allocates or
synchronises: the wrappers allocate outputs with ``torch.empty`` and the
launch goes on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SOURCE_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libnis_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def build() -> Path:
    """Compile the sources unless a library for them exists; return it."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(SOURCE_DIR.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.nis_error_string.argtypes = [ctypes.c_int]
    lib.nis_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, tensors: Sequence[torch.Tensor],
           ints: Sequence[int]) -> None:
    """Call C launcher ``name`` with the tensors' data pointers, the ints
    and the current stream of the tensors' device; raise on a CUDA error."""
    lib = library()
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *(int(i) for i in ints),
                 stream)
    if err != 0:
        msg = lib.nis_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrappers then run the plain version);
    False for a CUDA tensor; raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def check(name: str, tensors: Sequence[torch.Tensor], shape, device) -> None:
    """Each tensor f32, contiguous, of ``shape``, on ``device``."""
    for i, t in enumerate(tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: argument {i} is not a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: argument {i} is {t.dtype}, "
                            "needs torch.float32")
        if t.device != device:
            raise ValueError(f"{name}: argument {i} is on {t.device}, "
                             f"the others on {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: argument {i} has shape "
                             f"{tuple(t.shape)}, needs {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous "
                             "(pass .contiguous() planes)")
