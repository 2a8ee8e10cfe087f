"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``nis_sar_amtigmti_video_tpu_torch/csrc`` are compiled at
first use with ``nvcc``, one process per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <source>.o csrc/<source>.cu

then linked into one shared library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/kernels/libnis_kernels_<hash>.so *.o

and loaded with ``ctypes``. ``build/kernels/`` sits at the root of the
checkout; the file name carries a hash of the sources and flags, so a second
run reuses the library and an edited source rebuilds it. No fast math: the
kernels rely on the accurate ``sincosf``/``atan2f`` and IEEE division.

Each C launcher takes its tensor pointers (null for a tensor passed as
None), then its int arguments, then its float arguments (if any), then the
CUDA stream, and returns ``cudaGetLastError()`` after the launch;
:func:`launch` raises on a non-zero code. Nothing here allocates or synchronises: the wrappers allocate outputs
with ``torch.empty`` and the launch goes on PyTorch's current stream.
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
              "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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


def _finish(cmd, proc) -> None:
    """Wait for one nvcc process; raise with its message if it failed."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{err}")


def build() -> Path:
    """Compile the sources (in parallel) and link them unless a library
    for them exists; return it."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    tmp = out.with_name(f"{out.name}.{tag}")
    objs, jobs = [], []
    try:
        for src in sorted(SOURCE_DIR.glob("*.cu")):
            obj = out.with_name(f"{out.stem}.{src.stem}.{tag}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failure = None
        for cmd, proc in jobs:          # wait for every job, keep the first
            try:
                _finish(cmd, proc)
            except RuntimeError as e:
                failure = failure or e
        if failure is not None:
            raise failure
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for o in objs)]
        _finish(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.nis_error_string.argtypes = [ctypes.c_int]
    lib.nis_error_string.restype = ctypes.c_char_p
    return lib


def stream_handle(dev: torch.device) -> int:
    """The ``cudaStream_t`` of ``dev``'s current stream, as an int, read
    without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def launch(name: str, tensors: Sequence[torch.Tensor | None],
           ints: Sequence[int], floats: Sequence[float] = (),
           doubles: Sequence[float] = ()) -> None:
    """Call C launcher ``name`` with the tensors' data pointers (a null
    pointer for None; the first is a tensor), the ints, the floats (C
    ``float``), the doubles (C ``double``) and the current stream of the
    first tensor's device; raise on a CUDA error."""
    lib = library()
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                   + [ctypes.c_int] * len(ints)
                   + [ctypes.c_float] * len(floats)
                   + [ctypes.c_double] * len(doubles) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = tensors[0].device
    with torch.cuda.device(dev):
        err = fn(*(None if t is None else t.data_ptr() for t in tensors),
                 *(int(i) for i in ints),
                 *(float(f) for f in floats), *(float(f) for f in doubles),
                 stream_handle(dev))
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


def check(name: str, tensors: Sequence[torch.Tensor], shape, device,
          dtype: torch.dtype = torch.float32) -> None:
    """Each tensor of ``dtype`` (float32 unless given: complex64, int32,
    ...), contiguous, of ``shape``, on ``device``."""
    shape = tuple(shape)
    for i, t in enumerate(tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: argument {i} is not a tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name}: argument {i} is {t.dtype}, "
                            f"needs {dtype}")
        if t.device != device:
            raise ValueError(f"{name}: argument {i} is on {t.device}, "
                             f"the others on {device}")
        if t.shape != shape:
            raise ValueError(f"{name}: argument {i} has shape "
                             f"{tuple(t.shape)}, needs {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous "
                             "(pass .contiguous() planes)")
