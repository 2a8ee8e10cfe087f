#!/usr/bin/env python3
"""Wall time of the port's kernel build, one nvcc for all sources against
one nvcc per source in parallel, on the same machine in one run.

    python3 scripts/time_torch_kernel_build.py      # on the GPU machine

"serial" is a single ``nvcc <NVCC_FLAGS> -shared -o lib.so csrc/*.cu``;
"parallel" is ``ops/cuda/_build.py::build`` (one ``nvcc -c`` per source,
all started together, then one link). Each build starts from an empty
directory under ``build/build_timing/``, in the order serial, parallel,
parallel, serial; each built library is loaded with ctypes to check it.
Prints the card's name and power limit and each build's seconds. Imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nis_sar_amtigmti_video_tpu_torch.ops.cuda import _build  # noqa: E402

OUT = ROOT / "build" / "build_timing"


def serial(out: Path) -> Path:
    lib = out / "libserial.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), *map(str, sorted(_build.SOURCE_DIR.glob("*.cu")))],
                   check=True)
    return lib


def parallel(out: Path) -> Path:
    _build.BUILD_DIR = out
    return _build.build()


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    n_src = len(list(_build.SOURCE_DIR.glob("*.cu")))
    times = {"serial": [], "parallel": []}
    for i, name in enumerate(("serial", "parallel", "parallel", "serial")):
        out = OUT / f"{i}_{name}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        t = time.perf_counter()
        lib = (serial if name == "serial" else parallel)(out)
        secs = time.perf_counter() - t
        ctypes.CDLL(str(lib)).nis_error_string
        times[name].append(secs)
        print(f"[build] {name} {secs:.2f} s ({n_src} sources)")
    shutil.rmtree(OUT, ignore_errors=True)
    print("[build] " + "; ".join(f"{k} " + " / ".join(f"{s:.2f}" for s in v)
                                 for k, v in times.items()) + " s")


if __name__ == "__main__":
    main()
