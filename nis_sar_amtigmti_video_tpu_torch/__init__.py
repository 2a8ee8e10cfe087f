"""PyTorch / CUDA port of the SAR / GMTI framework, for NVIDIA Hopper.

The JAX package ``nis_sar_amtigmti_video_tpu`` beside this one is the
reference: every module here has a counterpart at the same path there, and
the port's tests hold each against it on the same inputs. This package never
imports JAX.

Precision policy (as in the reference)
--------------------------------------
Geometry (trajectories, slant ranges, delays) is float64; phases are wrapped
mod 2*pi in float64 *before* the float32 cast; every large tensor (phase
histories, images, product planes) is float32 / complex64.

Devices
-------
Data lives where the caller puts it: entry points take an explicit
``device`` for what they create, and everything downstream follows its
input tensors. Hand-written CUDA kernels (``ops/cuda``, sources in
``csrc/``) run on CUDA tensors; on CPU tensors each kernel wrapper runs its
plain PyTorch version instead.
"""

from nis_sar_amtigmti_video_tpu_torch import config, constants

__version__ = "0.1.0"

__all__ = ["constants", "config", "__version__"]
