"""Forward spectra's and the raw balance's host-side plans without a GPU:
the natural-order filter table the forward kernel reads, and the fused
kernel's bit-reversed one; forward spectra's batch independence through the
wrapper on CPU tensors (its plain version); the balance kernel's grid
(``ops/cuda/gmti_kernel.py::balance_grid``) as a function of the shape and
the card's limits; and the balance wrapper on rectangular CPU planes (its
plain version) against float64 NumPy. The forward kernel's plan is fixed per
nfft in ``csrc/fft_kernel.cu``, whose static_asserts hold it to an H100 SM's
shared memory and threads at compile time; the kernels themselves are held
to their plain versions on the card (tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

from nis_sar_amtigmti_video_tpu_torch.ops import bp
from nis_sar_amtigmti_video_tpu_torch.ops.cuda import fft_kernel, gmti_kernel

torch.set_num_threads(1)

NFFTS = [16384, 32768, 65536]


# --------------------------------------------------------------------------
# forward spectra
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return bp.BpParams(fc_hz=9.65e9, chirp_rate=150e6 / 2e-6, fs_hz=180e6,
                       pulse_width_s=2e-6, num_samples=10000)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("nfft", NFFTS)
def test_forward_filter_is_natural_layout(params, nfft, compress):
    """Forward spectra's filter is the spectra layout, k1 natural; the
    fused kernel's is the same with k1 bit-reversed within each row."""
    cpu = torch.device("cpu")
    got = fft_kernel._filter_layout(params, nfft, compress, cpu)
    if compress:
        want = fft_kernel._to_layout(
            fft_kernel.matched_filter(params, nfft, cpu)[None, :])[0]
    else:
        want = torch.ones((nfft // 128, 128), dtype=torch.complex64)
    assert got.shape == (nfft // 128, 128) and got.is_contiguous()
    assert torch.equal(got, want)
    fused = fft_kernel._filter(params, nfft, compress, cpu)
    rev = [int(f"{q:07b}"[::-1], 2) for q in range(128)]
    assert torch.equal(fused, want[:, rev])


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("ns", [10000, 12800, 16384])
def test_forward_spectra_cpu_is_batch_independent(params, ns, compress):
    """Padded, a multiple of 128, and ns = nfft (no padding)."""
    rng = np.random.default_rng(3)
    rc = torch.from_numpy((rng.standard_normal((5, ns))
                           + 1j * rng.standard_normal((5, ns))
                           ).astype(np.complex64))
    full = fft_kernel.forward_spectra(rc, params, compress)
    assert full.shape == (5, 128, 128)
    np.testing.assert_allclose(
        fft_kernel.forward_spectra(rc[2:4], params, compress).numpy(),
        full[2:4].numpy(), rtol=0, atol=1e-3)


# --------------------------------------------------------------------------
# raw balance
# --------------------------------------------------------------------------

SHAPES = [(256, 256), (4096, 4096), (1024, 4096), (4096, 64), (4097, 4096),
          (1, 4), (3, 12)]
# (float4 loads a block's round, most blocks): the kernel's 256 threads x 4
# loads at three blocks an SM on an H100 SXM's 132 SMs and a PCIe card's 114
LIMITS = [(1024, 396), (1024, 342)]


@pytest.mark.parametrize("limits", LIMITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_balance_grid_is_a_function_of_the_shape(shape, limits):
    per_block, most = limits
    n4 = shape[0] * shape[1] // 4
    blocks = gmti_kernel.balance_grid(*shape, *limits)
    assert blocks == gmti_kernel.balance_grid(*shape, *limits)
    assert 1 <= blocks <= most
    # no block without a full round of loads unless the grid is capped
    assert blocks == min(most, -(-n4 // per_block))


def test_balance_grid_fills_the_card_at_the_cpi():
    """The 4096^2 CPI (and 4097 rows) on three blocks of each of 132
    SMs; a small plane on as many blocks as its loads need."""
    limits = LIMITS[0]
    assert gmti_kernel.balance_grid(4096, 4096, *limits) == 396
    assert gmti_kernel.balance_grid(4097, 4096, *limits) == 396
    assert gmti_kernel.balance_grid(256, 256, *limits) == 16
    assert gmti_kernel.balance_grid(1, 4, *limits) == 1


@pytest.mark.parametrize("shape", [(37, 12), (4097, 8), (5, 4)])
def test_raw_balance_cpu_rectangles_match_float64(shape):
    rng = np.random.default_rng(11)
    x = [rng.standard_normal(shape, dtype=np.float32) for _ in range(4)]
    got = gmti_kernel.raw_balance(*(torch.from_numpy(v) for v in x))
    assert all(g.dim() == 0 and g.dtype == torch.float32 for g in got)
    want = np.sum((x[0] + 1j * x[1]).astype(np.complex128)
                  * np.conj((x[2] + 1j * x[3]).astype(np.complex128)))
    scale = np.sqrt(np.sum(np.abs(x[0] + 1j * x[1]) ** 2)
                    * np.sum(np.abs(x[2] + 1j * x[3]) ** 2))
    assert abs(float(got[0]) - want.real) <= 1e-5 * scale
    assert abs(float(got[1]) - want.imag) <= 1e-5 * scale
