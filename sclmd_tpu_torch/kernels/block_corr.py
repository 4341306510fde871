"""K2: the pre-block memory-kernel convolution of the blocked integrator.

``block_corr`` computes, for every trajectory, the pre-block tails
O[s] = sum_{j>=s+1} K[j] v(t0+s-j), s = 0..block, as a circular
cross-correlation: rfft of the (ml-1, nc) history, a per-frequency
complex contraction with the kernel spectrum, irfft. The FFTs stay
``torch.fft`` calls (cuFFT), as the JAX package left them to XLA; the
contraction

    prod[t, f, a] = sum_b khat[f, a, b] * conj(hhat[t, f, b])

is the hand-written kernel ``block_corr_freq`` (csrc/block_corr.cu) on
CUDA tensors and ``block_corr_freq_plain`` on CPU tensors.
"""

from __future__ import annotations

import torch

from sclmd_tpu_torch.kernels import build
from sclmd_tpu_torch.utils import profiling

launches = 0          # block_corr_freq kernel launches (not twin calls)


def reset_count():
    global launches
    launches = 0


profiling.register("launches.K2", __name__, "launches")


def block_corr_freq_plain(khat: torch.Tensor,
                          hhat: torch.Tensor) -> torch.Tensor:
    """Plain torch twin: (nf, nc, nc) x (traj, nf, nc) -> (traj, nf, nc)."""
    return torch.einsum("fab,tfb->tfa", khat, torch.conj(hhat))


def block_corr_freq(khat: torch.Tensor, hhat: torch.Tensor) -> torch.Tensor:
    """The frequency-batched contraction: the CUDA kernel for CUDA
    tensors (complex64 only), the plain twin for CPU tensors."""
    if khat.device.type == "cpu" and hhat.device.type == "cpu":
        return block_corr_freq_plain(khat, hhat)
    return block_corr_freq_cuda(khat, hhat)


def block_corr_freq_cuda(khat: torch.Tensor,
                         hhat: torch.Tensor) -> torch.Tensor:
    global launches
    if khat.device.type != "cuda" or hhat.device != khat.device:
        raise ValueError("block_corr_freq: khat and hhat must be on the "
                         "same CUDA device")
    if khat.dtype != torch.complex64 or hhat.dtype != torch.complex64:
        raise TypeError("block_corr_freq: the CUDA kernel takes complex64 "
                        f"(got {khat.dtype}, {hhat.dtype})")
    if khat.ndim != 3 or hhat.ndim != 3 or khat.shape[1] != khat.shape[2] \
            or hhat.shape[1:] != khat.shape[::2]:
        raise ValueError(f"block_corr_freq: shapes {tuple(khat.shape)} and "
                         f"{tuple(hhat.shape)} do not match (nf, nc, nc) "
                         "and (traj, nf, nc)")
    if not (khat.is_contiguous() and hhat.is_contiguous()):
        raise ValueError("block_corr_freq: inputs must be contiguous")
    ntraj, nf, nc = hhat.shape
    lib = build.load()
    if nc > lib.block_corr_freq_max_nc():
        raise ValueError(f"block_corr_freq: baths wider than "
                         f"{lib.block_corr_freq_max_nc()} DOFs do not fit "
                         "the kernel's shared memory")
    out = torch.empty_like(hhat)
    rc = lib.block_corr_freq_f32(
        khat.data_ptr(), hhat.data_ptr(), out.data_ptr(), ntraj, nf, nc,
        torch.cuda.current_stream(khat.device).cuda_stream)
    build.check(rc, "block_corr_freq")
    launches += 1
    return out


def block_corr(hist: torch.Tensor, block: int, khat: torch.Tensor,
               nfft: int) -> torch.Tensor:
    """Pre-block tails (traj, block+1, nc) from the newest-first history
    ``hist`` (traj, ml-1, nc), hist[:, i] = v(t0-1-i); ``khat`` is the
    rfft of the kernel zero-padded to ``nfft`` >= ml+block+1 taps, which
    keeps the circular correlation linear."""
    hhat = torch.fft.rfft(hist, n=nfft, dim=1).contiguous()
    prod = block_corr_freq(khat, hhat)
    corr = torch.fft.irfft(prod, n=nfft, dim=1)
    return corr[:, 1:block + 2]
