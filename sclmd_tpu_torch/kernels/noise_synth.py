"""K3: the colored-noise half spectrum with its Gaussian draw made in the
kernel, and K3b: the thermal start's uniform phases (both in
csrc/noise_synth.cu).

For one bath with factors (U, std) and the trajectories [lo, hi) of an
ensemble seeded ``seed``, on the schedule's stream ``stream``,

    xi[t, w, i] = sum_k U(w)[i, k] std[w, k] z(lo + t, w nc + k),

w = 0..nmd/2 (the imaginary parts of rows 0 and nmd/2 written as zero,
as the real series drops them), where z is the schedule's standard
normal
(``ops.philox``: Philox4x32-10, counter (e // 4, 0, j, 0)). ``U`` is one
(nc, nc) complex matrix (a proportional spectrum) or an (nmd/2+1, nc, nc)
batch. The draw depends on (seed, stream, trajectory, element) only,
never on the window, so chunks of an ensemble draw bitwise the numbers of
the whole.

On CUDA tensors ``noise_halfspectrum`` and ``init_uniforms`` launch the
kernels (float32 and complex64 only; float64 raises, and so does a failed
build or launch); on CPU tensors they run the plain twins, which draw the
same integers through ``ops.philox``.
"""

from __future__ import annotations

import ctypes

import torch

from sclmd_tpu_torch.kernels import build
from sclmd_tpu_torch.ops import philox

launches = 0          # noise_synth (K3) launches, not twin calls
launches_init = 0     # init_draw (K3b) launches

R = 8                 # NS_R in csrc/noise_synth.cu
MAX_CI = 256          # NS_MAX_CI: channels a pass of a CTA covers
MAX_THREADS = 640     # NS_MAX_THREADS: the kernel's launch bound
MAX_GROUPS = 8
SMEM_LIMIT = 227 * 1024
REGS = 88             # registers ptxas allocates a thread (chip_smoke phase 2)


def reset_count():
    global launches, launches_init
    launches = launches_init = 0


def launch_plan(nc: int, ntraj: int, h: int, batch: bool, nsm: int,
                groups: int = None) -> dict:
    """Threads, tile and grid of a K3 launch: ``ci`` channels a pass,
    ``groups`` groups of R trajectories (threads = groups * ci, tile
    groups * R): as many groups as the call has trajectories for, up to
    MAX_THREADS threads and what shared memory holds beside U, which is
    staged there where it fits beside one group's draws. A CTA per
    frequency for the batch path, else enough CTAs to fill the card.
    ``groups`` forces the group count (sweeps), within those limits."""
    ci = min(nc, MAX_CI)
    want = -(-ntraj // R) if groups is None else groups
    groups = max(1, min(MAX_THREADS // ci, MAX_GROUPS, want))
    smem_u = 4 * R * nc + 8 * nc * nc <= SMEM_LIMIT
    u_bytes = 8 * nc * nc if smem_u else 0
    while groups > 1 and 4 * groups * R * nc + u_bytes > SMEM_LIMIT:
        groups -= 1
    smem = 4 * groups * R * nc + u_bytes
    threads = groups * ci
    per_sm = max(1, min(SMEM_LIMIT // smem, 2048 // threads,
                        65536 // (threads * REGS)))
    grid = h if batch else min(h, nsm * per_sm)
    return {"ci": ci, "groups": groups, "tile": groups * R,
            "smem_u": smem_u, "smem_bytes": smem, "grid": grid}


def draw_plain(std: torch.Tensor, seed: int, stream: int, lo: int,
               hi: int) -> torch.Tensor:
    """The twin's scaled draw std[w, k] z (hi-lo, h, nc) in std's type."""
    h, nc = std.shape
    z = philox.normals(seed, stream, lo, hi, h * nc, std.device)
    return z.reshape(hi - lo, h, nc).to(std.dtype) * std


def halfspectrum_plain(evecs: torch.Tensor, std: torch.Tensor, seed: int,
                       stream: int, lo: int, hi: int) -> torch.Tensor:
    """Plain torch twin of K3: (hi-lo, h, nc) complex, the imaginary parts
    of the first and last rows zero."""
    from sclmd_tpu_torch.ops.noise import (drop_edge_imag_,
                                           halfspectrum_from_draw)
    return drop_edge_imag_(halfspectrum_from_draw(
        draw_plain(std, seed, stream, lo, hi), evecs))


def noise_halfspectrum(evecs: torch.Tensor, std: torch.Tensor, seed: int,
                       stream: int, lo: int, hi: int) -> torch.Tensor:
    """The schedule's half spectrum of trajectories [lo, hi): the kernel
    for CUDA tensors, the twin for CPU tensors."""
    if evecs.device.type == "cpu" and std.device.type == "cpu":
        return halfspectrum_plain(evecs, std, seed, stream, lo, hi)
    return noise_halfspectrum_cuda(evecs, std, seed, stream, lo, hi)


class _NsArgs(ctypes.Structure):
    _fields_ = [("U", ctypes.c_void_p), ("std", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("ntraj", ctypes.c_int), ("h", ctypes.c_int),
                ("nc", ctypes.c_int), ("batch", ctypes.c_int),
                ("draw_only", ctypes.c_int),
                ("lo", ctypes.c_uint), ("k0", ctypes.c_uint),
                ("k1", ctypes.c_uint),
                ("groups", ctypes.c_int), ("ci", ctypes.c_int),
                ("grid", ctypes.c_int), ("smem_u", ctypes.c_int),
                ("smem_bytes", ctypes.c_int)]


def _check_window(lo: int, hi: int, n: int, who: str):
    if not 0 <= lo < hi or hi > 2 ** 32 or n >= 2 ** 31:
        raise ValueError(f"{who}: window [{lo}, {hi}) of {n} elements is "
                         "outside the schedule's 32-bit counters")


def noise_halfspectrum_cuda(evecs: torch.Tensor, std: torch.Tensor,
                            seed: int, stream: int, lo: int, hi: int,
                            draw_only: bool = False,
                            plan: dict = None) -> torch.Tensor:
    """K3 on the card. ``draw_only``: the scaled draw std z (hi-lo, h, nc)
    float32 instead of the product (the check of the kernel's normals);
    ``plan`` overrides ``launch_plan`` (tests of other launch shapes)."""
    global launches
    dev = std.device
    if dev.type != "cuda" or evecs.device != dev:
        raise ValueError("noise_synth: evecs and std must be on the same "
                         "CUDA device")
    if evecs.dtype != torch.complex64 or std.dtype != torch.float32:
        raise TypeError("noise_synth: the kernel takes complex64 factors "
                        f"and float32 std (got {evecs.dtype}, {std.dtype}); "
                        "a float64 run stays on the CPU")
    if std.ndim != 2:
        raise ValueError(f"noise_synth: std must be (h, nc), got "
                         f"{tuple(std.shape)}")
    h, nc = std.shape
    batch = evecs.ndim == 3
    if evecs.shape != ((h, nc, nc) if batch else (nc, nc)):
        raise ValueError(f"noise_synth: evecs {tuple(evecs.shape)} is "
                         f"neither ({nc}, {nc}) nor ({h}, {nc}, {nc})")
    _check_window(lo, hi, h * nc, "noise_synth")
    evecs, std = evecs.contiguous(), std.contiguous()
    lib = build.load()
    if lib.noise_synth_r() != R:
        raise RuntimeError("noise_synth: R differs from the kernel's")
    if plan is None:
        nsm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = launch_plan(nc, hi - lo, h, batch, nsm)
    out = torch.empty((hi - lo, h, nc),
                      dtype=torch.float32 if draw_only else torch.complex64,
                      device=dev)
    k0, k1 = philox.stream_key(seed, stream)
    a = _NsArgs(evecs.data_ptr(), std.data_ptr(), out.data_ptr(), hi - lo,
                h, nc, int(batch), int(draw_only), lo, k0, k1,
                plan["groups"], plan["ci"], plan["grid"],
                int(plan["smem_u"]), plan["smem_bytes"])
    rc = lib.noise_synth_f32(ctypes.byref(a), build.current_stream(dev))
    build.check(rc, "noise_synth")
    launches += 1
    return out


def init_uniforms(seed: int, stream: int, lo: int, hi: int, n: int,
                  device, dtype) -> torch.Tensor:
    """(hi-lo, n) uniform phases of the schedule: K3b on the card
    (float32 only), the twin on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox.uniforms(seed, stream, lo, hi, n, device, dtype)
    return init_uniforms_cuda(seed, stream, lo, hi, n, device, dtype)


def init_uniforms_cuda(seed: int, stream: int, lo: int, hi: int, n: int,
                       device, dtype=torch.float32) -> torch.Tensor:
    global launches_init
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("init_draw: the kernel writes a CUDA tensor")
    if dtype != torch.float32:
        raise TypeError(f"init_draw: the kernel writes float32 (got {dtype}); "
                        "a float64 run stays on the CPU")
    _check_window(lo, hi, n, "init_draw")
    lib = build.load()
    out = torch.empty((hi - lo, n), dtype=torch.float32, device=device)
    k0, k1 = philox.stream_key(seed, stream)
    rc = lib.init_draw_f32(out.data_ptr(), hi - lo, n, lo, k0, k1,
                           build.current_stream(device))
    build.check(rc, "init_draw")
    launches_init += 1
    return out
