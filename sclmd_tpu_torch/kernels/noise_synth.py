"""K3: the colored-noise half spectrum with its Gaussian draw made in the
kernel and its product on the tensor cores; the C2R transform after it
(cuFFT); and K3b: the thermal start's mode-space amplitudes (all in
csrc/noise_synth.cu).

For one bath with factors (U, std) and the trajectories [lo, hi) of an
ensemble seeded ``seed``, on the schedule's stream ``stream``,

    xi[t, w, i] = sum_k U(w)[i, k] std[w, k] z(lo + t, w nc + k),

w = 0..nmd/2, where z is the schedule's standard normal (``ops.philox``:
Philox4x32-10, counter (e // 4, 0, j, 0)). K3 writes it folded for the
C2R transform: y[t, i, w] = conj(xi[t, w, i]) scale, frequency last
(hi-lo, nc, h), with the imaginary parts of rows 0 and nmd/2 zero (the
real series drops them); ``c2r_series`` then gives the series
irfft(y, nmd, last dim, no normalisation), which is hfft(xi) scale, as
(hi-lo, nmd, nc): one cuFFT plan (in place on K3's buffer only where
the caller gives it up) and the hand kernel ``noise_transpose``. ``U`` is one (nc, nc) complex matrix (a proportional
spectrum) or an (nmd/2+1, nc, nc) batch; on the card the kernel reads it
packed (``pack_factor``), made once per bath (``Factors``). The draw
depends on (seed, stream, trajectory, element) only, never on the
window, so chunks of an ensemble draw bitwise the numbers of the whole.

K3b draws the thermal start's phases u (hi-lo, n) on the same schedule
and writes c = am cos(2 pi u) and s = -hw am sin(2 pi u) as one
(2, hi-lo, n) tensor.

On CUDA tensors ``noise_halfspectrum``, ``c2r_series``, ``transpose``
and ``thermal_amplitudes`` launch the kernels (float32 and complex64 only;
float64 raises, and so does a failed build, plan or launch); on CPU
tensors they run the plain twins, which draw the same integers through
``ops.philox``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sclmd_tpu_torch.kernels import build
from sclmd_tpu_torch.ops import philox

launches = 0          # noise_synth (K3) launches, not twin calls
launches_init = 0     # init_draw (K3b) launches
launches_transpose = 0   # noise_transpose launches (the series' layout)
launches_batch = 0    # of ``launches``: those on the per-frequency route

BN = 24               # NS_BN in csrc/noise_synth.cu: columns per tile
LDX = BN + 4          # NS_LDX: floats per column pair row of a draw tile
WARPS = 24            # NS_MAX_THREADS / 32: a CTA's warps (85 registers)
MAX_CONSUMER_WARPS = 20
MAX_THREADS = 32 * WARPS
C2R_FLOATS = 1 << 23  # a C2R execution's output: 32 MB
SMEM_LIMIT = 227 * 1024


def reset_count():
    global launches, launches_init, launches_transpose, launches_batch
    launches = launches_init = launches_transpose = launches_batch = 0


def padded_width(nc: int) -> int:
    """nc zero-padded to the mma's k of 8 (90 -> 96, 150 -> 152,
    37 -> 40): each 8 channels make one 16-row tile, real rows then
    imaginary rows."""
    return -(-nc // 8) * 8


def row_stride(ncp: int) -> int:
    """Floats per row of the packed U: = 8 or 24 mod 32, so the 8-byte
    fragment loads of eight rows fall in distinct banks."""
    return ncp if ncp % 32 in (8, 24) else ncp + 8


def launch_plan(nc: int, ntraj: int, h: int, batch: bool, nsm: int,
                cw: int = None) -> dict:
    """Warps, shared memory and grid of a K3 launch (pure; no card
    needed).

    A CTA has WARPS warps: ``cw`` consumer warps, one per m-tile of U's
    2 ncp rows (each walks m-tiles cw, cw + CW, .. where there are more
    than MAX_CONSUMER_WARPS), the rest producers.
    U is staged in
    shared memory (``a_smem``) where it fits beside two draw tiles. The
    proportional path runs one persistent CTA per SM over every
    (frequency, trajectory) column, the batch path one CTA per frequency
    over its trajectories. ``cw`` forces fewer consumer warps (tests):
    every plan sums each output over k in the same order, so every shape
    writes the same bits."""
    ncp = padded_width(nc)
    lda = row_stride(ncp)
    m16 = ncp // 8
    want = MAX_CONSUMER_WARPS if cw is None else cw
    cw = max(1, min(m16, MAX_CONSUMER_WARPS, want))
    x_bytes = 4 * 2 * ncp * LDX
    a_bytes = 4 * 2 * ncp * lda
    a_smem = a_bytes + x_bytes <= SMEM_LIMIT
    smem = (a_bytes if a_smem else 0) + x_bytes
    if smem > SMEM_LIMIT:
        raise ValueError(f"noise_synth: nc {nc} too wide for two draw "
                         "tiles in shared memory")
    cols = ntraj if batch else h * ntraj
    ntiles = -(-cols // BN)
    return {"ncp": ncp, "lda": lda, "cw": cw, "pw": WARPS - cw,
            "threads": MAX_THREADS, "a_smem": a_smem, "smem_bytes": smem,
            "tiles": ntiles, "grid": h if batch else min(ntiles, nsm)}


def _kperm(ncp: int) -> torch.Tensor:
    """Column k of U goes to (k & ~7) + 2 (k & 3) + ((k >> 2) & 1): the
    k and k + 4 of each 8 side by side."""
    k = torch.arange(ncp)
    return (k & ~7) + 2 * (k & 3) + ((k >> 2) & 1)


def pack_factor(evecs: torch.Tensor) -> torch.Tensor:
    """K3's operand: U (nc, nc) or (h, nc, nc) complex as float32 (nu,
    2 ncp, ``row_stride(ncp)``), nu = 1 or h: rows 16 m .. 16 m + 7 the
    real parts of U's rows 8 m .. 8 m + 7, rows 16 m + 8 .. the imaginary
    parts, column k at ``_kperm``; rows, columns and the row's tail
    zero-padded."""
    ev = evecs if evecs.ndim == 3 else evecs[None]
    nu, nc = ev.shape[0], ev.shape[-1]
    ncp = padded_width(nc)
    rows = torch.zeros((nu, ncp, ncp), dtype=ev.dtype, device=ev.device)
    rows[:, :nc, :nc] = ev
    rows = rows.reshape(nu, ncp // 8, 1, 8, ncp)
    a = torch.cat([rows.real, rows.imag], dim=2).to(torch.float32)
    out = torch.zeros((nu, 2 * ncp, row_stride(ncp)), dtype=torch.float32,
                      device=ev.device)
    out[:, :, _kperm(ncp).to(ev.device)] = a.reshape(nu, 2 * ncp, ncp)
    return out


def pack_factors(evecs: torch.Tensor, std: torch.Tensor) -> tuple:
    """K3's operands of one bath: (``pack_factor(evecs)``, std transposed
    to (nc, h) contiguous, which the producers read along frequency)."""
    return pack_factor(evecs), std.t().contiguous()


class Factors(tuple):
    """One bath's noise factors, a pair (evecs, std) on one device, with
    ``packed``, K3's operands (``pack_factors``), made once where they lie
    on the card in float32 (None elsewhere)."""

    def __new__(cls, evecs: torch.Tensor, std: torch.Tensor):
        self = super().__new__(cls, (evecs, std))
        self.packed = pack_factors(evecs, std) \
            if evecs.device.type == "cuda" and \
            evecs.dtype == torch.complex64 else None
        return self


def draw_plain(std: torch.Tensor, seed: int, stream: int, lo: int,
               hi: int) -> torch.Tensor:
    """The twin's scaled draw std[w, k] z (hi-lo, h, nc) in std's type."""
    h, nc = std.shape
    z = philox.normals(seed, stream, lo, hi, h * nc, std.device)
    return z.reshape(hi - lo, h, nc).to(std.dtype) * std


def halfspectrum_plain(evecs: torch.Tensor, std: torch.Tensor, seed: int,
                       stream: int, lo: int, hi: int,
                       scale: float = 1.0) -> torch.Tensor:
    """Plain torch twin of K3: (hi-lo, nc, h) complex conj(xi) scale, the
    imaginary parts of the first and last frequencies zero."""
    from sclmd_tpu_torch.ops.noise import (drop_edge_imag_,
                                           fold_halfspectrum,
                                           halfspectrum_from_draw)
    return fold_halfspectrum(drop_edge_imag_(halfspectrum_from_draw(
        draw_plain(std, seed, stream, lo, hi), evecs)), scale)


def noise_halfspectrum(evecs: torch.Tensor, std: torch.Tensor, seed: int,
                       stream: int, lo: int, hi: int, scale: float = 1.0,
                       packed: tuple = None) -> torch.Tensor:
    """The schedule's folded half spectrum of trajectories [lo, hi): the
    kernel for CUDA tensors (``packed``: the factors' ``pack_factors``,
    made here when not given), the twin for CPU tensors."""
    if evecs.device.type == "cpu" and std.device.type == "cpu":
        return halfspectrum_plain(evecs, std, seed, stream, lo, hi, scale)
    return noise_halfspectrum_cuda(evecs, std, seed, stream, lo, hi, scale,
                                   packed=packed)


class _NsArgs(ctypes.Structure):
    _fields_ = [("A", ctypes.c_void_p), ("std_t", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("ntraj", ctypes.c_int), ("h", ctypes.c_int),
                ("nc", ctypes.c_int), ("ncp", ctypes.c_int),
                ("lda", ctypes.c_int),
                ("batch", ctypes.c_int), ("draw_only", ctypes.c_int),
                ("lo", ctypes.c_uint), ("k0", ctypes.c_uint),
                ("k1", ctypes.c_uint), ("scale", ctypes.c_float),
                ("pw", ctypes.c_int), ("cw", ctypes.c_int),
                ("grid", ctypes.c_int),
                ("a_smem", ctypes.c_int), ("smem_bytes", ctypes.c_int)]


def _check_window(lo: int, hi: int, n: int, who: str):
    if not 0 <= lo < hi or hi > 2 ** 32 or n >= 2 ** 31:
        raise ValueError(f"{who}: window [{lo}, {hi}) of {n} elements is "
                         "outside the schedule's 32-bit counters")


def _check_tiles(lib):
    bn, ldx = ctypes.c_int(), ctypes.c_int()
    if (lib.noise_synth_tiles(ctypes.byref(bn), ctypes.byref(ldx)),
            bn.value, ldx.value) != (MAX_THREADS, BN, LDX):
        raise RuntimeError("noise_synth: tile constants differ from the "
                           "kernel's")


def noise_halfspectrum_cuda(evecs: torch.Tensor, std: torch.Tensor,
                            seed: int, stream: int, lo: int, hi: int,
                            scale: float = 1.0, draw_only: bool = False,
                            plan: dict = None,
                            packed: tuple = None) -> torch.Tensor:
    """K3 on the card. ``draw_only``: the scaled draw std z (hi-lo, h, nc)
    float32 instead of the product (the check of the kernel's normals);
    ``plan`` overrides ``launch_plan`` (tests of other launch shapes)."""
    global launches, launches_batch
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
    if (hi - lo) * h * nc >= 2 ** 31:
        raise ValueError("noise_synth: more than 2^31 outputs in one call")
    a_op, std_t = pack_factors(evecs, std) if packed is None else packed
    ncp = padded_width(nc)
    if a_op.shape != (h if batch else 1, 2 * ncp, row_stride(ncp)) or \
            std_t.shape != (nc, h) or any(
                x.dtype != torch.float32 or x.device != dev or
                not x.is_contiguous() for x in (a_op, std_t)):
        raise ValueError("noise_synth: packed operands do not match the "
                         "factors (make them with pack_factors)")
    lib = build.load()
    _check_tiles(lib)
    if plan is None:
        nsm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = launch_plan(nc, hi - lo, h, batch, nsm)
    if draw_only:
        out = torch.empty((hi - lo, h, nc), dtype=torch.float32, device=dev)
    else:
        out = spectrum_buffer((hi - lo, nc, h), dev)
    k0, k1 = philox.stream_key(seed, stream)
    a = _NsArgs(a_op.data_ptr(), std_t.data_ptr(), out.data_ptr(), hi - lo,
                h, nc, plan["ncp"], plan["lda"], int(batch), int(draw_only),
                lo, k0, k1, scale, plan["pw"], plan["cw"], plan["grid"],
                int(plan["a_smem"]), plan["smem_bytes"])
    rc = lib.noise_synth_f32(ctypes.byref(a), build.current_stream(dev))
    build.check(rc, "noise_synth")
    launches += 1
    launches_batch += int(batch)
    return out


def c2r_plain(y: torch.Tensor, nmd: int) -> torch.Tensor:
    """Twin of the C2R stage: the real series (..., nmd, nc) of a folded
    half spectrum (..., nc, h), irfft along the last axis with no
    normalisation, then the last two axes swapped."""
    return transpose_plain(torch.fft.irfft(y, n=nmd, dim=-1, norm="forward"))


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Twin of ``noise_transpose``: (..., r, c) -> (..., c, r)
    contiguous."""
    return x.transpose(-1, -2).contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """(..., r, c) -> (..., c, r) contiguous: the hand kernel
    ``noise_transpose`` on the card (float32), the twin on the CPU."""
    global launches_transpose
    if x.device.type == "cpu":
        return transpose_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.ndim < 2:
        raise TypeError(f"noise_transpose: the kernel takes a contiguous "
                        f"float32 tensor (got {x.dtype}, {tuple(x.shape)})")
    r, c = x.shape[-2:]
    out = torch.empty(x.shape[:-2] + (c, r), dtype=x.dtype, device=x.device)
    nb = x.numel() // max(r * c, 1)
    lib = build.load()
    src, dst = x.reshape(nb, r, c), out.reshape(nb, c, r)
    for b0 in range(0, nb, 65535):          # the grid's z limit
        b1 = min(nb, b0 + 65535)
        rc = lib.noise_transpose_f32(src[b0].data_ptr(), dst[b0].data_ptr(),
                                     b1 - b0, r, c,
                                     build.current_stream(x.device))
        build.check(rc, "noise_transpose")
        launches_transpose += 1
    return out


def c2r_batch(nmd: int) -> int:
    """Transforms per C2R execution: a fixed count for each nmd (~32 MB of
    output). cuFFT picks its kernel by the batch it is planned for (at
    nmd 256, a 64-trajectory chunk and a 256-trajectory one got different
    kernels and bits), so every call runs the one plan of this batch over
    whole batches, and a trajectory's series does not depend on its
    chunk."""
    return max(1, C2R_FLOATS // nmd)


def spectrum_buffer(shape, device) -> torch.Tensor:
    """An empty complex64 half spectrum of ``shape`` (..., nc, h) whose
    storage runs on to whole C2R batches (``c2r_series`` transforms the
    tail too, and drops it). Marked as scratch: ``c2r_series(...,
    consume=True)`` may run cuFFT on it in place."""
    h = shape[-1]
    nb = 1
    for d in shape[:-1]:
        nb *= d
    b0 = c2r_batch(2 * (h - 1))
    store = torch.empty((-(-nb // b0) * b0 * h,), dtype=torch.complex64,
                        device=device)
    out = store[:nb * h].view(shape)
    out._c2r_scratch = True
    return out


def c2r_series(y: torch.Tensor, nmd: int,
               consume: bool = False) -> torch.Tensor:
    """The series (..., nmd, nc) of a folded half spectrum y (..., nc, h):
    on the card the B = numel / h contiguous transforms go through one
    cuFFT C2R plan of ``c2r_batch(nmd)`` transforms, executed over whole
    batches, written (..., nc, nmd), then the hand kernel
    ``noise_transpose``. cuFFT's C2R uses its input (and the batches'
    tail past it) as scratch, so it runs on a copy of y in a
    ``spectrum_buffer`` and y stays as it was; ``consume``: y is such a
    buffer (K3's output) that the caller gives up, transformed in place.
    ``c2r_plain`` on the CPU."""
    if y.device.type == "cpu":
        return c2r_plain(y, nmd)
    if y.dtype != torch.complex64:
        raise TypeError(f"noise_c2r: the card path takes complex64 (got "
                        f"{y.dtype}); a float64 run stays on the CPU")
    h = nmd // 2 + 1
    if nmd % 2 or y.shape[-1] != h or y.ndim < 2:
        raise ValueError(f"noise_c2r: want a (..., nc, {h}) half spectrum, "
                         f"got {tuple(y.shape)}")
    if not (consume and getattr(y, "_c2r_scratch", False)):
        y = spectrum_buffer(y.shape, y.device).copy_(y)
    nb = y.numel() // h
    b0 = c2r_batch(nmd)
    nexec = -(-nb // b0)
    lib = build.load()
    work = ctypes.c_size_t()
    build.check(lib.noise_c2r_plan(nmd, b0, ctypes.byref(work)),
                "noise_c2r plan")
    ws = torch.empty((work.value,), dtype=torch.uint8, device=y.device) \
        if work.value else None
    x = torch.empty((nexec * b0 * nmd,), dtype=torch.float32, device=y.device)
    stream = build.current_stream(y.device)
    for e in range(nexec):
        rc = lib.noise_c2r_f32(y.data_ptr() + 8 * e * b0 * h,
                               x.data_ptr() + 4 * e * b0 * nmd, nmd, b0,
                               None if ws is None else ws.data_ptr(), stream)
        build.check(rc, "noise_c2r")
    return transpose(x[:nb * nmd].view(tuple(y.shape[:-1]) + (nmd,)))


def amplitudes_of(u: torch.Tensor, am: torch.Tensor,
                  hw: torch.Tensor) -> torch.Tensor:
    """(2, ..., n): am cos(2 pi u) and -hw am sin(2 pi u), in u's type."""
    return torch.stack([am * torch.cos(2 * np.pi * u),
                        -(hw * am * torch.sin(2 * np.pi * u))])


def thermal_amplitudes_plain(seed: int, stream: int, lo: int, hi: int,
                             am: torch.Tensor,
                             hw: torch.Tensor) -> torch.Tensor:
    """K3b's twin: the schedule's uniforms, then ``amplitudes_of``, in
    am's type and on its device."""
    u = philox.uniforms(seed, stream, lo, hi, am.numel(), am.device,
                        am.dtype)
    return amplitudes_of(u, am, hw)


def thermal_amplitudes(seed: int, stream: int, lo: int, hi: int,
                       am: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """(2, hi-lo, n) thermal-start amplitudes of the schedule's stream:
    K3b on the card (float32 only), the twin on the CPU."""
    if am.device.type == "cpu":
        return thermal_amplitudes_plain(seed, stream, lo, hi, am, hw)
    return _init_draw(seed, stream, lo, hi, am.numel(), am.device, am, hw)


def init_uniforms_cuda(seed: int, stream: int, lo: int, hi: int, n: int,
                       device, dtype=torch.float32) -> torch.Tensor:
    """K3b writing the uniforms themselves (the check of its integers)."""
    if dtype != torch.float32:
        raise TypeError(f"init_draw: the kernel writes float32 (got {dtype}); "
                        "a float64 run stays on the CPU")
    return _init_draw(seed, stream, lo, hi, n, torch.device(device))


def _init_draw(seed, stream, lo, hi, n, device, am=None, hw=None):
    global launches_init
    if device.type != "cuda":
        raise ValueError("init_draw: the kernel writes a CUDA tensor")
    if am is not None and (am.dtype != torch.float32 or
                           hw.dtype != torch.float32):
        raise TypeError(f"init_draw: the kernel takes float32 amplitudes "
                        f"(got {am.dtype}, {hw.dtype}); a float64 run stays "
                        "on the CPU")
    if am is not None and (am.shape != (n,) or hw.shape != (n,) or
                           hw.device != device):
        raise ValueError("init_draw: am and hw must be (n,) on the card")
    _check_window(lo, hi, n, "init_draw")
    lib = build.load()
    shape = (hi - lo, n) if am is None else (2, hi - lo, n)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    k0, k1 = philox.stream_key(seed, stream)
    rc = lib.init_draw_f32(
        out.data_ptr(), None if am is None else am.contiguous().data_ptr(),
        None if hw is None else hw.contiguous().data_ptr(), hi - lo, n, lo,
        k0, k1, build.current_stream(device))
    build.check(rc, "init_draw")
    launches_init += 1
    return out


def work_counts(nc: int, h: int, ntraj: int, nu: int) -> dict:
    """What one K3 call must do: the products (4 nc^2 per column, as
    float32 operations; three TF32 products each on the tensor cores)
    and the bytes (U and std read once, the half spectrum written
    once)."""
    return {"flops": 4 * nc * nc * h * ntraj,
            "bytes": nu * nc * nc * 8 + h * nc * 4 + ntraj * h * nc * 8}


def c2r_bytes(nmd: int, ntraj: int, nc: int) -> int:
    """The C2R stage's least traffic: the half spectrum read once and the
    (ntraj, nmd, nc) series written once."""
    return ntraj * nc * ((nmd // 2 + 1) * 8 + nmd * 4)
