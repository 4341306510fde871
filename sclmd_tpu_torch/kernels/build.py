"""Build and load the port's CUDA kernels.

Every ``sclmd_tpu_torch/csrc/*.cu`` file has a plain C interface. Each
is compiled by its own ``nvcc`` for Hopper (``sm_90a``), all started
together, and the objects are linked into ONE shared library loaded
with ``ctypes``; the library links the toolkit's cuFFT, which K3's C2R
transform calls (``csrc/noise_synth.cu``). The build runs at first use,
never at import,
into ``sclmd_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
sources and flags, so an unchanged tree reuses its library and an edited
one rebuilds. The compiler's ``-Xptxas -v`` report (registers, shared
memory, spills per kernel) is kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_LIBS = ["-lcufft"]

_lib = None
build_seconds = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_LIBS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsclmd_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source hash has no library yet;
    returns the library path."""
    global build_seconds
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cu = [p for p in sources() if p.endswith(".cu")]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, os.path.basename(p)[:-3] + ".o")
                for p in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, p]
                for p, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [" ".join(c) + "\n" + pr.communicate()[0]
                for c, pr in zip(cmds, procs)]
        log = "".join(logs)
        if any(pr.returncode != 0 for pr in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp = os.path.join(tmpdir, "lib.so")
        cuda_lib = os.path.join(os.path.dirname(os.path.dirname(nvcc)),
                                "lib64")
        link = [nvcc, "-shared", "-o", tmp, *objs, *LINK_LIBS, "-Xlinker",
                "-rpath=" + cuda_lib]
        res = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
        build_seconds = time.perf_counter() - t0
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)      # atomic: a concurrent loader sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.block_corr_freq_f32.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.block_corr_freq_f32.restype = ci
    lib.block_corr_freq_max_nc.argtypes = []
    lib.block_corr_freq_max_nc.restype = ci
    lib.gle_near_f32.argtypes = [vp, vp]
    lib.gle_near_f32.restype = ci
    lib.gle_near_smem_bytes.argtypes = [ci, ci, ci, ci, ci]
    lib.gle_near_smem_bytes.restype = ci
    lib.gle_far_f32.argtypes = [vp, vp]
    lib.gle_far_f32.restype = ci
    lib.conv_tails_f32.argtypes = [vp, vp]
    lib.conv_tails_f32.restype = ci
    lib.conv_tails_rows.argtypes = []
    lib.conv_tails_rows.restype = ci
    lib.bath_force_f32.argtypes = [vp, vp]
    lib.bath_force_f32.restype = ci
    lib.bath_force_threads.argtypes = []
    lib.bath_force_threads.restype = ci
    lib.bath_force_noop.argtypes = [vp]
    lib.bath_force_noop.restype = ci
    lib.ch_force_f32.argtypes = [vp, vp]
    lib.ch_force_f32.restype = ci
    lib.ch_force_max_threads.argtypes = []
    lib.ch_force_max_threads.restype = ci
    lib.ch_force_max_groups.argtypes = []
    lib.ch_force_max_groups.restype = ci
    lib.ch_force_trace_len.argtypes = []
    lib.ch_force_trace_len.restype = ci
    for name in ("sw_force_f32", "eam_force_f32"):
        getattr(lib, name).argtypes = [vp, vp]
        getattr(lib, name).restype = ci
    cu = ctypes.c_uint
    ip, ll = ctypes.POINTER(ci), ctypes.c_longlong
    lib.noise_synth_tiles.argtypes = [ip, ip]
    lib.noise_synth_tiles.restype = ci
    lib.noise_synth_f32.argtypes = [vp, vp]
    lib.noise_synth_f32.restype = ci
    lib.init_draw_f32.argtypes = [vp, vp, vp, ci, ci, cu, cu, cu, vp]
    lib.init_draw_f32.restype = ci
    lib.noise_c2r_plan.argtypes = [ci, ll, ctypes.POINTER(ctypes.c_size_t)]
    lib.noise_c2r_plan.restype = ci
    lib.noise_c2r_f32.argtypes = [vp, vp, ci, ll, vp, vp]
    lib.noise_c2r_f32.restype = ci
    lib.noise_transpose_f32.argtypes = [vp, vp, ci, ci, ci, vp]
    lib.noise_transpose_f32.restype = ci
    _lib = lib
    return lib


def current_stream(device) -> int:
    """The address of the CUDA stream PyTorch now works on for
    ``device``, read at each launch (a kernel goes where the caller's
    other work goes, inside ``torch.cuda.stream`` blocks too)."""
    import torch
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(rc: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
