"""Times of noise synthesis and of the thermal start on the card, stage
by stage, at the main path's shapes.

    python -m sclmd_tpu_torch.tools.noise_bench [--reps 10] [--label L]
        [--sweep] [--out FILE]

Needs a CUDA card. An A/B against another commit runs that commit's
own copy of this tool from a ``git archive`` of it, in turns with this
tree's run, in one call.

Prints the card's name and power limit and one JSON line per case, then
the whole record (also written to ``--out``). Noise cases (the primary
junction's chunks of 256 and 512 trajectories, the harmonic flagship's of
128 and 1024, the periodic sheet's 128, md.Run's one-trajectory window,
and a per-frequency batch of a random PSD, (1025, 90, 90), at 256 and
512 trajectories):

* ``k3_ms``: K3 alone (CUDA events, mean of ``--reps`` calls after a
  warm-up), ``k3_device_ms`` its device time from the profiler, beside
  ``bound_ms`` (3xTF32 on the tensor cores: three TF32 products per
  float32 product at 495 TFLOP/s, or the bytes at 3.35 TB/s; on the
  float32 pipes, 67 TFLOP/s, in ``bound_f32_ms``);
* ``c2r_ms``: the transform stage on K3's output (events), ``series_ms``:
  the whole ``ops.noise.schedule_noise``, ``library_ms``: ``torch.randn``
  x std, ``torch.matmul`` (``torch.einsum`` for a batch), and ``hfft`` /
  (nmd dt) made contiguous (no single PyTorch call computes K3's
  function);
* ``trace``: every device kernel, copy and memset of one
  ``schedule_noise`` call (profiler, name, device microseconds), in order;
* with ``--sweep``: K3 at several numbers of consumer warps up to its
  plan's, each held bitwise against the plan's.

``--invariance`` instead checks, over nc and nmd,
whether a trajectory's K3 output, C2R output and series are bitwise the
same from a window of 256 trajectories and one of 64.

Thermal-start cases (the flagship's 128 and 1024, the primary's 512):
``k3b_ms`` / ``k3b_device_ms`` (events / profiler) of the draw kernel,
``start_ms`` the whole start of a window (draw, amplitudes, product,
mask; events), and ``start_host_ms`` the host's time in that call while
~50 ms of other work is queued on the card (a call that copies from
pageable host memory waits for it).

``event_ms`` and ``noise_times`` are also the draw timings of
``tools.plain_bench`` and ``tools.blocked_bench``.
"""

import argparse
import json
import subprocess
import tempfile
import time

import torch

PEAK_F32, PEAK_TF32, PEAK_HBM = 67e12, 495e12, 3.35e12


def event_ms(fn, reps):
    """Milliseconds per call (CUDA events) after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _start(r):
    """(call(lo, hi), K3b call(lo, hi)) of the runner's thermal start."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    system = r._build_system()
    nb = len(r.baths)
    st = r._thermal_start(r.T)
    return (lambda lo, hi: st.states(system, 5, nb, lo, hi),
            lambda lo, hi: K3.thermal_amplitudes(5, nb, lo, hi, st.am, st.hw))


def noise_times(r, n, reps=5) -> dict:
    """Milliseconds (CUDA events) to make one chunk's noise for every
    bath of the runner ``r`` at ``n`` trajectories, thermal start
    included (``draws_ms``: ``parallel.ensemble.draw_chunk``, K3, the C2R
    transforms, K3b and the start's product), and ``k3_ms``, K3 alone
    for the first bath."""
    from sclmd_tpu_torch.parallel import ensemble as E
    facs = E.bath_factors(r.baths, r.device)
    start = r._thermal_start(r.T) if r.dyn is not None else None
    system = r._build_system()
    return {"draws_ms": event_ms(lambda: E.draw_chunk(
        facs, 5, 0, n, r.dt, r.nmd, start, system), reps),
        "k3_ms": event_ms(lambda: _k3(facs[0], 0, n, r.dt, r.nmd), reps)}


def _k3(fac, lo, hi, dt, nmd, **kw):
    from sclmd_tpu_torch.kernels import noise_synth as K3
    ev, std = fac
    return K3.noise_halfspectrum_cuda(ev, std, 5, 0, lo, hi, 1.0 / (nmd * dt),
                                      packed=fac.packed, **kw)


def library_draw_product(ev, std, n):
    """The library's composition of K3's work: ``torch.randn`` x std, then
    ``torch.matmul`` (one matrix) or ``torch.einsum`` (a per-frequency
    batch), as (n, h, nc) xi. Other draws than the schedule's; the same
    shapes and products."""
    h, nc = std.shape
    x = (torch.randn((n, h, nc), device=std.device) * std).to(ev.dtype)
    if ev.ndim == 2:
        return torch.matmul(x, ev.T)
    return torch.einsum("wij,twj->twi", ev, x)


def library_series(ev, std, n, dt, nmd):
    """``library_draw_product``, then the series hfft / (nmd dt) along the
    frequency axis, contiguous."""
    xi = library_draw_product(ev, std, n)
    return (torch.fft.hfft(xi, n=nmd, dim=-2) / (nmd * dt)).contiguous()


def trace_kernels(fn) -> list:
    """Every device kernel, copy and memset of one call of ``fn``, in
    order: (name, device microseconds)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    if not evs:         # a profiler that keeps no per-launch records
        return [[e.key[:90], e.device_time_total]
                for e in prof.key_averages() if e.device_time_total > 0]
    return [[e.name[:90], e.time_range.end - e.time_range.start]
            for e in evs]


def _device_ms(fn, names):
    from sclmd_tpu_torch.tools.plain_bench import device_us
    return 1e-3 * sum(device_us(fn, reps=20, names=names).values())


def noise_case(fac, lo, hi, dt, nmd, reps, sweep) -> dict:
    """The noise stages at one window."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    from sclmd_tpu_torch.ops.noise import schedule_noise
    ev, std = fac
    h, nc = std.shape
    n = hi - lo
    nu = ev.shape[0] if ev.ndim == 3 else 1
    work = K3.work_counts(nc, h, n, nu)
    flops, nbytes = work["flops"], work["bytes"]
    y = _k3(fac, lo, hi, dt, nmd)

    def series():
        return schedule_noise(ev, std, 5, 0, lo, hi, dt, nmd,
                              packed=fac.packed)
    out = {
        "ntraj": n, "nc": nc, "h": h, "factors": "batch" if nu > 1 else
        "one matrix",
        "k3_ms": event_ms(lambda: _k3(fac, lo, hi, dt, nmd), reps),
        "k3_device_ms": _device_ms(lambda: _k3(fac, lo, hi, dt, nmd),
                                   ("noise_synth",)),
        "c2r_ms": event_ms(lambda: K3.c2r_series(y, nmd, consume=True),
                           reps),
        "series_ms": event_ms(series, reps),
        "library_ms": event_ms(lambda: library_series(ev, std, n, dt, nmd),
                               reps),
        "flops": flops, "bytes": nbytes,
        "bound_ms": 1e3 * max(3 * flops / PEAK_TF32, nbytes / PEAK_HBM),
        "bound_f32_ms": 1e3 * max(flops / PEAK_F32, nbytes / PEAK_HBM),
        "c2r_bound_ms": 1e3 * K3.c2r_bytes(nmd, n, nc) / PEAK_HBM,
        "trace": trace_kernels(series),
    }
    out["k3_share_of_bound"] = out["bound_ms"] / out["k3_device_ms"]
    del y
    if sweep:
        nsm = torch.cuda.get_device_properties(
            std.device).multi_processor_count
        batch = ev.ndim == 3
        plan = K3.launch_plan(nc, n, h, batch, nsm)
        ref = _k3(fac, lo, hi, dt, nmd, plan=plan)
        out["plan"] = plan
        out["k3_ms_by_cw"] = {}
        for cw in sorted({4, 8, 12, 16, plan["cw"]}):
            if cw > plan["cw"]:
                continue
            p = K3.launch_plan(nc, n, h, batch, nsm, cw=cw)
            got = _k3(fac, lo, hi, dt, nmd, plan=p)
            if not torch.equal(got, ref):
                raise AssertionError(f"K3 at cw {cw} differs from its plan")
            out["k3_ms_by_cw"][cw] = event_ms(
                lambda: _k3(fac, lo, hi, dt, nmd, plan=p), reps)
    return out


def start_case(r, n, reps) -> dict:
    """The thermal start of an n-trajectory window of the runner ``r``."""
    call, draw = _start(r)
    dev = r.device
    a = torch.randn((4096, 4096), device=dev)
    call(0, n)
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        for _ in range(18):            # ~50 ms of queued work on the card
            a = a @ a
            a /= a.norm()
        t0 = time.perf_counter()
        call(0, n)
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return {"ntraj": n, "nph": r.nph,
            "k3b_ms": event_ms(lambda: draw(0, n), reps),
            "k3b_device_ms": _device_ms(lambda: draw(0, n), ("init_draw",)),
            "start_ms": event_ms(lambda: call(0, n), reps),
            "start_host_ms": host}


def _random_factors(nc, nmd, batch, dev, seed=4):
    """Complex64 factors of a random PSD (``Factors``): one matrix of a
    proportional spectrum, or a per-frequency batch."""
    import numpy as np
    from sclmd_tpu_torch.kernels.noise_synth import Factors
    from sclmd_tpu_torch.ops.noise import factor_matrix, noise_factors
    rng = np.random.default_rng(seed)
    h = nmd // 2 + 1
    if batch:
        psd = np.stack([(lambda m: m @ m.conj().T + nc * np.eye(nc))(
            rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc)))
            for _ in range(h)])
    else:
        m = rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc))
        psd = (np.abs(rng.normal(size=h)) + 0.1)[:, None, None] * \
            (m @ m.conj().T + nc * np.eye(nc))[None]
    ev, std = noise_factors(psd, dtype=np.float32)
    return Factors(torch.as_tensor(factor_matrix(ev), device=dev),
                   torch.as_tensor(std, device=dev))


def invariance_grid(dev) -> list:
    """Whether trajectory 200's series is bitwise the same from the
    windows [0, 256) and [192, 256), over nmd and nc: K3's output, the
    C2R plan's output on it, and the whole ``schedule_noise``, with the
    cuFFT kernels each C2R launches."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    out = []
    for batch, nc, nmd in [(False, 37, 256), (True, 37, 256),
                           (False, 48, 256), (False, 90, 256),
                           (False, 37, 512), (False, 37, 1024),
                           (False, 150, 1024), (False, 37, 2048),
                           (False, 90, 2048), (True, 90, 2048),
                           (False, 150, 16384)]:
        fac = _random_factors(nc, nmd, batch, dev)
        ev, std = fac
        scale = 1.0 / (nmd * 0.38)
        ya = K3.noise_halfspectrum_cuda(ev, std, 9, 1, 0, 256, scale,
                                        packed=fac.packed)
        yb = K3.noise_halfspectrum_cuda(ev, std, 9, 1, 192, 256, scale,
                                        packed=fac.packed)
        k3_same = bool(torch.equal(ya[192:], yb))
        names = {}
        for key, y in (("256", ya), ("64", yb)):
            names[key] = [n for n, _ in trace_kernels(
                lambda: K3.c2r_series(y.clone(), nmd))]
        xa, xb = K3.c2r_series(ya.clone(), nmd), K3.c2r_series(yb.clone(),
                                                               nmd)
        c2r_same = bool(torch.equal(xa[192:], xb))
        c2r_same_from_equal_input = bool(torch.equal(
            K3.c2r_series(ya[192:].clone(), nmd), xb))
        out.append({"batch": batch, "nc": nc, "nmd": nmd,
                    "k3_bitwise": k3_same, "c2r_bitwise": c2r_same,
                    "c2r_window_of_same_input_bitwise":
                    c2r_same_from_equal_input,
                    "max_abs_diff": float((xa[192:] - xb).abs().max()),
                    "c2r_kernels": names})
        print(json.dumps({"invariance": out[-1]}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--invariance", action="store_true",
                    help="only the chunk-invariance grid")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("noise_bench: needs a CUDA device")

    from sclmd_tpu_torch.parallel.ensemble import bath_factors
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools import primary as P
    from sclmd_tpu_torch.tools import sheet as S

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"device": smi, "label": args.label, "noise": {}, "start": {}}
    if args.invariance:
        out["invariance"] = invariance_grid(dev)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return
    pr = P.primary_runner(torch.float32, dev, tempfile.mkdtemp())
    fr = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp())
    sr = S.sheet_runner(torch.float32, dev, tempfile.mkdtemp())
    batch = _random_factors(90, P.NMD, True, dev)
    cases = {"primary_256": (pr, 0, 256), "primary_512": (pr, 0, 512),
             "run_window": (pr, 1, 2), "flagship_128": (fr, 0, 128),
             "flagship_1024": (fr, 0, 1024), "sheet_128": (sr, 0, 128),
             "batch_256": (pr, 0, 256), "batch_512": (pr, 0, 512)}
    for name, (r, lo, hi) in cases.items():
        fac = batch if name.startswith("batch") else \
            bath_factors(r.baths, dev)[0]
        res = noise_case(fac, lo, hi, r.dt, r.nmd, args.reps, args.sweep)
        out["noise"][name] = res
        print(json.dumps({"label": args.label, name: res}), flush=True)
    for name, (r, n) in {"flagship_128": (fr, 128),
                         "flagship_1024": (fr, 1024),
                         "primary_512": (pr, 512)}.items():
        res = start_case(r, n, args.reps)
        out["start"][name] = res
        print(json.dumps({"label": args.label, "start_" + name: res}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
