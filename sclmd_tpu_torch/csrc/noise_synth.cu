// K3 — noise_synth: colored-noise synthesis in the frequency domain, with
// the Gaussian draw made inside the kernel (float32, complex64 out,
// sm_90a). For one bath and the trajectories [lo, lo + ntraj) of an
// ensemble:
//
//   xi[t, w, i] = sum_k U(w)[i, k] * std[w, k] * z(j = lo + t, e = w nc + k)
//
// for w in [0, nmd/2], written as the half spectrum (ntraj, nmd/2+1, nc),
// with the imaginary parts of rows 0 and nmd/2 written as zero: the real
// series does not keep them, and cuFFT's C2R transform does not drop
// them (it gave a series 2 % off where they were not zero).
// The series is then torch.fft.hfft(xi, n=nmd, dim=-2) / (nmd dt): the
// C2R transform (cuFFT) stays outside, as the JAX package leaves its FFT
// to XLA. U(w) is one (nc, nc) matrix for a proportional spectrum or an
// (nmd/2+1, nc, nc) batch.
//
// K3b — init_draw: the uniform phases (ntraj, n) of the thermal start,
// from the same Philox function.
//
// Replaces: sclmd_tpu/ops/noise.py:186 sample_noise_parts and :205
// sample_noise_prop, vmapped per bath in _fused_chunk
// (sclmd_tpu/parallel/ensemble.py:892-899), and the draw of
// sclmd_tpu/md.py:120 thermal_init. Never Pallas: XLA fused them.
//
// The draw z is Philox4x32-10 (Random123), keyed by two words hashed from
// the ensemble seed and the stream, counter (e / 4, 0, j, 0); Box-Muller
// on the words' pairs. The schedule is written out in
// sclmd_tpu_torch/ops/philox.py, whose plain twin draws the same integers.
// A draw depends on (seed, stream, j, e) only, so a chunk of trajectories
// gets bitwise the numbers of the whole ensemble, and no draw is written
// to device memory.
//
// What bounds it on the H100: 4 nc^2 operations per (trajectory,
// frequency) row (a complex-by-real product, two FMAs per term) against
// 8 nc bytes written: at nc 90-150 about 45-75 FLOP a byte, above the
// card's ~20 for float32 outside the tensor cores, so the float32 pipes
// bound it (the flagship's 1024 chunk: 4.7e10 FLOP, 0.7 ms at 67 TFLOP/s,
// against 0.63 GB written, 0.19 ms). The Philox draw and Box-Muller add
// about 30 instructions a normal against 2 nc FMAs that use it. Design:
// * a CTA stages U(w) (one frequency: the batch path) or U (the
//   proportional path, once for the frequencies the CTA walks over)
//   transposed in shared memory, 65 KB at nc 90, 180 KB at nc 150, so a
//   thread's loads of U[k, i] over i are conflict-free; where U does not
//   fit beside the draws, the kernel reads it from global memory (L1/L2);
// * a tile of TT trajectories draws its (nc, TT) scaled normals into
//   shared memory (t fastest), then each thread accumulates one output
//   channel for NS_R trajectories: per k one U load, two float4 loads of
//   the draws (a broadcast within the warp), 2 NS_R FMAs, in float32;
// * the tile holds as many groups of NS_R trajectories as the call has,
//   up to NS_MAX_THREADS threads and what shared memory holds beside U:
//   one staged (150, 150) U leaves an SM one CTA, so that CTA is made
//   wide (4 groups, 600 threads) rather than one group of 150 threads;
// * the batch path launches a CTA per frequency and walks it over every
//   tile of the call: each U(w) is read from HBM once per call.
// Outputs go from the accumulators to global memory, one 8-byte store
// per (t, w, i), coalesced over i.

#include <cuda_runtime.h>
#include <stdint.h>

#define NS_R 8                // trajectories a thread accumulates
#define NS_MAX_CI 256         // channels a pass of the CTA covers
#define NS_MAX_THREADS 640    // launch bound: up to 102 registers a thread
#define NS_SMEM_LIMIT (227 * 1024)

struct NsArgs {
  const float* U;      // complex64 pairs: (nu, nc, nc), nu = 1 or h
  const float* std;    // (h, nc)
  float* out;          // (ntraj, h, nc) complex64 pairs, or the draw (float)
  int ntraj, h, nc;
  int batch;           // U per frequency
  int draw_only;       // write std * z as (ntraj, h, nc) float32
  unsigned lo, k0, k1;
  int groups;          // trajectory groups of NS_R: TT = groups * NS_R
  int ci;              // channels per pass (threads = groups * ci)
  int grid;            // CTAs
  int smem_u;          // U in shared memory
  int smem_bytes;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// ((x >> 8) | 1) * 2^-24: exact in float32, in [2^-24, 1 - 2^-24]
__device__ __forceinline__ float ns_uniform(unsigned x) {
  return __uint2float_rn((x >> 8) | 1u) * 5.9604644775390625e-8f;
}

__device__ __forceinline__ float4 ns_normals(uint4 w) {
  const float r01 = sqrtf(-2.f * logf(ns_uniform(w.x)));
  const float r23 = sqrtf(-2.f * logf(ns_uniform(w.z)));
  float s1, c1, s3, c3;
  sincospif(2.f * ns_uniform(w.y), &s1, &c1);
  sincospif(2.f * ns_uniform(w.w), &s3, &c3);
  return make_float4(r01 * c1, r01 * s1, r23 * c3, r23 * s3);
}

template <bool SU>
__global__ void __launch_bounds__(NS_MAX_THREADS)
    noise_synth_kernel(const NsArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int nc = a.nc, h = a.h;
  const int tt = a.groups * NS_R;
  float* xs = smem;                                  // (nc, tt)
  float2* su = reinterpret_cast<float2*>(smem + tt * nc);   // (nc, nc)^T
  const float2* gU = reinterpret_cast<const float2*>(a.U);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int g = tid / a.ci, i0 = tid % a.ci;
  const int ntiles = (a.ntraj + tt - 1) / tt;

  if (SU && !a.batch) {
    for (int idx = tid; idx < nc * nc; idx += nth)
      su[(idx % nc) * nc + idx / nc] = gU[idx];
  }
  for (int w = blockIdx.x; w < h; w += gridDim.x) {
    const float2* uw = gU + (a.batch ? (size_t)w * nc * nc : 0);
    if (SU && a.batch) {
      __syncthreads();   // the previous frequency's products are done
      for (int idx = tid; idx < nc * nc; idx += nth)
        su[(idx % nc) * nc + idx / nc] = uw[idx];
    }
    const float* sw = a.std + (size_t)w * nc;
    const unsigned e0 = (unsigned)w * nc;
    const unsigned b0 = e0 >> 2;
    const int nbk = (int)(((e0 + nc - 1) >> 2) - b0) + 1;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int t0 = tile * tt;
      __syncthreads();   // xs is free (and U staged)
      for (int it = tid; it < tt * nbk; it += nth) {
        const int t = it % tt;
        const unsigned b = b0 + it / tt;
        const float4 z = ns_normals(
            philox4x32_10(make_uint4(b, 0u, a.lo + t0 + t, 0u), a.k0, a.k1));
        const float zz[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = (int)(4 * b + m) - (int)e0;
          if (k >= 0 && k < nc) xs[k * tt + t] = sw[k] * zz[m];
        }
      }
      __syncthreads();
      if (a.draw_only) {
        for (int it = tid; it < tt * nc; it += nth) {
          const int t = it / nc, k = it % nc;
          if (t0 + t < a.ntraj)
            a.out[((size_t)(t0 + t) * h + w) * nc + k] = xs[k * tt + t];
        }
        continue;
      }
      for (int i = i0; i < nc; i += a.ci) {
        float re[NS_R], im[NS_R];
#pragma unroll
        for (int r = 0; r < NS_R; ++r) re[r] = im[r] = 0.f;
        const float* xg = xs + g * NS_R;
        for (int k = 0; k < nc; ++k) {
          const float2 u = SU ? su[k * nc + i] : __ldg(uw + (size_t)i * nc + k);
          const float4 x0 = *reinterpret_cast<const float4*>(xg + k * tt);
          const float4 x1 = *reinterpret_cast<const float4*>(xg + k * tt + 4);
          const float xv[NS_R] = {x0.x, x0.y, x0.z, x0.w,
                                  x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int r = 0; r < NS_R; ++r) {
            re[r] = fmaf(u.x, xv[r], re[r]);
            im[r] = fmaf(u.y, xv[r], im[r]);
          }
        }
        float2* o = reinterpret_cast<float2*>(a.out);
        const bool edge = w == 0 || w == h - 1;   // DC and Nyquist rows
#pragma unroll
        for (int r = 0; r < NS_R; ++r) {
          const int t = t0 + g * NS_R + r;
          if (t < a.ntraj)
            o[((size_t)t * h + w) * nc + i] =
                make_float2(re[r], edge ? 0.f : im[r]);
        }
      }
    }
  }
}

__global__ void init_draw_kernel(float* out, int ntraj, int n, unsigned lo,
                                 unsigned k0, unsigned k1) {
  const int nblk = (n + 3) / 4;
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long long)ntraj * nblk) return;
  const int j = (int)(item / nblk), b = (int)(item % nblk);
  const uint4 x = philox4x32_10(make_uint4((unsigned)b, 0u, lo + j, 0u), k0, k1);
  const unsigned ws[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = 4 * b + m;
    if (i < n) out[(size_t)j * n + i] = ns_uniform(ws[m]);
  }
}

extern "C" int noise_synth_r() { return NS_R; }

extern "C" int noise_synth_f32(const NsArgs* a, void* stream) {
  if (a->ntraj < 1 || a->h < 1 || a->nc < 1 || a->groups < 1 || a->ci < 1 ||
      a->grid < 1 || a->groups * a->ci > NS_MAX_THREADS ||
      a->smem_bytes > NS_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = a->groups * a->ci;
  cudaError_t err;
  if (a->smem_u) {
    err = cudaFuncSetAttribute(noise_synth_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
    noise_synth_kernel<true><<<a->grid, threads, a->smem_bytes, st>>>(*a);
  } else {
    err = cudaFuncSetAttribute(noise_synth_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
    noise_synth_kernel<false><<<a->grid, threads, a->smem_bytes, st>>>(*a);
  }
  return (int)cudaGetLastError();
}

extern "C" int init_draw_f32(void* out, int ntraj, int n, unsigned lo,
                             unsigned k0, unsigned k1, void* stream) {
  if (ntraj < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long items = (long long)ntraj * ((n + 3) / 4);
  const int threads = 256;
  const long long blocks = (items + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  init_draw_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)out, ntraj, n, lo, k0, k1);
  return (int)cudaGetLastError();
}
