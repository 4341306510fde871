// K6 — conv_tails: the memory-kernel tails of the plain GLE step, for every
// non-local phonon bath (ml > 2) and trajectory (float32, sm_90a).
//
//   tails[t][a][0] = sum_{r=2}^{ml-1} sum_b K[r][a][b] old_t[r-1][b]
//   tails[t][a][1] = sum_{r=2}^{ml-1} sum_b K[r][a][b] old_t[r-2][b]
//   old_t[i][b]    = ring[t][(head + i) % mlr][cids[b]]
//
// Replaces: the Pallas kernel memory_conv_tails
// (a5170d2:sclmd_tpu/ops/kernels.py:127, a pallas_call through conv_matmul
// at :72), whose live successor is PhBath.step_plan
// (sclmd_tpu/baths.py:548-557).
//
// What bounds it on the H100: the kernel slab K[2..ml-1], (ml-2) nc^2
// floats (32.4 MB per bath at nc 90, ml 1000), is read once per step and
// used for two FMAs per element and trajectory; two such baths (64.8 MB)
// exceed the 50 MB L2, so every step streams the slab from HBM. For one
// trajectory (md.Run) the work is a GEMV: 90 output rows alone would leave
// most SMs idle, so the taps are split over many CTAs (CT_TAPS taps each,
// ~125 CTAs per bath at ml 1000), and each lane issues the loads of all
// its column chunks for all CT_TAPS taps (up to CT_BCH x CT_TAPS) before
// using them, so enough bytes are in flight to stream from HBM. A second
// pass sums the per-split partials, a warp per output in a fixed lane
// order: no float atomics, so a run is reproducible bit for bit.
//
// Layout. A warp owns output rows a; its lanes walk b along K[r][a][:]
// (coalesced), 32 CT_BCH columns at a time. The CTA stages the CT_TAPS+1
// history rows its taps need, for its TT trajectories, in shared memory;
// the predictor reads row jj = u+1 and the corrector row jj = u for tap
// r = r0+u (the corrector's history is the predictor's shifted by one
// tap).

#include <cuda_runtime.h>

#define CT_MAX_BATHS 4
#define CT_THREADS 256
#define CT_TAPS 8
#define CT_BCH 4     // column chunks of 32 whose loads a lane keeps in flight

struct CtBath {
  const float* K;      // (ml, nc, nc), K[r][a][b]
  const int* cids;     // (nc,)
  float* part;         // (nsplit, ntraj, nc, 2) per-split partial sums
  float* out;          // (ntraj, nc, 2)
  int nc, ml, nsplit, split0;
};

struct CtArgs {
  const float* ring;   // (ntraj, mlr, nph)
  int ntraj, mlr, nph, head, nb, nsplit, tt;
  CtBath baths[CT_MAX_BATHS];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int TT>
__global__ void __launch_bounds__(CT_THREADS)
conv_tails_partial(const CtArgs a) {
  extern __shared__ float H[];  // [TT][CT_TAPS + 1][nc]
  const int split = blockIdx.x;
  int bi = 0;
  while (bi + 1 < a.nb && split >= a.baths[bi + 1].split0) ++bi;
  const CtBath& B = a.baths[bi];
  const int nc = B.nc, s = split - B.split0;
  const int r0 = 2 + s * CT_TAPS;
  const int r1 = min(B.ml, r0 + CT_TAPS);
  const int nr = r1 - r0 + 1;       // history rows r0-2 .. r1-2
  const int tr0 = blockIdx.y * TT;
  const int ntt = min(TT, a.ntraj - tr0);
  const int rows = CT_TAPS + 1;

  for (int i = threadIdx.x; i < TT * rows * nc; i += CT_THREADS) {
    const int t = i / (rows * nc), jj = (i / nc) % rows, b = i % nc;
    float v = 0.f;
    if (t < ntt && jj < nr) {
      const int row = (a.head + r0 - 2 + jj) % a.mlr;
      v = a.ring[((size_t)(tr0 + t) * a.mlr + row) * a.nph + B.cids[b]];
    }
    H[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < nc; row += CT_THREADS / 32) {
    float acc0[TT], acc1[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc0[t] = acc1[t] = 0.f;
    for (int b0 = 0; b0 < nc; b0 += 32 * CT_BCH) {
      float k[CT_BCH][CT_TAPS];
#pragma unroll
      for (int j = 0; j < CT_BCH; ++j) {
        const int b = b0 + lane + 32 * j;
#pragma unroll
        for (int u = 0; u < CT_TAPS; ++u)
          k[j][u] = (b < nc && r0 + u < r1)
                        ? __ldg(&B.K[((size_t)(r0 + u) * nc + row) * nc + b])
                        : 0.f;
      }
#pragma unroll
      for (int j = 0; j < CT_BCH; ++j) {
        const int b = b0 + lane + 32 * j;
        if (b >= nc) break;
#pragma unroll
        for (int u = 0; u < CT_TAPS; ++u) {
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            const float* Ht = H + t * rows * nc;
            acc0[t] += k[j][u] * Ht[(u + 1) * nc + b];
            acc1[t] += k[j][u] * Ht[u * nc + b];
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float c0 = warp_sum(acc0[t]), c1 = warp_sum(acc1[t]);
      if (lane == 0 && t < ntt) {
        float* o = B.part + (((size_t)s * a.ntraj + tr0 + t) * nc + row) * 2;
        o[0] = c0;
        o[1] = c1;
      }
    }
  }
}

// out = sum over splits of part: a warp per output, lane l summing splits
// l, l+32, ... in order, then a fixed butterfly over the lanes
#define CT_RED_THREADS 256
__global__ void __launch_bounds__(CT_RED_THREADS)
conv_tails_reduce(const CtArgs a) {
  const CtBath& B = a.baths[blockIdx.y];
  const size_t n = (size_t)a.ntraj * B.nc * 2;
  const int lane = threadIdx.x & 31;
  const size_t wpb = CT_RED_THREADS / 32;
  for (size_t i = blockIdx.x * wpb + (threadIdx.x >> 5); i < n;
       i += (size_t)gridDim.x * wpb) {
    float acc = 0.f;
    for (int sp = lane; sp < B.nsplit; sp += 32)
      acc += B.part[(size_t)sp * n + i];
    acc = warp_sum(acc);
    if (lane == 0) B.out[i] = acc;
  }
}

template <int TT>
static int launch(const CtArgs& a, int ncmax, cudaStream_t st) {
  const int bytes = TT * (CT_TAPS + 1) * ncmax * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      conv_tails_partial<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.nsplit, (a.ntraj + TT - 1) / TT);
  conv_tails_partial<TT><<<grid, CT_THREADS, bytes, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int wpb = CT_RED_THREADS / 32;
  int nred = (a.ntraj * ncmax * 2 + wpb - 1) / wpb;
  if (nred > 4096) nred = 4096;
  conv_tails_reduce<<<dim3(nred, a.nb), CT_RED_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int conv_tails_f32(const CtArgs* args, void* stream) {
  const CtArgs a = *args;
  if (a.nb < 1 || a.nb > CT_MAX_BATHS || a.ntraj < 1 || a.nsplit < 1)
    return (int)cudaErrorInvalidValue;
  int ncmax = 0;
  for (int i = 0; i < a.nb; ++i) {
    if (a.baths[i].ml < 3 || a.baths[i].ml > a.mlr || a.baths[i].nc < 1)
      return (int)cudaErrorInvalidValue;
    if (a.baths[i].nc > ncmax) ncmax = a.baths[i].nc;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.tt) {
    case 1: return launch<1>(a, ncmax, st);
    case 2: return launch<2>(a, ncmax, st);
    case 4: return launch<4>(a, ncmax, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
