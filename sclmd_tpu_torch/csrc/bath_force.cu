// K7 — bath_force: one bath-force evaluation of the plain GLE step for
// every bath of every trajectory, with the Verlet update of that
// evaluation fused in (float32, sm_90a).
//
// Per bath, on its DOFs cids, with this evaluation's noise row n:
//   fb = n - s (Mv x + Mh h + tail) + Mq q
// non-local phonon bath: s = dt, Mv = K0, Mh = K1, tail = K6's column;
// local phonon bath:     s = 1,  Mv = K0;
// electron bath:         s = 1,  Mv = efric (+ bias zeta2),
//                        Mq = bias (exim - zeta1) when bias terms are on.
// f = pf + sum_b scatter(fb). Stage 0 (predictor) writes pthalf = x + dt/2 f,
// qtt = q + dt x + dt^2/2 f, cur_b = fb . x, etot = x.x / 2 and pushes x
// onto the history ring; stage 1 (corrector) writes base + dt/2 f; stage 2
// (last corrector) writes (base + dt/2 f) mask and q mask.
//
// Replaces: the Pallas kernel fused_bath_force
// (a5170d2:sclmd_tpu/ops/kernels.py:98, pallas_call at :116), whose live
// successors on the plain path are PhBath.force_pred/force_corr
// (sclmd_tpu/baths.py:559-575) and EBath._markov_force (:234-239), with
// the scatter and Verlet arithmetic of sclmd_tpu/md.py:349-380 around them.
//
// What bounds it on the H100: per trajectory and bath up to three nc x nc
// matvecs (2 nc^2 FLOP each) against reading each matrix (90 KB at nc 150)
// from L2. One CTA owns TT trajectories, so every matrix element it loads
// feeds TT FMAs; the bath-DOF vectors are gathered into shared memory and
// read as broadcasts. Matrices are passed transposed (MT[b][a]) so that a
// thread owns output row a and a warp's loads are coalesced. For one
// trajectory a CTA's own load latency is the cost (a thread walks a whole
// row), so the loads go out in batches (matvec_row); the kernel also
// folds about twenty small torch ops per evaluation into one launch.

#include <cuda_runtime.h>

#define BF_MAX_BATHS 4
#define BF_THREADS 256

struct BfBath {
  const float* noise;  // (ntraj, nmd, nc)
  const float* MvT;    // (nc, nc) transposed
  const float* MhT;    // (nc, nc) transposed, or null
  const float* MqT;    // (nc, nc) transposed, or null
  const float* tail;   // (ntraj, nc, 2), or null
  const int* cids;     // (nc,) distinct
  float* fb;           // (ntraj, nc) out, or null
  int nc;
  float s;
};

struct BfArgs {
  const float* x;      // (ntraj, nph) velocity the friction acts on
  const float* q;      // (ntraj, nph) displacement
  const float* pf;     // (ntraj, nph) potential force
  const float* h;      // second friction tap, row stride h_stride, or null
  const float* base;   // (ntraj, nph) pthalf (stages 1, 2)
  const float* mask;   // (nph,) (stage 2)
  float* out_p;
  float* out_q;
  float* f_out;        // (ntraj, nph) total force, or null
  float* cur;          // row stride cur_stride, nb entries (stage 0)
  float* etot;         // row stride etot_stride (stage 0)
  float* push;         // ring row, row stride push_stride, or null
  long long h_stride, push_stride, cur_stride, etot_stride;
  int ntraj, nph, nb, nmd, row, stage, tt, ncmax, tail_col;
  float dt, hdt, dt2h;
  BfBath baths[BF_MAX_BATHS];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[t] += sum_b MT[b][row] V[t][b]. A thread owns one row, so its
// loads are what bounds it: BF_BATCH of them are issued before the FMAs
// that use them, to keep the L2 latency of each in the shadow of the rest.
#define BF_BATCH 16
template <int TT>
__device__ __forceinline__ void matvec_row(const float* __restrict__ MT,
                                           const float* V, int ld, int nc,
                                           int row, float* acc) {
  int b = 0;
  for (; b + BF_BATCH <= nc; b += BF_BATCH) {
    float m[BF_BATCH];
#pragma unroll
    for (int u = 0; u < BF_BATCH; ++u)
      m[u] = __ldg(&MT[(size_t)(b + u) * nc + row]);
#pragma unroll
    for (int u = 0; u < BF_BATCH; ++u) {
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] += m[u] * V[t * ld + b + u];
    }
  }
  for (; b < nc; ++b) {
    const float m = __ldg(&MT[(size_t)b * nc + row]);
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] += m * V[t * ld + b];
  }
}

template <int TT>
__global__ void __launch_bounds__(BF_THREADS)
bath_force_kernel(const BfArgs a) {
  extern __shared__ float sm[];
  const int nph = a.nph, ld = a.ncmax;
  float* F = sm;                  // [TT][nph] total force
  float* XG = F + TT * nph;       // [TT][ncmax] x on the bath DOFs
  float* HG = XG + TT * ld;       // [TT][ncmax] h on the bath DOFs
  float* QG = HG + TT * ld;       // [TT][ncmax] q on the bath DOFs
  float* FB = QG + TT * ld;       // [TT][ncmax] this bath's force
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr0 = blockIdx.x * TT;
  const int ntt = min(TT, a.ntraj - tr0);
  const size_t g0 = (size_t)tr0 * nph;

  for (int i = tid; i < TT * nph; i += BF_THREADS)
    F[i] = i < ntt * nph ? a.pf[g0 + i] : 0.f;

  for (int bi = 0; bi < a.nb; ++bi) {
    const BfBath& B = a.baths[bi];
    const int nc = B.nc;
    __syncthreads();  // F complete; the previous bath's FB/XG no longer read
    for (int i = tid; i < TT * nc; i += BF_THREADS) {
      const int t = i / nc, c = i % nc;
      const bool ok = t < ntt;
      const int col = B.cids[c];
      const size_t r = (size_t)(tr0 + t);
      XG[t * ld + c] = ok ? a.x[r * nph + col] : 0.f;
      if (B.MhT) HG[t * ld + c] = ok ? a.h[r * a.h_stride + col] : 0.f;
      if (B.MqT) QG[t * ld + c] = ok ? a.q[r * nph + col] : 0.f;
    }
    __syncthreads();
    for (int row = tid; row < nc; row += BF_THREADS) {
      float acc[TT], qa[TT];
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] = qa[t] = 0.f;
      matvec_row<TT>(B.MvT, XG, ld, nc, row, acc);
      if (B.MhT) matvec_row<TT>(B.MhT, HG, ld, nc, row, acc);
      if (B.MqT) matvec_row<TT>(B.MqT, QG, ld, nc, row, qa);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (t >= ntt) break;
        const size_t r = (size_t)(tr0 + t);
        if (B.tail) acc[t] += B.tail[(r * nc + row) * 2 + a.tail_col];
        const float fb =
            B.noise[(r * a.nmd + a.row) * nc + row] - B.s * acc[t] + qa[t];
        FB[t * ld + row] = fb;
        if (B.fb) B.fb[r * nc + row] = fb;
      }
    }
    __syncthreads();
    for (int i = tid; i < ntt * nc; i += BF_THREADS) {
      const int t = i / nc, c = i % nc;
      F[t * nph + B.cids[c]] += FB[t * ld + c];
    }
    if (a.stage == 0 && a.cur) {
      for (int t = warp; t < ntt; t += BF_THREADS / 32) {
        float c = 0.f;
        for (int i = lane; i < nc; i += 32) c += FB[t * ld + i] * XG[t * ld + i];
        c = warp_sum(c);
        if (lane == 0) a.cur[(size_t)(tr0 + t) * a.cur_stride + bi] = c;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < ntt * nph; i += BF_THREADS) {
    const size_t g = g0 + i;
    const float f = F[i];
    if (a.f_out) a.f_out[g] = f;
    if (a.stage == 0) {
      const float x = a.x[g];
      a.out_p[g] = x + f * a.hdt;
      a.out_q[g] = a.q[g] + x * a.dt + f * a.dt2h;
      if (a.push) {
        const int t = i / nph;
        a.push[(size_t)(tr0 + t) * a.push_stride + (i % nph)] = x;
      }
    } else if (a.stage == 1) {
      a.out_p[g] = a.base[g] + a.hdt * f;
    } else {
      const float m = a.mask[i % nph];
      a.out_p[g] = (a.base[g] + a.hdt * f) * m;
      a.out_q[g] = a.q[g] * m;
    }
  }
  if (a.stage == 0 && a.etot) {
    for (int t = warp; t < ntt; t += BF_THREADS / 32) {
      float e = 0.f;
      for (int i = lane; i < nph; i += 32) {
        const float x = a.x[g0 + (size_t)t * nph + i];
        e += x * x;
      }
      e = warp_sum(e);
      if (lane == 0) a.etot[(size_t)(tr0 + t) * a.etot_stride] = 0.5f * e;
    }
  }
}

static int smem_bytes(int tt, int nph, int ncmax) {
  return (tt * nph + 4 * tt * ncmax) * (int)sizeof(float);
}

template <int TT>
static int launch(const BfArgs& a, cudaStream_t st) {
  const int bytes = smem_bytes(TT, a.nph, a.ncmax);
  cudaError_t e = cudaFuncSetAttribute(
      bath_force_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.ntraj + TT - 1) / TT;
  bath_force_kernel<TT><<<grid, BF_THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int bath_force_f32(const BfArgs* args, void* stream) {
  const BfArgs a = *args;
  if (a.nb < 0 || a.nb > BF_MAX_BATHS || a.ntraj < 1 || a.nph < 1 ||
      a.ncmax < 1 || a.stage < 0 || a.stage > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.tt) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    case 8: return launch<8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
