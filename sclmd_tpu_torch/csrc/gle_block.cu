// K1, near taps — a sub-block of fused GLE velocity-Verlet steps, batched
// over trajectories (float32, sm_90a). Its partner gle_far.cu adds the
// far taps between sub-blocks.
//
// Replaces: the inner scan body of the JAX package's blocked integrator,
// sclmd_tpu/md.py:_run_segment_blocked_body.inner (md.py:532-611) with
// PhBath.force_pred/force_corr (baths.py:559-575), which XLA ran as some
// thirty small ops per step; its Pallas predecessor fused_bath_force
// (a5170d2:sclmd_tpu/ops/kernels.py:98) covered only the
// noise - dt (K0 v + tail) piece.
//
// The in-block convolution is split in two levels. With p_j the velocity
// at the start of step j of the block and K[d] the memory kernel's tap d,
// the predictor at step s needs
//   C[s] = O[s] + sum_{j<s} K[s-j] p_j
// (O: the pre-block tails from K2) and the corrector base is C[s+1]
// taken with p_s, which folds the JAX term K[1] p into it. The block runs
// as sub-blocks of S steps. This kernel runs one sub-block [b0, b0+ns):
// it convolves only the rows p_b0 .. p_s of its own sub-block, so it
// reads at most S taps of kin per step, and takes the rest of C from O,
// into which gle_far.cu has added every earlier sub-block.
//
// One CTA owns a tile of TT trajectories for the sub-block: p, q, the
// carried force and the step's work vectors stay in shared memory, and
// so do the sub-block's velocity rows (NR, one leading zero row), so no
// ring row is re-read from global memory. The ring rows also go to
// global memory in the final newest-first layout (step s writes row
// block-1-s) for the far kernel and for the history.
//
// What bounds it on the H100: the latency of one step's chain of
// dependent phases inside a CTA (about 15 barriers, and the L2 round
// trips of the kin taps and the dynamical matrix, which stream from L2 at
// every step: (S + 1) / 2 taps x nc^2 x 4 bytes per bath on average plus
// nph^2 x 4 for dyn, about 0.8 MB per CTA at S 12, nc 90, nph 300,
// against 8.4 MB for the whole-block kernel this replaces). The CTA count
// is one wave (the wrapper gives a CTA two or four trajectories at 256
// and 512), so L2 traffic is (ntraj / TT) x that per step. What the design does:
// * kin is passed transposed and tap-blocked, kinT[k][b][a] with b padded
//   to ncs = nc rounded up to 4: a thread owns one output row a, so a
//   warp's kin loads are coalesced along a and need no reduction; the
//   taps are spread over NG = 512 / round_up(nc, 32) thread groups (5 at
//   nc 90), whose partial sums meet in shared memory;
// * every thread reads the NR rows as 16-byte broadcasts: one load feeds
//   4 FMAs for each of TT trajectories, and one row serves both tails
//   (the predictor reads one row further back);
// * K0 (three uses per step and bath) is staged in shared memory once
//   per launch; the step's noise and O rows are copied in with cp.async
//   while the tails are summed;
// * dyn: a warp takes GLE_DYN_ROWS rows at once, lanes along them, five
//   column steps of loads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#define GLE_MAX_BATHS 4
#define GLE_THREADS 512
// rows of dyn a warp takes at once (fewer at four trajectories per CTA,
// whose accumulators would spill)
#define GLE_DYN_ROWS(TT) ((TT) >= 4 ? 4 : 8)
#define GLE_K0_ROWS 3    // rows of K0 a warp takes at once

struct GleBath {
  const float* noise;  // (ntraj, nmd, nc)
  const float* O;      // (ntraj, block+1, nc) tails of every earlier row
  const float* kinT;   // (block+1, ncs, nc): kinT[k][b][a] = K[k+1][a][b], 0 for b >= nc
  const float* K0;     // (nc, nc)
  const int* cids;     // (nc,)
  float* ring;         // (ntraj, block, nc) out, newest first
  int nc;
  int ncs;             // nc rounded up to a multiple of 4
};

struct GleArgs {
  float* p;            // (ntraj, nph) in and out
  float* q;
  float* pf;
  float* qprev;        // q at the start of the block's last step
  const float* dyn;    // (nph, nph)
  const float* mask;   // (nph,)
  float* cur;          // (ntraj, block, nb)
  float* etot;         // (ntraj, block)
  int ntraj, nph, nb, block, nmd, t0, free_, tt, ncmax;
  int b0, ns, sub;     // this launch runs steps [b0, b0+ns), ns <= sub
  float dt, hdt, dt2h; // dt, dt/2, dt*dt/2 (rounded once from double)
  GleBath baths[GLE_MAX_BATHS];
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// shared-memory layout, in floats: 8 work vectors [TT][nph]; FB, CB
// [nb][TT][ncmax]; the sub-block rows NR [nb][TT][(sub+1)*ncsmax]
// (16-byte aligned, row 0 zero); the group partial sums
// PART [NG][3][TT][ncmax]; the baths' K0 [nb][ncmax*ncmax]; the step's
// rows RW [nb][4][TT][ncmax] (noise rows t and t+1, O rows s and s+1)
__host__ __device__ inline int nr_offset(int tt, int nph, int nb, int ncmax) {
  return round_up(8 * tt * nph + 2 * nb * tt * ncmax, 4);
}
__host__ __device__ inline int nr_ld(int ncmax, int sub) {
  return (sub + 1) * round_up(ncmax, 4);
}
__host__ __device__ inline int n_groups(int nc) {
  return GLE_THREADS / round_up(nc, 32);
}
static int smem_floats(int tt, int nph, int nb, int ncmax, int sub) {
  return nr_offset(tt, nph, nb, ncmax) + nb * tt * nr_ld(ncmax, sub) +
         n_groups(ncmax) * 3 * tt * ncmax + nb * ncmax * ncmax +
         nb * 4 * tt * ncmax;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Y[t][i] = -sum_j M[i][j] X[t][j] for an (n, n) row-major M: a warp
// takes R rows at once, lanes along them, so R loads per lane are in
// flight together.
template <int TT, int R>
__device__ void neg_matvec(const float* __restrict__ M, const float* X,
                           float* Y, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row0 = warp * R; row0 < n; row0 += (GLE_THREADS / 32) * R) {
    float acc[R][TT];
    const float* mr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mr[r] = M + (size_t)min(row0 + r, n - 1) * n;
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[r][t] = 0.f;
    }
#pragma unroll 5  // column steps whose loads go out together
    for (int j = lane; j < n; j += 32) {
      float mv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) mv[r] = __ldg(mr[r] + j);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const float x = X[t * n + j];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][t] += mv[r] * x;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[r][t] = warp_sum(acc[r][t]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (row0 + r < n) {
#pragma unroll
          for (int t = 0; t < TT; ++t) Y[t * n + row0 + r] = -acc[r][t];
        }
    }
  }
}

// F = PF2 + sum_b scatter(n1 - dt (K0 X_c + CB_b)), baths in order; a
// warp takes R rows of K0 at once.
template <int TT, int R>
__device__ void bath_sum(const GleArgs& a, const float* K0S, const float* RW,
                         const float* X, const float* PF2, const float* CB,
                         float* F, int ntt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nph = a.nph;
  for (int i = threadIdx.x; i < TT * nph; i += GLE_THREADS) F[i] = PF2[i];
  __syncthreads();
  for (int b = 0; b < a.nb; ++b) {
    const GleBath& B = a.baths[b];
    const int nc = B.nc;
    for (int row0 = warp * R; row0 < nc; row0 += (GLE_THREADS / 32) * R) {
      float acc[R][TT];
      const float* kr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        kr[r] = K0S + b * a.ncmax * a.ncmax + min(row0 + r, nc - 1) * nc;
#pragma unroll
        for (int t = 0; t < TT; ++t) acc[r][t] = 0.f;
      }
      for (int c = lane; c < nc; c += 32) {
        float kv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) kv[r] = kr[r][c];
        const int col = B.cids[c];
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          const float x = X[t * nph + col];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][t] += kv[r] * x;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int t = 0; t < TT; ++t) acc[r][t] = warp_sum(acc[r][t]);
      if (lane < R && row0 + lane < nc) {
        // lane r scatters row row0 + r
        const int row = row0 + lane;
        const int col = B.cids[row];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r != lane) continue;
          for (int t = 0; t < ntt; ++t) {
            const float n1 = RW[((b * 4 + 1) * TT + t) * a.ncmax + row];
            const float cb = CB[(b * TT + t) * a.ncmax + row];
            F[t * nph + col] += n1 - (acc[r][t] + cb) * a.dt;
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int TT>
__global__ void __launch_bounds__(GLE_THREADS)
gle_near_kernel(const GleArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int nph = a.nph, blk = a.block, nb = a.nb, ncmax = a.ncmax;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = GLE_THREADS / 32;
  const int tr0 = blockIdx.x * TT;
  const int ntt = min(TT, a.ntraj - tr0);
  float* P = sm;                  // [TT][nph] each
  float* Q = P + TT * nph;
  float* PF = Q + TT * nph;
  float* F = PF + TT * nph;
  float* PH = F + TT * nph;
  float* QT = PH + TT * nph;
  float* PF2 = QT + TT * nph;
  float* PT = PF2 + TT * nph;
  float* FB = PT + TT * nph;      // [nb][TT][ncmax] predictor bath forces
  float* CB = FB + nb * TT * ncmax;  // [nb][TT][ncmax] corrector bases
  float* NR = sm + nr_offset(TT, nph, nb, ncmax);  // sub-block rows
  const int ncsm = round_up(ncmax, 4);
  const int nrld = nr_ld(ncmax, a.sub);
  float* PART = NR + nb * TT * nrld;  // [NG][3][TT][ncmax] partial sums
  float* K0S = PART + n_groups(ncmax) * 3 * TT * ncmax;  // [nb][ncmax^2]
  float* RW = K0S + nb * ncmax * ncmax;   // [nb][4][TT][ncmax] step rows

  for (int i = tid; i < TT * nph; i += GLE_THREADS) {
    const int t = i / nph;
    const size_t g = (size_t)tr0 * nph + i;
    const bool v = t < ntt;
    P[i] = v ? a.p[g] : 0.f;
    Q[i] = v ? a.q[g] : 0.f;
    PF[i] = v ? a.pf[g] : 0.f;
  }
  for (int i = tid; i < 2 * nb * TT * ncmax; i += GLE_THREADS) FB[i] = 0.f;
  for (int i = tid; i < nb * TT * nrld; i += GLE_THREADS) NR[i] = 0.f;
  for (int b = 0; b < nb; ++b) {
    const GleBath& B = a.baths[b];
    for (int i = tid; i < B.nc * B.nc; i += GLE_THREADS)
      K0S[b * ncmax * ncmax + i] = B.K0[i];
  }
  __syncthreads();

  for (int ls = 0; ls < a.ns; ++ls) {
    const int s = a.b0 + ls;
    const int nr0 = (a.t0 + s) % a.nmd, nr1 = (a.t0 + s + 1) % a.nmd;
    // this step's noise and O rows, copied while the tails are summed
    for (int i = tid; i < nb * 4 * TT * ncmax; i += GLE_THREADS) {
      const int row = i % ncmax, r = i / ncmax;
      const int t = r % TT, kind = (r / TT) % 4, b = r / (4 * TT);
      const GleBath& B = a.baths[b];
      if (t < ntt && row < B.nc)
        cp_async4(RW + i,
                  kind < 2 ? B.noise + ((size_t)(tr0 + t) * a.nmd +
                                        (kind ? nr1 : nr0)) * B.nc + row
                           : B.O + ((size_t)(tr0 + t) * (blk + 1) + s +
                                    kind - 2) * B.nc + row);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (!a.free_) {
      neg_matvec<TT, GLE_DYN_ROWS(TT)>(a.dyn, Q, PF, nph);
      __syncthreads();
    }
    // kinetic energy of the pre-step state
    for (int t = warp; t < ntt; t += nwarp) {
      float e = 0.f;
      for (int i = lane; i < nph; i += 32) e += P[t * nph + i] * P[t * nph + i];
      e = warp_sum(e);
      if (lane == 0) a.etot[(size_t)(tr0 + t) * blk + s] = 0.5f * e;
    }
    // push of the pre-step p: ring row block-1-s and NR row ls+1
    for (int b = 0; b < nb; ++b) {
      const GleBath& B = a.baths[b];
      for (int i = tid; i < TT * B.nc; i += GLE_THREADS) {
        const int t = i / B.nc, c = i % B.nc;
        const float v = P[t * nph + B.cids[c]];
        NR[(b * TT + t) * nrld + (ls + 1) * ncsm + c] = v;
        if (t < ntt)
          B.ring[((size_t)(tr0 + t) * blk + (blk - 1 - s)) * B.nc + c] = v;
      }
    }

    // predictor bath forces and corrector bases over the near taps
    // k = 0..ls (kernel tap k+1): the corrector tail reads row p_{s-k}
    // (NR row ls+1-k), the predictor's p_{s-1-k} (one row back; row 0 is
    // zero)
    for (int b = 0; b < nb; ++b) {
      const GleBath& B = a.baths[b];
      const int nc = B.nc, ncs = B.ncs;
      // PART is sized for the widest bath's group count
      const int ng = min(n_groups(nc), n_groups(ncmax));
      const int ncp = round_up(nc, 32);
      const int g = tid / ncp, ar = tid % ncp;
      const bool act = g < ng && ar < nc;
      __syncthreads();  // NR rows pushed; the previous bath is done with PART
      if (act) {
        float A1[TT], A0[TT], AK[TT];
#pragma unroll
        for (int t = 0; t < TT; ++t) A1[t] = A0[t] = AK[t] = 0.f;
        const float* nrb = NR + b * TT * nrld;
        for (int k = g; k <= ls; k += ng) {
          const float* kt = B.kinT + (size_t)k * ncs * nc + ar;
          const float* r1 = nrb + (ls + 1 - k) * ncsm;
#pragma unroll 8
          for (int b4 = 0; b4 < ncs; b4 += 4) {
            const float k0 = __ldg(kt + (size_t)b4 * nc);
            const float k1 = __ldg(kt + (size_t)(b4 + 1) * nc);
            const float k2 = __ldg(kt + (size_t)(b4 + 2) * nc);
            const float k3 = __ldg(kt + (size_t)(b4 + 3) * nc);
#pragma unroll
            for (int t = 0; t < TT; ++t) {
              const float4 x1 =
                  *reinterpret_cast<const float4*>(r1 + t * nrld + b4);
              const float4 x0 =
                  *reinterpret_cast<const float4*>(r1 + t * nrld - ncsm + b4);
              A1[t] = fmaf(k3, x1.w, fmaf(k2, x1.z,
                      fmaf(k1, x1.y, fmaf(k0, x1.x, A1[t]))));
              A0[t] = fmaf(k3, x0.w, fmaf(k2, x0.z,
                      fmaf(k1, x0.y, fmaf(k0, x0.x, A0[t]))));
            }
          }
        }
        const float* k0r = K0S + b * ncmax * ncmax + ar * nc;
#pragma unroll 4
        for (int c = g; c < nc; c += ng) {
          const float kv = k0r[c];
          const int col = B.cids[c];
#pragma unroll
          for (int t = 0; t < TT; ++t) AK[t] += kv * P[t * nph + col];
        }
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          PART[((g * 3 + 0) * TT + t) * ncmax + ar] = A1[t];
          PART[((g * 3 + 1) * TT + t) * ncmax + ar] = A0[t];
          PART[((g * 3 + 2) * TT + t) * ncmax + ar] = AK[t];
        }
      }
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();  // PART written; the step's rows landed
      for (int i = tid; i < ntt * nc; i += GLE_THREADS) {
        const int t = i / nc, row = i % nc;
        float s1 = 0.f, s0 = 0.f, sk = 0.f;
        for (int gg = 0; gg < ng; ++gg) {
          s1 += PART[((gg * 3 + 0) * TT + t) * ncmax + row];
          s0 += PART[((gg * 3 + 1) * TT + t) * ncmax + row];
          sk += PART[((gg * 3 + 2) * TT + t) * ncmax + row];
        }
        const float* rw = RW + (b * 4 * TT + t) * ncmax + row;
        const float conv = sk + s0 + rw[2 * TT * ncmax];
        FB[(b * TT + t) * ncmax + row] = rw[0] - conv * a.dt;
        CB[(b * TT + t) * ncmax + row] = s1 + rw[3 * TT * ncmax];
      }
    }
    __syncthreads();

    // f = pf + scatter(fb), baths in order
    for (int i = tid; i < TT * nph; i += GLE_THREADS) F[i] = PF[i];
    __syncthreads();
    for (int b = 0; b < nb; ++b) {
      const GleBath& B = a.baths[b];
      for (int i = tid; i < TT * B.nc; i += GLE_THREADS) {
        const int t = i / B.nc, c = i % B.nc;
        F[t * nph + B.cids[c]] += FB[(b * TT + t) * ncmax + c];
      }
      __syncthreads();
    }
    for (int i = tid; i < TT * nph; i += GLE_THREADS) {
      PH[i] = P[i] + F[i] * a.hdt;
      QT[i] = Q[i] + P[i] * a.dt + F[i] * a.dt2h;
    }
    // per-bath heat current fb . p
    for (int pr = warp; pr < ntt * nb; pr += nwarp) {
      const int t = pr / nb, b = pr % nb;
      const GleBath& B = a.baths[b];
      float c = 0.f;
      for (int i = lane; i < B.nc; i += 32)
        c += FB[(b * TT + t) * ncmax + i] * P[t * nph + B.cids[i]];
      c = warp_sum(c);
      if (lane == 0) a.cur[((size_t)(tr0 + t) * blk + s) * nb + b] = c;
    }
    __syncthreads();

    neg_matvec<TT, GLE_DYN_ROWS(TT)>(a.dyn, QT, PF2, nph);
    __syncthreads();
    bath_sum<TT, GLE_K0_ROWS>(a, K0S, RW, PH, PF2, CB, F, ntt);
    for (int i = tid; i < TT * nph; i += GLE_THREADS)
      PT[i] = PH[i] + a.hdt * F[i];
    __syncthreads();
    bath_sum<TT, GLE_K0_ROWS>(a, K0S, RW, PT, PF2, CB, F, ntt);

    if (s == blk - 1) {
      for (int i = tid; i < ntt * nph; i += GLE_THREADS)
        a.qprev[(size_t)tr0 * nph + i] = Q[i];
    }
    for (int i = tid; i < TT * nph; i += GLE_THREADS) {
      const float m = a.mask[i % nph];
      P[i] = (PH[i] + a.hdt * F[i]) * m;
      Q[i] = QT[i] * m;
      if (a.free_) PF[i] = PF2[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < ntt * nph; i += GLE_THREADS) {
    const size_t g = (size_t)tr0 * nph + i;
    a.p[g] = P[i];
    a.q[g] = Q[i];
    a.pf[g] = PF[i];
  }
}

template <int TT>
static int launch(const GleArgs& a, cudaStream_t stream) {
  const int bytes =
      smem_floats(TT, a.nph, a.nb, a.ncmax, a.sub) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gle_near_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.ntraj + TT - 1) / TT;
  gle_near_kernel<TT><<<grid, GLE_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int gle_near_smem_bytes(int tt, int nph, int nb, int ncmax,
                                   int sub) {
  return smem_floats(tt, nph, nb, ncmax, sub) * (int)sizeof(float);
}

extern "C" int gle_near_f32(const GleArgs* args, void* stream) {
  const GleArgs a = *args;
  if (a.nb < 1 || a.nb > GLE_MAX_BATHS || a.ntraj < 1 || a.ns < 1 ||
      a.ns > a.sub || a.b0 < 0 || a.b0 + a.ns > a.block)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.tt) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
