// K1 — one block of fused GLE velocity-Verlet steps, batched over
// trajectories (float32, sm_90a).
//
// Replaces: the inner scan body of the JAX package's blocked integrator,
// sclmd_tpu/md.py:_run_segment_blocked_body.inner (md.py:532-611) with
// PhBath.force_pred/force_corr (baths.py:559-575), which XLA ran as some
// thirty small ops per step; its Pallas predecessor fused_bath_force
// (a5170d2:sclmd_tpu/ops/kernels.py:98) covered only the
// noise - dt (K0 v + tail) piece.
//
// Design. One CTA owns a tile of TT trajectories for a whole block of
// steps: p, q, the carried force and the step's work vectors stay in
// shared memory, and one launch replaces block x ~30 XLA ops. Trajectories
// are independent, so nothing crosses CTAs. Every matrix element read
// (kin, dyn, K0) is reused across the TT trajectories of the tile.
//
// The in-block ring is kept in its final newest-first layout in global
// memory: step s writes p_s into ring row block-1-s, so the ring as the
// JAX step sees it (rows s-1 .. 0, newest first) is the contiguous slice
// rows [block-s, block). With tap k standing for the kernel matrix
// K[k+1] (kin's column block k), both in-block tails become
//   predictor: sum_{k<s}  K[k+1] ring[block-s+k]
//   corrector: sum_{k<=s} K[k+1] ring[block-1-s+k]
// (the corrector sum includes this step's p, which folds the JAX term
// K[1] p into it). Ring rows beyond s, all zero in the JAX step, are
// skipped: adding a zero product is exact, but the sums run in another
// order than XLA's, so results agree to float32 rounding.
//
// What bounds it on the H100: the in-block tail, 2 (s+1) nc^2 FMAs per
// bath per step per trajectory (about 2 M per step at the primary shapes,
// s = 128 on average), reading (s+1) nc^2 floats of kin (8.3 MB per bath
// at block 256, nc 90) from L2 at every step. Each CTA reads kin once
// per step for its TT trajectories, so L2 traffic per step is
// (ntraj / TT) x (s+1) nc^2 x 4 bytes. Measured on the H100, though, a
// CTA is held back by the latency of its own loads and barriers more
// than by L2 bandwidth (more CTAs per SM help more than L2 reuse across
// a larger tile: tools/k1_sweep.py), so the wrapper picks the largest TT
// that still gives about 1.5 CTAs per SM. The tail loop is laid out so
// nothing else competes with the kin stream:
// * kin is passed transposed and tap-blocked, kinT[k][b][a] with b padded
//   to ncs = nc rounded up to 4: a thread owns one output row a, so a
//   warp's kin loads are coalesced along a and need no reduction;
// * the ring rows of a chunk of GLE_CH taps are staged in shared memory
//   (row stride ncs, zero padded), and every thread reads them as
//   16-byte broadcasts: one load feeds 4 FMAs for each of TT trajectories,
//   and one staged chunk serves both tails (the predictor reads it one
//   row further on);
// * the taps of a chunk are spread over NG = 512 / round_up(nc, 32)
//   thread groups (5 at nc 90), whose partial sums meet in shared memory.
// dyn (360 KB) and K0 are read once per step too: a warp per row, lanes
// along it.

#include <cuda_runtime.h>
#include <stdint.h>

#define GLE_MAX_BATHS 4
#define GLE_THREADS 512
#define GLE_CH 32      // taps of the ring staged in shared memory at a time

struct GleBath {
  const float* noise;  // (ntraj, nmd, nc)
  const float* O;      // (ntraj, block+1, nc) pre-block tails
  const float* kinT;   // (block+1, ncs, nc): kinT[k][b][a] = K[k+1][a][b], 0 for b >= nc
  const float* K0;     // (nc, nc)
  const int* cids;     // (nc,)
  float* ring;         // (ntraj, block, nc) out, newest first
  int nc;
  int ncs;             // nc rounded up to a multiple of 4
};

struct GleArgs {
  const float* p_in;
  const float* q_in;
  const float* pf_in;
  float* p_out;
  float* q_out;
  float* pf_out;
  float* qprev;        // q at the start of the block's last step
  const float* dyn;    // (nph, nph)
  const float* mask;   // (nph,)
  float* cur;          // (ntraj, block, nb)
  float* etot;         // (ntraj, block)
  int ntraj, nph, nb, block, nmd, t0, free_, tt, ncmax;
  float dt, hdt, dt2h; // dt, dt/2, dt*dt/2 (rounded once from double)
  GleBath baths[GLE_MAX_BATHS];
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// shared-memory layout, in floats: 8 work vectors [TT][nph]; FB, CB
// [nb][TT][ncmax]; the staged ring chunk RS [TT][(GLE_CH+1)*ncs]
// (16-byte aligned); the group partial sums PART [NG][3][TT][ncmax]
__host__ __device__ inline int rs_offset(int tt, int nph, int nb, int ncmax) {
  return round_up(8 * tt * nph + 2 * nb * tt * ncmax, 4);
}
__host__ __device__ inline int rs_ld(int ncmax) {
  return (GLE_CH + 1) * round_up(ncmax, 4);
}
__host__ __device__ inline int n_groups(int nc) {
  return GLE_THREADS / round_up(nc, 32);
}
static int smem_floats(int tt, int nph, int nb, int ncmax) {
  return rs_offset(tt, nph, nb, ncmax) + tt * rs_ld(ncmax) +
         n_groups(ncmax) * 3 * tt * ncmax;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Y[t][i] = -sum_j M[i][j] X[t][j] for an (n, n) row-major M; warp per row.
template <int TT>
__device__ void neg_matvec(const float* __restrict__ M, const float* X,
                           float* Y, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < n; row += GLE_THREADS / 32) {
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.f;
    const float* mr = M + (size_t)row * n;
    for (int j = lane; j < n; j += 32) {
      const float mv = mr[j];
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] += mv * X[t * n + j];
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = warp_sum(acc[t]);
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < TT; ++t) Y[t * n + row] = -acc[t];
    }
  }
}

// F = PF2 + sum_b scatter(n1 - dt (K0 X_c + CB_b)), baths in order.
template <int TT>
__device__ void bath_sum(const GleArgs& a, const float* X, const float* PF2,
                         const float* CB, float* F, int tr0, int ntt,
                         int r1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nph = a.nph;
  for (int i = threadIdx.x; i < TT * nph; i += GLE_THREADS) F[i] = PF2[i];
  __syncthreads();
  for (int b = 0; b < a.nb; ++b) {
    const GleBath& B = a.baths[b];
    const int nc = B.nc;
    for (int row = warp; row < nc; row += GLE_THREADS / 32) {
      float acc[TT];
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] = 0.f;
      for (int c = lane; c < nc; c += 32) {
        const float kv = B.K0[row * nc + c];
        const int col = B.cids[c];
#pragma unroll
        for (int t = 0; t < TT; ++t) acc[t] += kv * X[t * nph + col];
      }
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] = warp_sum(acc[t]);
      if (lane == 0) {
        const int col = B.cids[row];
        for (int t = 0; t < ntt; ++t) {
          const float n1 =
              B.noise[((size_t)(tr0 + t) * a.nmd + r1) * nc + row];
          const float cb = CB[(b * TT + t) * a.ncmax + row];
          F[t * nph + col] += n1 - (acc[t] + cb) * a.dt;
        }
      }
    }
    __syncthreads();
  }
}

template <int TT>
__global__ void __launch_bounds__(GLE_THREADS)
gle_block_kernel(const GleArgs a) {
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
  float* RS = sm + rs_offset(TT, nph, nb, ncmax);  // staged ring chunk
  const int rsld = rs_ld(ncmax);
  float* PART = RS + TT * rsld;   // [NG][3][TT][ncmax] group partial sums

  for (int i = tid; i < TT * nph; i += GLE_THREADS) {
    const int t = i / nph;
    const size_t g = (size_t)tr0 * nph + i;
    const bool v = t < ntt;
    P[i] = v ? a.p_in[g] : 0.f;
    Q[i] = v ? a.q_in[g] : 0.f;
    PF[i] = v ? a.pf_in[g] : 0.f;
  }
  for (int i = tid; i < 2 * nb * TT * ncmax; i += GLE_THREADS) FB[i] = 0.f;
  __syncthreads();

  for (int s = 0; s < blk; ++s) {
    const int nr0 = (a.t0 + s) % a.nmd, nr1 = (a.t0 + s + 1) % a.nmd;
    if (!a.free_) {
      neg_matvec<TT>(a.dyn, Q, PF, nph);
      __syncthreads();
    }
    // kinetic energy of the pre-step state
    for (int t = warp; t < ntt; t += nwarp) {
      float e = 0.f;
      for (int i = lane; i < nph; i += 32) e += P[t * nph + i] * P[t * nph + i];
      e = warp_sum(e);
      if (lane == 0) a.etot[(size_t)(tr0 + t) * blk + s] = 0.5f * e;
    }
    // ring push of the pre-step p: row block-1-s
    for (int b = 0; b < nb; ++b) {
      const GleBath& B = a.baths[b];
      for (int i = tid; i < ntt * B.nc; i += GLE_THREADS) {
        const int t = i / B.nc, c = i % B.nc;
        B.ring[((size_t)(tr0 + t) * blk + (blk - 1 - s)) * B.nc + c] =
            P[t * nph + B.cids[c]];
      }
    }
    __syncthreads();  // ring rows visible to the whole CTA

    // predictor bath forces and corrector bases
    for (int b = 0; b < nb; ++b) {
      const GleBath& B = a.baths[b];
      const int nc = B.nc, ncs = B.ncs;
      // PART is sized for the widest bath's group count
      const int ng = min(n_groups(nc), n_groups(ncmax));
      const int ncp = round_up(nc, 32);
      const int g = tid / ncp, ar = tid % ncp;
      const bool act = g < ng && ar < nc;
      float A1[TT], A0[TT], AK[TT];
#pragma unroll
      for (int t = 0; t < TT; ++t) A1[t] = A0[t] = AK[t] = 0.f;
      for (int c0 = 0; c0 <= s; c0 += GLE_CH) {
        const int kc = min(GLE_CH, s + 1 - c0);
        __syncthreads();  // the previous chunk (or bath) is done with RS, PART
        const int rows = (kc + 1) * ncs;
        for (int i = tid; i < TT * rows; i += GLE_THREADS) {
          const int t = i / rows, r = i % rows;
          const int j = r / ncs, col = r % ncs;
          const int grow = blk - 1 - s + c0 + j;
          float v = 0.f;
          if (t < ntt && col < nc && grow < blk)
            v = B.ring[((size_t)(tr0 + t) * blk + grow) * nc + col];
          RS[t * rsld + j * ncs + col] = v;
        }
        __syncthreads();
        if (act) {
          for (int k = g; k < kc; k += ng) {
            const float* kt = B.kinT + (size_t)(c0 + k) * ncs * nc + ar;
            const float* r1 = RS + k * ncs;
#pragma unroll 2
            for (int b4 = 0; b4 < ncs; b4 += 4) {
              const float k0 = __ldg(kt + (size_t)b4 * nc);
              const float k1 = __ldg(kt + (size_t)(b4 + 1) * nc);
              const float k2 = __ldg(kt + (size_t)(b4 + 2) * nc);
              const float k3 = __ldg(kt + (size_t)(b4 + 3) * nc);
#pragma unroll
              for (int t = 0; t < TT; ++t) {
                const float4 x1 =
                    *reinterpret_cast<const float4*>(r1 + t * rsld + b4);
                const float4 x0 =
                    *reinterpret_cast<const float4*>(r1 + t * rsld + ncs + b4);
                A1[t] = fmaf(k3, x1.w, fmaf(k2, x1.z,
                        fmaf(k1, x1.y, fmaf(k0, x1.x, A1[t]))));
                A0[t] = fmaf(k3, x0.w, fmaf(k2, x0.z,
                        fmaf(k1, x0.y, fmaf(k0, x0.x, A0[t]))));
              }
            }
          }
        }
      }
      if (act) {
        for (int c = g; c < nc; c += ng) {
          const float kv = B.K0[ar * nc + c];
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
      __syncthreads();
      for (int i = tid; i < ntt * nc; i += GLE_THREADS) {
        const int t = i / nc, row = i % nc;
        float s1 = 0.f, s0 = 0.f, sk = 0.f;
        for (int gg = 0; gg < ng; ++gg) {
          s1 += PART[((gg * 3 + 0) * TT + t) * ncmax + row];
          s0 += PART[((gg * 3 + 1) * TT + t) * ncmax + row];
          sk += PART[((gg * 3 + 2) * TT + t) * ncmax + row];
        }
        const float* Ot = B.O + (size_t)(tr0 + t) * (blk + 1) * nc;
        const float n0 = B.noise[((size_t)(tr0 + t) * a.nmd + nr0) * nc + row];
        const float conv = sk + s0 + Ot[(size_t)s * nc + row];
        FB[(b * TT + t) * ncmax + row] = n0 - conv * a.dt;
        CB[(b * TT + t) * ncmax + row] = s1 + Ot[(size_t)(s + 1) * nc + row];
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

    neg_matvec<TT>(a.dyn, QT, PF2, nph);
    __syncthreads();
    bath_sum<TT>(a, PH, PF2, CB, F, tr0, ntt, nr1);
    for (int i = tid; i < TT * nph; i += GLE_THREADS)
      PT[i] = PH[i] + a.hdt * F[i];
    __syncthreads();
    bath_sum<TT>(a, PT, PF2, CB, F, tr0, ntt, nr1);

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
    a.p_out[g] = P[i];
    a.q_out[g] = Q[i];
    a.pf_out[g] = PF[i];
  }
}

template <int TT>
static int launch(const GleArgs& a, cudaStream_t stream) {
  const int bytes = smem_floats(TT, a.nph, a.nb, a.ncmax) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gle_block_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.ntraj + TT - 1) / TT;
  gle_block_kernel<TT><<<grid, GLE_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int gle_block_smem_bytes(int tt, int nph, int nb, int ncmax) {
  return smem_floats(tt, nph, nb, ncmax) * (int)sizeof(float);
}

extern "C" int gle_block_f32(const GleArgs* args, void* stream) {
  const GleArgs a = *args;
  if (a.nb < 1 || a.nb > GLE_MAX_BATHS || a.ntraj < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.tt) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
