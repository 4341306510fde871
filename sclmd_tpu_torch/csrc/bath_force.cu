// K7 — bath_force: one bath-force evaluation of the plain GLE step for
// every bath of every trajectory, with the Verlet update of that
// evaluation fused in (float32, sm_90a).
//
// Per bath, on its DOFs cids, with this evaluation's noise row n:
//   fb = n - s (M [x; h; q] + tail),   M = [Mv | Mh | -Mq / s]
// non-local phonon bath: s = dt, Mv = K0, Mh = K1, tail = K6's column;
// local phonon bath:     s = 1,  Mv = K0;
// electron bath:         s = 1,  Mv = efric (+ bias zeta2),
//                        Mq = bias (exim - zeta1) when bias terms are on.
// f = pf + sum_b scatter(fb). Stage 0 (predictor) writes pthalf = x + dt/2 f,
// qtt = q + dt x + dt^2/2 f, cur_b = fb . x, etot = x.x / 2, pushes x
// onto the history ring and, where asked, writes x and q into the step's
// rows of ps and qs; stage 1 (corrector) writes base + dt/2 f; stage 2
// (last corrector) writes (base + dt/2 f) mask and q mask.
//
// The step a launch runs is read on the card: s = *step + step_off, the
// segment's step word (kernels/step_graph.py) plus the launch's offset.
// From s come the noise row (t0 + s, one more for the correctors, mod
// nmd), the ring's head (-s mod mlr) and push row (head - 1), and the
// output rows of cur, etot, ps and qs, so a launch captured in a CUDA graph
// runs the right step at every replay. The reads go out in the order they
// had with the rows as launch arguments (the noise rows, then the
// vectors, then the first batch of matrix loads), behind the word's load,
// and s comes back from shared memory for the output rows at the end:
// kept in registers across the product, with the matrix loads first, it
// took 96-99 registers against 64-72 on the tiles of one to four, and
// 7-17 % more time a launch on the H100. Staging the rows in buffers of
// fixed address instead, written by the predictor for the launches after
// it, made every stage slower in a step's sequence (K7 is short and its
// time follows its code's size).
//
// Replaces: the Pallas kernel fused_bath_force
// (a5170d2:sclmd_tpu/ops/kernels.py:98, pallas_call at :116), whose live
// successors on the plain path are PhBath.force_pred/force_corr
// (sclmd_tpu/baths.py:559-575) and EBath._markov_force (:234-239), with
// the scatter and Verlet arithmetic of sclmd_tpu/md.py:349-380 around them.
//
// What bounds it on the H100: latency, not bytes. The matrices of a step
// (130 KB at the primary shapes, 180 KB at the flagship's) sit in L2, the
// state is a few KB, and the evaluation is a chain of dependent phases
// (indices, gather, product, scatter, update). With one trajectory there
// is one CTA on a card of 132 SMs, so the time is the sum of that chain's
// round trips (about half a microsecond each, more on a first touch), and
// a warp that waits for a load issues nothing behind it. The design
// shortens the chain:
//  * a bath's matrices are packed into ONE operand along the reduction
//    axis, stored transposed (MT[k][a], rows padded to 4 floats), so the
//    bath is one product with K = nc, 2 nc or 3 nc;
//  * the CTA's threads are dealt out to the baths (all baths at once), and
//    a bath's threads to (K slice, 4 output rows): consecutive threads load
//    consecutive float4s of MT, and a thread issues a whole batch of its
//    matrix loads before the first FMA;
//  * with one or two trajectories per CTA every global read of the
//    evaluation (indices, x, h, q, base, mask, potential force, noise row,
//    tail) goes out at the start as 4-byte cp.async into shared memory,
//    none waiting for another, with the first batch of matrix loads behind
//    them: one round trip for all of it. The gather through the indices
//    and the Verlet update then read shared memory only. A system whose
//    five staged vectors do not fit (launch_plan's staged is 0: above
//    ~9,000 DOFs, the silicon slab's 10,368) reads x, h, q, base and mask
//    from global memory as a tile of four or eight does, with the same
//    arithmetic, so the bits do not change with the route;
//  * the K slices' partial sums meet in shared memory and are added in
//    slice order: no float atomics, a run is reproducible bit for bit;
//  * where no two baths share a DOF (the host checks) the forces go onto
//    the total in the same phase; baths that share DOFs take turns.
// With many trajectories a CTA owns TT of them, so every matrix element
// it loads feeds TT FMAs and L2 traffic falls with the tile; the CTAs are
// then many and hide each other's round trips.

#include <cuda_runtime.h>
#include <stdint.h>

#define BF_MAX_BATHS 4
#define BF_THREADS 512

struct BfBath {
  const float* noise;  // (ntraj, nmd, nc)
  const float* MT;     // (K, ld) packed transposed operand, 16-byte aligned
  const float* tail;   // (ntraj, nc, 2), or null
  const int* cids;     // (nc,) distinct
  float* fb;           // (ntraj, nc) out, or null
  int nc, ld, K;       // ld = nc rounded up to 4; K = nc * (matrices)
  int src1, src2;      // what matrices 1 and 2 act on: 1 = h, 2 = q
  int t0, nt;          // this bath's threads [t0, t0 + nt)
  int ncol, nsl;       // threads along the float4 columns; K slices
  // shared-memory offsets, in floats: gathered vectors, partial sums,
  // noise then force, staged tail, indices (from ci_off)
  int v_off, p_off, z_off, tl_off, c_off;
  float s;
};

struct BfArgs {
  const float* x;      // (ntraj, nph) velocity the friction acts on
  const float* q;      // (ntraj, nph) displacement
  const float* pf;     // (ntraj, nph) potential force
  // second friction tap, row stride h_stride, or null: stage 0 the ring
  // (ntraj, mlr, nph), read at the head row; stages 1, 2 the pre-step p
  const float* h;
  const float* base;   // (ntraj, nph) pthalf (stages 1, 2)
  const float* mask;   // (nph,) (stage 2)
  float* out_p;
  float* out_q;
  float* f_out;        // (ntraj, nph) total force, or null
  float* cur;          // row stride cur_stride, nb entries (stage 0)
  float* etot;         // row stride etot_stride (stage 0)
  float* push;         // the ring (row push), row stride push_stride, or null
  float* ps;           // stage 0: x at the step's row, or null
  float* qs;           // stage 0: q at the step's row, or null
  const int* step;     // the segment's step word
  // cur, etot, ps and qs: a row stride per trajectory (*_stride) and per
  // step (*_step)
  long long h_stride, push_stride, cur_stride, etot_stride, ps_stride,
      qs_stride, cur_step, etot_step, ps_step, qs_step;
  int ntraj, nph, nb, nmd, t0, step_off, mlr, stage, tt, tail_col;
  // shared-memory offsets, in floats: the force, staged x, h, q, base and
  // mask, the baths' indices; then the bytes in all
  int f_off, xs_off, hs_off, qs_off, bs_off, ms_off, ci_off, smem_bytes;
  int disjoint;        // no two baths share a DOF
  int staged;          // x, h, q, base and mask staged (tt <= 2 only)
  int need_h, need_q;  // some bath's operand acts on h, on q
  float dt, hdt, dt2h;
  BfBath baths[BF_MAX_BATHS];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// TT trajectories per CTA, U matrix loads (float4) in flight per thread
template <int TT, int U>
__global__ void __launch_bounds__(BF_THREADS)
bath_force_kernel(const BfArgs a) {
  constexpr int NT = BF_THREADS;
  extern __shared__ __align__(128) float sm[];
  // one or two trajectories per CTA: the latency form, everything staged
  // where it fits in shared memory (launch_plan's staged), else read from
  // global memory as a larger tile reads it
  const bool STAGED = TT <= 2 && a.staged;
  const int nph = a.nph;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr0 = blockIdx.x * TT;
  const int ntt = min(TT, a.ntraj - tr0);
  const size_t g0 = (size_t)tr0 * nph;
  float* F = sm + a.f_off;        // [TT][nph] total force
  float* XS = sm + a.xs_off;      // staged x
  float* HS = sm + a.hs_off;      // staged h
  float* QS = sm + a.qs_off;      // staged q
  float* BS = sm + a.bs_off;      // staged base (stages 1, 2)
  float* MS = sm + a.ms_off;      // staged mask (stage 2)
  int* CI = reinterpret_cast<int*>(sm + a.ci_off);  // the baths' cids

  // this thread's bath, K slice and float4 column
  const float4* MT4 = nullptr;
  int K = 0, ld4 = 0, nsl = 1, ncol = 1, sl = 0, col = 0, v_off = 0,
      p_off = 0;
  bool active = false;
#pragma unroll
  for (int i = 0; i < BF_MAX_BATHS; ++i) {
    if (i < a.nb) {
      const BfBath& B = a.baths[i];
      const int tl = tid - B.t0;
      if (tl >= 0 && tl < B.nt) {
        MT4 = reinterpret_cast<const float4*>(B.MT);
        K = B.K, ld4 = B.ld >> 2, nsl = B.nsl, ncol = B.ncol;
        sl = tl / ncol, col = tl - sl * ncol;
        v_off = B.v_off, p_off = B.p_off;
        active = sl < nsl;
      }
    }
  }

  float4 m[U];

  // every global read of the evaluation that does not wait for the
  // indices goes out here, asynchronously and at once, behind the step
  // word's load, the first batch of matrix loads behind them: one round
  // trip after the word's, whatever depends on what
  __shared__ int step_sh;   // s, for the output rows at the end
  const int s = *a.step + a.step_off;
  if (tid == 0) step_sh = s;
  const int row = (a.t0 + s + (a.stage != 0)) % a.nmd;
#pragma unroll
  for (int i = 0; i < BF_MAX_BATHS; ++i) {
    if (i < a.nb) {
      const BfBath& B = a.baths[i];
      const int nc = B.nc;
      for (int c = tid; c < nc; c += NT)
        cp_async4(CI + B.c_off + c, B.cids + c);
      for (int idx = tid; idx < ntt * nc; idx += NT) {
        const int t = idx / nc, c = idx - t * nc;
        const size_t r = (size_t)(tr0 + t);
        cp_async4(sm + B.z_off + idx, B.noise + (r * a.nmd + row) * nc + c);
        if (B.tail)
          cp_async4(sm + B.tl_off + idx,
                    B.tail + (r * nc + c) * 2 + a.tail_col);
      }
    }
  }
  const int head = a.stage == 0 ? (a.mlr - s % a.mlr) % a.mlr : 0;
  const float* H = a.h + (size_t)head * nph;   // the second tap's row
  for (int i = tid; i < ntt * nph; i += NT) {
    cp_async4(F + i, a.pf + g0 + i);
    if (STAGED) {
      cp_async4(XS + i, a.x + g0 + i);
      if (a.need_q) cp_async4(QS + i, a.q + g0 + i);
      if (a.stage != 0) cp_async4(BS + i, a.base + g0 + i);
      if (a.need_h) {
        const int t = i / nph;
        cp_async4(HS + i, H + (size_t)(tr0 + t) * a.h_stride + (i - t * nph));
      }
    }
  }
  if (STAGED && a.stage == 2)
    for (int i = tid; i < nph; i += NT) cp_async4(MS + i, a.mask + i);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = sl + u * nsl;
    m[u] = (active && k < K) ? __ldg(MT4 + (size_t)k * ld4 + col)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // each bath's [x; h; q] on its DOFs: out of the staged vectors, or (many
  // trajectories per CTA) out of global memory, again without waiting
#pragma unroll
  for (int i = 0; i < BF_MAX_BATHS; ++i) {
    if (i < a.nb) {
      const BfBath& B = a.baths[i];
      const int nc = B.nc, Kb = B.K;
      float* V = sm + B.v_off;
      const int* ci = CI + B.c_off;
      for (int idx = tid; idx < TT * Kb; idx += NT) {
        const int t = idx / Kb, k = idx - t * Kb;
        const int mi = k / nc, c = k - mi * nc;
        const int src = mi == 0 ? 0 : (mi == 1 ? B.src1 : B.src2);
        if (t >= ntt) {
          V[idx] = 0.f;
        } else if (STAGED) {
          const float* S = src == 0 ? XS : (src == 1 ? HS : QS);
          V[idx] = S[t * nph + ci[c]];
        } else {
          const size_t r = (size_t)(tr0 + t);
          cp_async4(V + idx, src == 0   ? a.x + r * nph + ci[c]
                             : src == 1 ? H + r * a.h_stride + ci[c]
                                        : a.q + r * nph + ci[c]);
        }
      }
    }
  }
  if (!STAGED) asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // the product: this thread's K slice of 4 output rows, TT trajectories
  if (active) {
    const float* V = sm + v_off;
    float* P = sm + p_off;
    for (int c4 = col; c4 < ld4; c4 += ncol) {
      float acc[TT][4];
#pragma unroll
      for (int t = 0; t < TT; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      for (int j0 = 0; sl + j0 * nsl < K; j0 += U) {
        if (c4 != col || j0 != 0) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int k = sl + (j0 + u) * nsl;
            m[u] = k < K ? __ldg(MT4 + (size_t)k * ld4 + c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = sl + (j0 + u) * nsl;
          if (k < K) {
#pragma unroll
            for (int t = 0; t < TT; ++t) {
              const float v = V[t * K + k];
              acc[t][0] += m[u].x * v;
              acc[t][1] += m[u].y * v;
              acc[t][2] += m[u].z * v;
              acc[t][3] += m[u].w * v;
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < TT; ++t)
        *reinterpret_cast<float4*>(P + (size_t)(sl * TT + t) * (ld4 * 4) +
                                   c4 * 4) =
            make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
    }
  }
  __syncthreads();

  // the slices' partial sums, added in slice order: fb = n - s (M v + tail);
  // where no two baths share a DOF the forces go onto F here as well
#pragma unroll
  for (int i = 0; i < BF_MAX_BATHS; ++i) {
    if (i < a.nb) {
      const BfBath& B = a.baths[i];
      const int nc = B.nc, ld = B.ld;
      const float* P = sm + B.p_off;
      float* Z = sm + B.z_off;
      const int* ci = CI + B.c_off;
      for (int idx = tid; idx < ntt * nc; idx += NT) {
        const int t = idx / nc, c = idx - t * nc;
        float s_ = 0.f;
#pragma unroll 8
        for (int j = 0; j < B.nsl; ++j) s_ += P[(size_t)(j * TT + t) * ld + c];
        if (B.tail) s_ += sm[B.tl_off + idx];
        const float fb = Z[idx] - B.s * s_;
        Z[idx] = fb;
        if (B.fb) B.fb[(size_t)(tr0 + t) * nc + c] = fb;
        if (a.disjoint) F[t * nph + ci[c]] += fb;
      }
    }
  }
  __syncthreads();

  // baths that share DOFs: onto the force bath after bath
  if (!a.disjoint) {
#pragma unroll
    for (int i = 0; i < BF_MAX_BATHS; ++i) {
      if (i < a.nb) {
        const BfBath& B = a.baths[i];
        const int nc = B.nc;
        const float* Z = sm + B.z_off;
        const int* ci = CI + B.c_off;
        for (int idx = tid; idx < ntt * nc; idx += NT) {
          const int t = idx / nc, c = idx - t * nc;
          F[t * nph + ci[c]] += Z[idx];
        }
        __syncthreads();
      }
    }
  }
  const int se = step_sh;
  // the predictor's heat currents, a warp per (bath, trajectory)
  if (a.stage == 0 && a.cur) {
#pragma unroll
    for (int i = 0; i < BF_MAX_BATHS; ++i) {
      if (i < a.nb) {
        const BfBath& B = a.baths[i];
        const float* Z = sm + B.z_off;
        const float* V = sm + B.v_off;
        for (int t = warp - i * TT; t < ntt; t += NT / 32) {
          if (t < 0) continue;
          float c = 0.f;
          for (int j = lane; j < B.nc; j += 32)
            c += Z[t * B.nc + j] * V[t * B.K + j];
          c = warp_sum(c);
          if (lane == 0)
            a.cur[(size_t)(tr0 + t) * a.cur_stride + se * a.cur_step + i] = c;
        }
      }
    }
  }

  for (int i = tid; i < ntt * nph; i += NT) {
    const size_t g = g0 + i;
    const float f = F[i];
    if (a.f_out) a.f_out[g] = f;
    if (a.stage == 0) {
      const float x = STAGED ? XS[i] : a.x[g];
      const float q = STAGED ? QS[i] : a.q[g];
      a.out_p[g] = x + f * a.hdt;
      a.out_q[g] = q + x * a.dt + f * a.dt2h;
      if (a.push || a.ps || a.qs) {
        const int t = i / nph, j = i - t * nph;
        const size_t r = (size_t)(tr0 + t);
        // the push row, the one before the head: -se - 1 mod mlr
        if (a.push) {
          const int pr = a.mlr - 1 - se % a.mlr;
          a.push[r * a.push_stride + (size_t)pr * nph + j] = x;
        }
        if (a.ps) a.ps[r * a.ps_stride + se * a.ps_step + j] = x;
        if (a.qs) a.qs[r * a.qs_stride + se * a.qs_step + j] = q;
      }
    } else if (a.stage == 1) {
      const float b = STAGED ? BS[i] : a.base[g];
      a.out_p[g] = b + a.hdt * f;
    } else {
      const int j = i % nph;
      const float b = STAGED ? BS[i] : a.base[g];
      const float q = STAGED ? QS[i] : a.q[g];
      const float mk = STAGED ? MS[j] : a.mask[j];
      a.out_p[g] = (b + a.hdt * f) * mk;
      a.out_q[g] = q * mk;
    }
  }
  if (a.stage == 0 && a.etot) {
    for (int t = warp; t < ntt; t += NT / 32) {
      float e = 0.f;
      for (int i = lane; i < nph; i += 32) {
        const float x = STAGED ? XS[t * nph + i]
                               : a.x[g0 + (size_t)t * nph + i];
        e += x * x;
      }
      e = warp_sum(e);
      if (lane == 0)
        a.etot[(size_t)(tr0 + t) * a.etot_stride + se * a.etot_step] =
            0.5f * e;
    }
  }
}

template <int TT, int U>
static int launch(const BfArgs& a, cudaStream_t st) {
  static int allowed = 0;   // largest dynamic shared memory set so far
  if (a.smem_bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        bath_force_kernel<TT, U>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = a.smem_bytes;
  }
  bath_force_kernel<TT, U>
      <<<(a.ntraj + TT - 1) / TT, BF_THREADS, a.smem_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int bath_force_f32(const BfArgs* args, void* stream) {
  const BfArgs& a = *args;
  if (a.nb < 0 || a.nb > BF_MAX_BATHS || a.ntraj < 1 || a.nph < 1 ||
      a.stage < 0 || a.stage > 2 || !a.step || a.nmd < 1 ||
      (a.stage == 0 && a.mlr < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.tt) {
    case 1: return launch<1, 8>(a, st);
    case 2: return launch<2, 8>(a, st);
    case 4: return launch<4, 8>(a, st);
    case 8: return launch<8, 6>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int bath_force_threads(void) { return BF_THREADS; }

// An empty kernel: its device time is what any launch costs on this card,
// the floor under K7's time that no design of the kernel removes.
__global__ void bath_force_noop_kernel() {}

extern "C" int bath_force_noop(void* stream) {
  bath_force_noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
