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
//    and the Verlet update then read shared memory only. The launch
//    form that leaves them in global memory (the flag staged = 0) reads
//    x, h, q, base and mask as a tile of four or eight does, with the
//    same arithmetic, so the bits do not change with that flag;
//  * the K slices' partial sums meet in shared memory and are added in
//    slice order: no float atomics, a run is reproducible bit for bit;
//  * where no two baths share a DOF (the host checks) the forces go onto
//    the total in the same phase; baths that share DOFs take turns.
// With many trajectories a CTA owns TT of them, so every matrix element
// it loads feeds TT FMAs and L2 traffic falls with the tile; the CTAs are
// then many and hide each other's round trips.
//
// The wide route (bath_force_kernel_wide, below the tiled kernel): a
// system whose five staged vectors do not fit at a tile of one or two
// (launch_plan's staged is 0: above ~9,000 DOFs, the silicon slab's
// 10,368) cannot take a larger tile either, since a CTA holds the force
// of its whole trajectories, so there a CTA of one trajectory read both
// baths' matrices in full (2 x 864 x 864 floats, 6 MB) for that one
// trajectory: 64 CTAs pulled 382 MB out of L2 a launch on 64 of the 132
// SMs, bound by the L2-to-SM bandwidth. The wide route makes the bath
// force a product over trajectories instead, in one launch of two kinds
// of CTA:
//  * a product CTA owns (bath, BW_R rows of it, BW_N trajectories). Two
//    producer warps copy its rows of MT (16 bytes a copy) and the gathered
//    [x; h; q] of its trajectories (4 bytes, a warp 32 consecutive
//    indices) chunk by chunk into a ring of BW_NS stages by cp.async, with
//    a full and an empty mbarrier a stage, as conv_tails does; eight
//    consumer warps take slices of each chunk's reduction rows (FFMA,
//    float32: the product is not worth the tensor cores). An element of
//    MT is read once per BW_N trajectories, the gathered columns once per
//    BW_R rows. The copies are what bounds the loop: an SM took them in at
//    ~17 bytes a clock (H100), whichever warps issued them, and while all
//    warps both copied and computed the two took turns (25 us a launch at
//    the slab's shapes against 22 us with the split; bulk copies of a row
//    each, 64-128 bytes, took 55 us). The epilogue adds the consumer
//    warps' partial sums in warp order, forms fb = n - s (M v + tail) and
//    writes fb and the stage's outputs on the CTA's own bath DOFs, which
//    needs disjoint baths (the host checks; baths that share DOFs keep
//    the tiled kernel);
//  * an update CTA owns one trajectory: the stage's Verlet update on
//    every DOF of no bath, what does not need the force on all DOFs (the
//    ring push, ps, qs, the last stage's q), and etot in one fixed-order
//    pass. It waits on nothing.
// The predictor's heat currents cur_b = fb . x are summed per row tile,
// and the last product CTA of a (bath, trajectory tile), by a ticket,
// adds the row tiles in order and resets the ticket, as conv_tails does:
// no float atomics, a run repeats bit for bit. The wide route sums in
// another order than the tiled kernel, so its bits differ from it.

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

// --- the wide route: the bath force as a product over trajectories ---------

#define BW_CWARPS 8                 // a product CTA's consumer warps
#define BW_PWARPS 2                 // its producer warps
#define BW_CT (32 * BW_CWARPS)      // consumer threads
#define BW_PT (32 * BW_PWARPS)      // producer threads
#define BW_THREADS (BW_CT + BW_PT)
#define BW_WARPS (BW_THREADS / 32)
#define BW_R 16                     // bath rows a product CTA owns
#define BW_N 64                     // trajectories it owns, two a lane
#define BW_KC 64                    // reduction rows a stage of the ring holds
#define BW_KW (BW_KC / BW_CWARPS)   // of those, a consumer warp's
#define BW_NS 4                     // stages in the ring
#define BW_VS (BW_KC + 1)           // row stride of the gathered tile
#define BW_PS (BW_R + 1)            // row stride of the partial sums
#define BW_U 8                      // DOFs an update thread loads at once
#define BW_SEG (BW_CT / BW_N)       // segments of the currents' last sum
#define BW_RED 8                    // loads in flight in that sum
#define BW_EPI (BW_N * BW_R / BW_CT)  // outputs a consumer's epilogue

// shared memory, in floats: the ring (a stage: the operand's BW_KC x BW_R
// tile, then the gathered [t][k] tile), in the epilogue the consumer warps'
// partial sums [warp][t][r] and the current terms [t][r] over it; then the
// bath's indices from BW_CI
constexpr int BW_STAGE = BW_KC * BW_R + BW_N * BW_VS;
constexpr int BW_RING = BW_NS * BW_STAGE;
constexpr int BW_EPIF = (BW_CWARPS + 1) * BW_N * BW_PS;
constexpr int BW_CI = BW_RING > BW_EPIF ? BW_RING : BW_EPIF;
static_assert(BW_PT == BW_KC && BW_KC % BW_CWARPS == 0 && BW_R % 4 == 0 &&
                  BW_N == 64 && BW_CT % BW_N == 0 &&
                  (BW_N * BW_R) % BW_CT == 0 && BW_STAGE % 4 == 0,
              "wide route tile");

struct BwArgs {
  BfArgs a;                   // the arguments (the tiled plan's offsets unused)
  float* part;                // (nprod, BW_N) partial heat currents
  unsigned* tickets;          // (nb, ntiles), zero between launches
  const unsigned char* bath_dof;  // (nph,) 1 on a DOF of some bath
  int nprod, ntiles, smem_bytes;
  int nrt[BF_MAX_BATHS];      // row tiles of each bath
  int p0[BF_MAX_BATHS];       // its first product CTA
};

// a product CTA's bath
struct BwBath {
  const float* MT;
  const float* noise;
  const float* tail;
  const int* cids;
  float* fb;
  int nc, ld, K, src1, src2;
  float s;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void bw_mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bw_mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bw_mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "BW_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra BW_DONE;\n"
      "bra BW_WAIT;\n"
      "BW_DONE:\n"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// this thread's earlier cp.async copies arrive on the barrier when done
__device__ __forceinline__ void bw_cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// a producer thread's copies of chunk c into stage st of the ring: BW_KC
// rows of the operand's columns [a0, a0 + BW_R), 16 bytes a copy, and the
// chunk's reduction row pt of [x; h; q] at the bath's DOFs (CI) for the
// tile's trajectories, a warp's copies 32 consecutive rows. Nothing past
// K, ld or ntt is copied: the consumers skip rows past K, and a column or
// trajectory past the end only feeds sums that are never written
__device__ __forceinline__ void bw_copy(const BfArgs& a, const BwBath& B,
                                        const float* H, const int* CI,
                                        float* sm, int c, int st, int a0,
                                        int tr0, int ntt, int pt) {
  float* MS = sm + st * BW_STAGE;
  float* V = MS + BW_KC * BW_R;
  const int k0 = c * BW_KC;
  for (int i = pt; i < BW_KC * (BW_R / 4); i += BW_PT) {
    const int kk = i / (BW_R / 4), col = a0 + 4 * (i - kk * (BW_R / 4));
    if (k0 + kk < B.K && col < B.ld)
      cp_async16(MS + kk * BW_R + (col - a0),
                 B.MT + (size_t)(k0 + kk) * B.ld + col);
  }
  const int k = k0 + pt;
  if (k < B.K) {
    const int mi = k / B.nc, ci = k - mi * B.nc;
    const int which = mi == 0 ? 0 : (mi == 1 ? B.src1 : B.src2);
    const float* src = (which == 0 ? a.x : (which == 1 ? H : a.q)) + CI[ci] +
                       (size_t)tr0 * (which == 1 ? a.h_stride : a.nph);
    const long long stride = which == 1 ? a.h_stride : (long long)a.nph;
    for (int t = 0; t < ntt; ++t, src += stride)
      cp_async4(V + t * BW_VS + pt, src);
  }
}

__device__ __forceinline__ void bw_product(const BwArgs& w, int p, int s,
                                           float* sm) {
  const BfArgs& a = w.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  BwBath B = {};
  int b = 0, nrt = 1, p0 = 0;
#pragma unroll
  for (int i = 0; i < BF_MAX_BATHS; ++i) {
    if (i < a.nb && p >= w.p0[i]) {
      const BfBath& S = a.baths[i];
      B.MT = S.MT, B.noise = S.noise, B.tail = S.tail, B.cids = S.cids;
      B.fb = S.fb, B.nc = S.nc, B.ld = S.ld, B.K = S.K, B.src1 = S.src1;
      B.src2 = S.src2, B.s = S.s;
      b = i, nrt = w.nrt[i], p0 = w.p0[i];
    }
  }
  const int pl = p - p0, tile = pl / nrt, rt = pl - tile * nrt;
  const int tr0 = tile * BW_N, ntt = min(BW_N, a.ntraj - tr0);
  const int a0 = rt * BW_R;
  const int row = (a.t0 + s + (a.stage != 0)) % a.nmd;
  const int head = a.stage == 0 ? (a.mlr - s % a.mlr) % a.mlr : 0;
  const float* H = a.h + (size_t)head * a.nph;   // the second tap's row
  int* CI = reinterpret_cast<int*>(sm + BW_CI);
  // per stage of the ring: full (the producers' copies landed) and empty
  // (every consumer warp is done with it)
  __shared__ __align__(8) uint64_t bars[2 * BW_NS];
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + BW_NS);
  if (tid == 0) {
    for (int i = 0; i < BW_NS; ++i) {
      bw_mbar_init(full0 + 8 * i, BW_PT);
      bw_mbar_init(empty0 + 8 * i, BW_CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the bath's indices first: every gather's address needs them
  for (int c = tid; c < B.nc; c += BW_THREADS) CI[c] = __ldg(B.cids + c);
  __syncthreads();

  const int nch = (B.K + BW_KC - 1) / BW_KC;
  // consumers: rows [a0, a0 + BW_R) for trajectories lane and lane + 32,
  // over this warp's slice of every chunk
  float acc[2][BW_R];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < BW_R; ++r) acc[j][r] = 0.f;
  if (warp >= BW_CWARPS) {
    // producers: wait until a stage is free, copy the next chunk into it
    const int pt = tid - BW_CT;
    for (int c = 0, st = 0, ph = 1; c < nch; ++c) {
      bw_mbar_wait(empty0 + 8 * st, ph);
      bw_copy(a, B, H, CI, sm, c, st, a0, tr0, ntt, pt);
      bw_cp_async_arrive(full0 + 8 * st);
      if (++st == BW_NS) st = 0, ph ^= 1;
    }
  } else for (int c = 0, st = 0, ph = 0; c < nch; ++c) {
    bw_mbar_wait(full0 + 8 * st, ph);
    const float* MS = sm + st * BW_STAGE;
    const float* V = MS + BW_KC * BW_R;
    const int kend = B.K - c * BW_KC;   // rows past K hold no copy
#pragma unroll
    for (int j = 0; j < BW_KW; ++j) {
      const int kk = warp * BW_KW + j;
      if (kk >= kend) break;
      const float v0 = V[lane * BW_VS + kk];
      const float v1 = V[(lane + 32) * BW_VS + kk];
      const float4* m4 = reinterpret_cast<const float4*>(MS + kk * BW_R);
#pragma unroll
      for (int r4 = 0; r4 < BW_R / 4; ++r4) {
        const float4 m = m4[r4];   // the same address in every lane
        acc[0][4 * r4 + 0] += m.x * v0;
        acc[0][4 * r4 + 1] += m.y * v0;
        acc[0][4 * r4 + 2] += m.z * v0;
        acc[0][4 * r4 + 3] += m.w * v0;
        acc[1][4 * r4 + 0] += m.x * v1;
        acc[1][4 * r4 + 1] += m.y * v1;
        acc[1][4 * r4 + 2] += m.z * v1;
        acc[1][4 * r4 + 3] += m.w * v1;
      }
    }
    __syncwarp();
    if (lane == 0) bw_mbar_arrive(empty0 + 8 * st);
    if (++st == BW_NS) st = 0, ph ^= 1;
  }
  __syncthreads();   // every chunk consumed: the ring is free

  float* P = sm;                              // [warp][t][r], over the ring
  float* W = sm + BW_CWARPS * BW_N * BW_PS;   // [t][r]: fb x
  if (warp < BW_CWARPS) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < BW_R; ++r)
        P[(warp * BW_N + lane + 32 * j) * BW_PS + r] = acc[j][r];
  }
  __syncthreads();

  // the epilogue: every read of a consumer's outputs at once, then
  // fb = n - s (M v + tail), the consumer warps' partial sums added in
  // warp order, and the stage's outputs on this tile's bath DOFs
  float nv[BW_EPI], tv[BW_EPI], pv[BW_EPI], xv[BW_EPI], qv[BW_EPI],
      mv[BW_EPI];
  const bool cons = tid < BW_CT;
#pragma unroll
  for (int e = 0; e < BW_EPI; ++e) {
    const int idx = tid + e * BW_CT;
    const int t = idx / BW_R, c = a0 + idx - t * BW_R;
    nv[e] = tv[e] = pv[e] = xv[e] = qv[e] = mv[e] = 0.f;
    if (cons && t < ntt && c < B.nc) {
      const size_t tr = (size_t)(tr0 + t);
      const int d = CI[c];
      const size_t g = tr * a.nph + d;
      nv[e] = B.noise[(tr * a.nmd + row) * B.nc + c];
      if (B.tail) tv[e] = B.tail[(tr * B.nc + c) * 2 + a.tail_col];
      pv[e] = a.pf[g];
      xv[e] = a.stage == 0 ? a.x[g] : a.base[g];
      if (a.stage == 0) qv[e] = a.q[g];
      if (a.stage == 2) mv[e] = a.mask[d];
    }
  }
#pragma unroll
  for (int e = 0; e < BW_EPI; ++e) {
    const int idx = tid + e * BW_CT;
    const int t = idx / BW_R, r = idx - t * BW_R, c = a0 + r;
    if (!cons) break;
    float term = 0.f;
    if (t < ntt && c < B.nc) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < BW_CWARPS; ++k)
        v += P[(k * BW_N + t) * BW_PS + r];
      if (B.tail) v += tv[e];
      const float fb = nv[e] - B.s * v;
      const size_t tr = (size_t)(tr0 + t);
      const size_t g = tr * a.nph + CI[c];
      if (B.fb) B.fb[tr * B.nc + c] = fb;
      const float f = pv[e] + fb;
      if (a.f_out) a.f_out[g] = f;
      if (a.stage == 0) {
        const float x = xv[e];
        a.out_p[g] = x + f * a.hdt;
        a.out_q[g] = qv[e] + x * a.dt + f * a.dt2h;
        term = fb * x;
      } else if (a.stage == 1) {
        a.out_p[g] = xv[e] + a.hdt * f;
      } else {
        a.out_p[g] = (xv[e] + a.hdt * f) * mv[e];
      }
    }
    W[t * BW_PS + r] = term;
  }
  if (a.stage != 0 || !a.cur) return;

  // the predictor's heat currents: this row tile's share in row order,
  // then the last CTA of the (bath, trajectory tile) adds the row tiles
  __syncthreads();
  for (int t = tid; t < BW_N; t += BW_THREADS) {
    float c_ = 0.f;
    for (int r = 0; r < BW_R; ++r) c_ += W[t * BW_PS + r];
    w.part[(size_t)p * BW_N + t] = c_;
  }
  __shared__ unsigned s_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned* tk = w.tickets + b * w.ntiles + tile;
    const unsigned ticket = atomicAdd(tk, 1u);
    s_last = ticket == (unsigned)(nrt - 1);
    if (s_last) *tk = 0u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // segments of the row tiles a thread each, then the segments in order
  const float* pp = w.part + (size_t)(p0 + tile * nrt) * BW_N;
  const int t = tid % BW_N, seg = cons ? tid / BW_N : BW_SEG;
  const int per = (nrt + BW_SEG - 1) / BW_SEG;
  const int j1 = min(nrt, (seg + 1) * per);
  float v = 0.f;
  for (int j0 = seg * per; j0 < j1; j0 += BW_RED) {
    float u[BW_RED];          // all of a batch's loads fly together
#pragma unroll
    for (int k = 0; k < BW_RED; ++k)
      u[k] = j0 + k < j1 ? __ldcg(pp + (size_t)(j0 + k) * BW_N + t) : 0.f;
#pragma unroll
    for (int k = 0; k < BW_RED; ++k)
      if (j0 + k < j1) v += u[k];
  }
  if (cons) W[seg * BW_N + t] = v;
  __syncthreads();
  if (tid < ntt) {
    float c_ = 0.f;
    for (int k = 0; k < BW_SEG; ++k) c_ += W[k * BW_N + tid];
    a.cur[(size_t)(tr0 + tid) * a.cur_stride + s * a.cur_step + b] = c_;
  }
}

// an update CTA: trajectory t's DOFs of no bath, what needs no force on
// all its DOFs, and etot
__device__ __forceinline__ void bw_update(const BwArgs& w, int t, int s) {
  const BfArgs& a = w.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nph = a.nph;
  const size_t g0 = (size_t)t * nph;
  const int pr = a.stage == 0 ? a.mlr - 1 - s % a.mlr : 0;   // the push row
  float e = 0.f;
  for (int j0 = 0; j0 < nph; j0 += BW_THREADS * BW_U) {
    float fv[BW_U], xv[BW_U], qv[BW_U], mv[BW_U];
    int own[BW_U];
#pragma unroll
    for (int u = 0; u < BW_U; ++u) {
      const int j = j0 + u * BW_THREADS + tid;
      fv[u] = xv[u] = qv[u] = mv[u] = 0.f;
      own[u] = 1;
      if (j < nph) {
        const size_t g = g0 + j;
        own[u] = w.bath_dof[j];
        fv[u] = a.pf[g];
        xv[u] = a.stage == 0 ? a.x[g] : a.base[g];
        if (a.stage != 1) qv[u] = a.q[g];
        if (a.stage == 2) mv[u] = a.mask[j];
      }
    }
#pragma unroll
    for (int u = 0; u < BW_U; ++u) {
      const int j = j0 + u * BW_THREADS + tid;
      if (j < nph) {
        const size_t g = g0 + j;
        const float f = fv[u];
        if (!own[u] && a.f_out) a.f_out[g] = f;
        if (a.stage == 0) {
          const float x = xv[u], q = qv[u];
          e += x * x;
          if (!own[u]) {
            a.out_p[g] = x + f * a.hdt;
            a.out_q[g] = q + x * a.dt + f * a.dt2h;
          }
          if (a.push)
            a.push[(size_t)t * a.push_stride + (size_t)pr * nph + j] = x;
          if (a.ps) a.ps[(size_t)t * a.ps_stride + s * a.ps_step + j] = x;
          if (a.qs) a.qs[(size_t)t * a.qs_stride + s * a.qs_step + j] = q;
        } else if (a.stage == 1) {
          if (!own[u]) a.out_p[g] = xv[u] + a.hdt * f;
        } else {
          if (!own[u]) a.out_p[g] = (xv[u] + a.hdt * f) * mv[u];
          a.out_q[g] = qv[u] * mv[u];
        }
      }
    }
  }
  if (a.stage == 0 && a.etot) {
    __shared__ float red[BW_WARPS];
    e = warp_sum(e);
    if (lane == 0) red[warp] = e;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int k = 0; k < BW_WARPS; ++k) sum += red[k];
      a.etot[(size_t)t * a.etot_stride + s * a.etot_step] = 0.5f * sum;
    }
  }
}

// CTAs [0, nprod) are product CTAs, the ntraj after them update CTAs
__global__ void __launch_bounds__(BW_THREADS, 2)
bath_force_kernel_wide(const BwArgs w) {
  extern __shared__ __align__(128) float sm[];
  const int s = *w.a.step + w.a.step_off;
  if ((int)blockIdx.x < w.nprod)
    bw_product(w, blockIdx.x, s, sm);
  else
    bw_update(w, blockIdx.x - w.nprod, s);
}

extern "C" int bath_force_wide_f32(const BwArgs* args, void* stream) {
  const BwArgs& w = *args;
  const BfArgs& a = w.a;
  int maxc = 0;
  for (int i = 0; i < a.nb && i < BF_MAX_BATHS; ++i)
    maxc = a.baths[i].nc > maxc ? a.baths[i].nc : maxc;
  if (a.nb < 1 || a.nb > BF_MAX_BATHS || a.ntraj < 1 || a.nph < 1 ||
      a.stage < 0 || a.stage > 2 || !a.step || a.nmd < 1 ||
      (a.stage == 0 && a.mlr < 1) || w.nprod < 1 || !w.bath_dof ||
      (a.stage == 0 && a.cur && (!w.part || !w.tickets)) ||
      w.smem_bytes < 4 * (BW_CI + maxc))
    return (int)cudaErrorInvalidValue;
  static int allowed = 0;   // largest dynamic shared memory set so far
  if (w.smem_bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        bath_force_kernel_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
        w.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = w.smem_bytes;
  }
  bath_force_kernel_wide<<<w.nprod + a.ntraj, BW_THREADS, w.smem_bytes,
                           (cudaStream_t)stream>>>(w);
  return (int)cudaGetLastError();
}

// the wide route's shape: threads, rows and trajectories of a product
// CTA, reduction rows a stage, stages, and where the indices start in
// shared memory (floats)
extern "C" void bath_force_wide_dims(int* d) {
  d[0] = BW_THREADS, d[1] = BW_R, d[2] = BW_N, d[3] = BW_KC, d[4] = BW_NS;
  d[5] = BW_CI;
}

// An empty kernel: its device time is what any launch costs on this card,
// the floor under K7's time that no design of the kernel removes.
__global__ void bath_force_noop_kernel() {}

extern "C" int bath_force_noop(void* stream) {
  bath_force_noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
