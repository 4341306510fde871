// K6 — conv_tails: the memory-kernel tails of the plain GLE step, for every
// non-local phonon bath (ml > 2) and trajectory (float32, sm_90a).
//
//   tails[t][a][0] = sum_{r=2}^{ml-1} sum_b K[r][a][b] old_t[r-1][b]
//   tails[t][a][1] = sum_{r=2}^{ml-1} sum_b K[r][a][b] old_t[r-2][b]
//   old_t[i][b]    = ring[t][(head + i) % mlr][cids[b]]
//   head           = -s mod mlr,  s = *step + step_off
//
// The step s is read on the card from the segment's step word plus the
// launch's offset (kernels/step_graph.py), so a launch captured in a CUDA
// graph reads the right history rows at every replay.
//
// Replaces: the Pallas kernel memory_conv_tails
// (a5170d2:sclmd_tpu/ops/kernels.py:127, a pallas_call through conv_matmul
// at :72), whose live successor is PhBath.step_plan
// (sclmd_tpu/baths.py:548-557).
//
// What bounds it on the H100: bytes. The slab K[2..ml-1], (ml-2) nc^2
// floats (32.4 MB per bath at nc 90, ml 1000), is read once per step and
// used for two FMAs per element and trajectory; two such baths (64.8 MB)
// exceed the 50 MB L2, so every step streams the slab from HBM. The design
// is a persistent streaming kernel:
//  * about one CTA per SM; the host deals each CTA a contiguous range of
//    taps of one bath (of one slice of its rows where a tap is too large
//    for a stage), balanced by bytes;
//  * a ring of stages in shared memory, filled by four producer warps: the
//    tap's rows by one cp.async.bulk (completion on the stage's mbarrier
//    with expect_tx), the history row the tap brings in (it meets two, one
//    of them the tap before's) by 4-byte cp.async that arrive on the same
//    barrier. The slab is contiguous, so a stage
//    is a flat chunk; bulk copies need 16-byte source, destination and
//    size, so a chunk that starts or ends off a 16-byte boundary (odd nc)
//    moves its first and last floats by 4-byte cp.async and lands at the
//    same offset modulo 16 in shared memory;
//  * 16 consumer warps wait on the full barrier, read K from shared memory
//    (lanes along b: no bank conflicts whatever nc) and release the stage
//    on its empty barrier. A warp owns up to 6 output rows and keeps both
//    tails' sums for them in registers over ALL the CTA's taps; lanes are
//    reduced once, at the end. The loop over a tap has no branch (ragged
//    rows and columns are clamped, not skipped), so a warp's loads of a
//    chunk all go out before its first FMA: a warp's time per tap is what
//    bounds the stream once the bytes arrive fast enough;
//  * the slab is larger than L2 and read again every step: the bulk copies
//    of the first taps of each range carry an evict-last hint, the others
//    evict-first, so that part of the slab is served from L2 every step;
//  * one launch: a CTA writes its partial, fences and takes a ticket; the
//    last CTA of each (trajectory tile, stream) adds the partials in a
//    fixed order and resets the ticket. No float atomics: the same inputs give
//    the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define CT_MAX_BATHS 4
#define CT_CWARPS 16                       // consumer warps
#define CT_PWARPS 4                        // producer warps
#define CT_THREADS (32 * (CT_CWARPS + CT_PWARPS))
#define CT_RPW 6                           // output rows per consumer warp
#define CT_ROWS (CT_CWARPS * CT_RPW)       // most rows of a stream
#define CT_MAX_STAGES 8
#define CT_BAR_BYTES 128                   // full[8], empty[8]
#define CT_DESC 8                          // ints per CTA in the table
#define CT_RED 12                          // partials loaded at once at the end

struct CtBath {
  const float* K;      // (ml, nc, nc), K[r][a][b], 16-byte aligned
  const int* cids;     // (nc,)
  float* out;          // (ntraj, nc, 2)
  int nc, ml;
};

struct CtArgs {
  const float* ring;   // (ntraj, mlr, nph)
  const int* desc;     // (ncta, 8): bath, a0, ra, r0, r1, stream, c0, cn
  float* part;         // (ntiles, ncta, tt, CT_ROWS, 2) partial sums
  unsigned* tickets;   // (ntiles, nstream), zero between launches
  const int* step;     // the segment's step word
  int ntraj, mlr, nph, step_off, nb, ncta, ntiles, nstream, tt;
  int nstage, kfloats, hld, smem_bytes;
  int keep_permille;   // share of a CTA's taps asked to stay in L2
  CtBath baths[CT_MAX_BATHS];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// this thread's earlier cp.async copies arrive on the barrier when done
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void bulk_g2s(float* dst, const float* src,
                                         uint32_t bytes, uint32_t bar,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

template <int TT>
__global__ void __launch_bounds__(CT_THREADS, 1)
conv_tails_kernel(const CtArgs a) {
  extern __shared__ __align__(128) unsigned char smraw[];
  __shared__ int s_last;
  const int S = a.nstage, hld = a.hld;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smraw);
  // nstage stages of kfloats for the taps' rows; nstage + 1 history rows
  // (TT trajectories each): tap r meets rows r-1 and r-2, so a row serves
  // two taps and one new row per tap is enough; then the bath's indices
  float* stages = reinterpret_cast<float*>(smraw + CT_BAR_BYTES);
  float* hring = stages + (size_t)S * a.kfloats;
  int* cids_s = reinterpret_cast<int*>(hring + (size_t)(S + 1) * TT * hld);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* d = a.desc + blockIdx.x * CT_DESC;
  const int bi = d[0], a0 = d[1], ra = d[2], r0 = d[3], r1 = d[4];
  const int stream = d[5], c0 = d[6], cn = d[7];
  const float* Kp = nullptr;
  const int* cids = nullptr;
  float* out = nullptr;
  int nc = 0;
#pragma unroll
  for (int i = 0; i < CT_MAX_BATHS; ++i) {
    if (i == bi) {
      Kp = a.baths[i].K, cids = a.baths[i].cids, out = a.baths[i].out;
      nc = a.baths[i].nc;
    }
  }
  const int tile = blockIdx.y;
  const int tr0 = tile * TT;
  const int ntt = min(TT, a.ntraj - tr0);
  const int ntaps = r1 - r0;
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + CT_MAX_STAGES);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // every producer lane's cp.async copies, and the bulk copy
      mbar_init(full0 + 8 * s, 32 * CT_PWARPS + 1);
      mbar_init(empty0 + 8 * s, CT_CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int c = tid; c < nc; c += CT_THREADS) cids_s[c] = cids[c];
  __syncthreads();

  float acc0[CT_RPW][TT], acc1[CT_RPW][TT];
#pragma unroll
  for (int j = 0; j < CT_RPW; ++j)
#pragma unroll
    for (int t = 0; t < TT; ++t) acc0[j][t] = acc1[j][t] = 0.f;

  if (warp >= CT_CWARPS) {
    // producers: tap r's rows a0 .. a0+ra by one bulk copy, its first and
    // last floats where they are off a 16-byte boundary and the history
    // row r-1 (for the first tap r-2 as well) by 4-byte cp.async
    const int pl = tid - 32 * CT_CWARPS;
    const int step = *a.step + a.step_off;   // the step this launch runs
    const float* rbase[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t)
      rbase[t] = a.ring + (size_t)(tr0 + min(t, ntt - 1)) * a.mlr * a.nph;
    // The slab is read again next step and is larger than L2: the first
    // taps of every range ask to stay there, the rest to leave first, so
    // the same part is found in L2 step after step
    uint64_t pol_keep, pol_go;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(pol_keep));
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(pol_go));
    const int keep = (int)(((long long)ntaps * a.keep_permille) / 1000);
    int s = 0, ph = 1;
    const int head = (a.mlr - step % a.mlr) % a.mlr;
    int slot = (r0 - 2) % (S + 1), row = (head + r0 - 2) % a.mlr;
    for (int i = 0; i < ntaps; ++i) {
      mbar_wait(empty0 + 8 * s, ph);
      const int r = r0 + i;
      float* st = stages + (size_t)s * a.kfloats;
      const uint32_t full = full0 + 8 * s;
      const size_t g0 = ((size_t)r * nc + a0) * nc, g1 = g0 + (size_t)ra * nc;
      const size_t gf = g0 & ~(size_t)3;
      size_t ga = (g0 + 3) & ~(size_t)3, gb = g1 & ~(size_t)3;
      if (ga > g1) ga = gb = g1;
      const int nhead = (int)(ga - g0), ntail = (int)(g1 - gb);
      if (pl == 0) {
        const uint32_t bytes = (uint32_t)(gb - ga) * 4u;
        if (bytes) {
          mbar_expect_tx(full, bytes);
          bulk_g2s(st + (ga - gf), Kp + ga, bytes, full,
                   i < keep ? pol_keep : pol_go);
        } else {
          mbar_arrive(full);
        }
      }
      if (pl < nhead)
        cp_async4(st + (g0 - gf) + pl, Kp + g0 + pl);
      else if (pl - nhead < ntail)
        cp_async4(st + (gb - gf) + (pl - nhead), Kp + gb + (pl - nhead));
      // history rows r-2 (first tap only) and r-1 into their ring slots
      for (int k = (i == 0 ? 0 : 1); k < 2; ++k) {
        if (i == 0 && k == 1) {
          slot = slot + 1 == S + 1 ? 0 : slot + 1;
          row = row + 1 == a.mlr ? 0 : row + 1;
        }
        float* H = hring + (size_t)slot * TT * hld;
        const size_t roff = (size_t)row * a.nph;
#pragma unroll
        for (int t = 0; t < TT; ++t)
          if (t < ntt)
            for (int b = pl; b < nc; b += 32 * CT_PWARPS)
              cp_async4(H + t * hld + b, rbase[t] + roff + cids_s[b]);
      }
      cp_async_arrive(full);
      slot = slot + 1 == S + 1 ? 0 : slot + 1;
      row = row + 1 == a.mlr ? 0 : row + 1;
      if (++s == S) s = 0, ph ^= 1;
    }
  } else {
    // consumers. Nothing in the loop is conditional: a row or column past
    // the end reads the last one (real numbers, so no NaN), a column past
    // the end meets a zero of the history, and a row's or trajectory's
    // sum past the end is not written out
    int rowoff[CT_RPW];
#pragma unroll
    for (int j = 0; j < CT_RPW; ++j)
      rowoff[j] = min(warp + CT_CWARPS * j, ra - 1) * nc;
    int s = 0, ph = 0;
    int s1 = (r0 - 1) % (S + 1), s2 = (r0 - 2) % (S + 1);
    for (int i = 0; i < ntaps; ++i) {
      mbar_wait(full0 + 8 * s, ph);
      const size_t g0 = ((size_t)(r0 + i) * nc + a0) * nc;
      const float* Ks = stages + (size_t)s * a.kfloats + (int)(g0 & 3);
      const float* H1 = hring + (size_t)s1 * TT * hld;
      const float* H2 = hring + (size_t)s2 * TT * hld;
      for (int cb = 0; cb < nc; cb += 32) {
        const int b = min(cb + lane, nc - 1);
        const float live = cb + lane < nc ? 1.f : 0.f;
        float h1[TT], h2[TT], k[CT_RPW];
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          h1[t] = H1[t * hld + b] * live;
          h2[t] = H2[t * hld + b] * live;
        }
#pragma unroll
        for (int j = 0; j < CT_RPW; ++j) k[j] = Ks[rowoff[j] + b];
#pragma unroll
        for (int j = 0; j < CT_RPW; ++j) {
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            acc0[j][t] += k[j] * h1[t];
            acc1[j][t] += k[j] * h2[t];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      s2 = s1;
      s1 = s1 + 1 == S + 1 ? 0 : s1 + 1;
      if (++s == S) s = 0, ph ^= 1;
    }
    // this CTA's partial sums, lanes reduced once
    float2* P = reinterpret_cast<float2*>(a.part) +
                ((size_t)tile * a.ncta + blockIdx.x) * TT * CT_ROWS;
#pragma unroll
    for (int j = 0; j < CT_RPW; ++j) {
      const int lr = warp + CT_CWARPS * j;
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const float s0 = warp_sum(acc0[j][t]), s1_ = warp_sum(acc1[j][t]);
        if (lane == 0 && lr < ra && t < ntt)
          P[t * CT_ROWS + lr] = make_float2(s0, s1_);
      }
    }
  }

  // the last CTA of this (tile, stream) to get here adds the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned* tk = a.tickets + tile * a.nstream + stream;
    const unsigned ticket = atomicAdd(tk, 1u);
    s_last = ticket == (unsigned)(cn - 1);
    if (s_last) *tk = 0u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // output rows times segments of the CTAs: a thread adds its segment's
  // partials of one row (both tails) in CTA order; then the segments are
  // added in order (the stage ring is idle by now and holds them)
  const int n = ntt * ra;
  const int nseg = max(1, min(cn, CT_THREADS / n));
  const int per = (cn + nseg - 1) / nseg;
  float2* red = reinterpret_cast<float2*>(stages);
  const int seg = tid / n, o = tid - seg * n;
  if (seg < nseg) {
    const int t = o / ra, lr = o - t * ra;
    const size_t cstride = (size_t)TT * CT_ROWS;
    const float2* P = reinterpret_cast<const float2*>(a.part) +
                      (((size_t)tile * a.ncta + c0) * TT + t) * CT_ROWS + lr;
    float2 v = make_float2(0.f, 0.f);
    const int cend = min(cn, (seg + 1) * per);
    for (int cb = seg * per; cb < cend; cb += CT_RED) {
      float2 w[CT_RED];       // all of a batch's loads fly together
#pragma unroll
      for (int u = 0; u < CT_RED; ++u)
        w[u] = cb + u < cend ? __ldcg(P + (cb + u) * cstride)
                             : make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < CT_RED; ++u) {
        v.x += w[u].x;
        v.y += w[u].y;
      }
    }
    red[seg * n + o] = v;
  }
  __syncthreads();
  if (tid < n) {
    float2 v = red[tid];
    for (int sg = 1; sg < nseg; ++sg) {
      v.x += red[sg * n + tid].x;
      v.y += red[sg * n + tid].y;
    }
    const int t = tid / ra, lr = tid - t * ra;
    reinterpret_cast<float2*>(out)[(size_t)(tr0 + t) * nc + a0 + lr] = v;
  }
}

template <int TT>
static int launch(const CtArgs& a, cudaStream_t st) {
  static int allowed = 0;   // largest dynamic shared memory set so far
  if (a.smem_bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_tails_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        a.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = a.smem_bytes;
  }
  conv_tails_kernel<TT>
      <<<dim3(a.ncta, a.ntiles), CT_THREADS, a.smem_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int conv_tails_f32(const CtArgs* args, void* stream) {
  const CtArgs& a = *args;
  if (a.nb < 1 || a.nb > CT_MAX_BATHS || a.ntraj < 1 || a.ncta < 1 ||
      !a.step ||
      a.nstage < 2 || a.nstage > CT_MAX_STAGES ||
      a.ntiles != (a.ntraj + a.tt - 1) / a.tt)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.nb; ++i)
    if (a.baths[i].ml < 3 || a.baths[i].ml > a.mlr || a.baths[i].nc < 1)
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.tt) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int conv_tails_rows(void) { return CT_ROWS; }
