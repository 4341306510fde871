// K1, far taps — between two sub-blocks of gle_block.cu, add the
// finished sub-block's velocity rows to the tails of every later step of
// the block (float32 in and out, 3xTF32 tensor-core products, sm_90a).
//
//   O[t, s, a] += sum_{i < ns} sum_b K[s - b0 - i][a, b] p_{b0+i}[t, b]
//   for s in [b0 + ns, block]
//
// Replaces, with gle_block.cu: the in-block tail product of the JAX
// package's blocked integrator, kin @ S in
// sclmd_tpu/md.py:_run_segment_blocked_body.inner (md.py:551), which a
// whole-block kernel read from L2 at every step for one or two
// trajectories at a time.
//
// It is one GEMM per call and bath, C (M x N) += A (M x K) B (K x N) with
// M = (block + 1 - b0 - ns) nc rows (target step, row a), K = ns nc
// (sub-block row, column b) and N = trajectories. A is block-Toeplitz:
// A[(s, a), (i, b)] = K[s - b0 - i][a, b], gathered from the tap-major
// kinT[d-1][b][a] of gle_block.cu; B is the ring rows the near kernel
// wrote (ring[t][block-1-b0-i][b]); C is the O buffer the near kernel
// reads next.
//
// What bounds it on the H100: 2 M K N FLOPs per call and bath (0.26
// TFLOP per 256-step block at 256 trajectories, nc 90 and S 12: 3.9 ms at
// the 67 TFLOP/s of float32 FMA) against a few MB of kin and ring: the
// arithmetic, once the operands arrive in time. Each kin element is read
// from L2 once per tile of 64 trajectories instead of once per one or
// two. Design:
// * the products run on the tensor cores in 3xTF32: each float32 operand
//   x is split into a TF32 head h = rna(x) and a TF32 tail
//   l = rna(x - h), and a b ~ a_h b_h + a_h b_l + a_l b_h (the dropped
//   a_l b_l is ~2^-22 of the product), summed in float32: float32
//   accuracy at three TF32 products (a single TF32 pass keeps ~3 digits
//   and is not used);
// * 128 x 64 outputs per CTA, 4 warps of 64 x 32 (4 x 4 mma.m16n8k8
//   tiles: each split operand feeds four products), K steps of 16;
// * the gathered operands come through a FAR_STAGES-deep ring of
//   shared-memory tiles filled by cp.async (4-byte copies, zero fill past
//   the edges): one K step is too short to hide an L2 round trip, and
//   with two buffers the kernel waited on its loads.
// On the H100 this form ran faster than register-blocked FFMA forms of
// the same pipeline (8 x 4 and 8 x 8 outputs per thread), than 32 x 32
// warp tiles and than cvt.rna splits; with two buffers instead of the
// ring the kernel waited on its loads.

#include <cuda_runtime.h>
#include <stdint.h>

#define FAR_MAX_BATHS 4
#define FAR_BM 128
#define FAR_BN 64
#define FAR_BK 16
#define FAR_THREADS 128
#define FAR_STAGES 4
#define FAR_LDA (FAR_BM + 8)  // = 8 mod 32: fragment reads conflict-free
#define FAR_LDB (FAR_BN + 8)

static_assert(FAR_THREADS == FAR_BM, "one A row per thread");

struct FarBath {
  const float* kinT;  // (block+1, ncs, nc)
  const float* ring;  // (ntraj, block, nc), newest first
  float* O;           // (ntraj, block+1, nc)
  int nc, ncs;
};

struct FarArgs {
  int ntraj, block, b0, ns, nb;
  FarBath baths[FAR_MAX_BATHS];
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// x = h + l with h the top 19 bits of x (a TF32 value) and l the rest,
// itself cut to TF32 (|l| < 2^-10 |x|, so l loses < 2^-20 |x|): two
// full-rate integer/float ops instead of two cvt.rna conversions
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
// d += a b for one m16n8k8 TF32 tile (fragments in the PTX ISA layout)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(FAR_THREADS, 3)
gle_far_kernel(const FarArgs args) {
  const FarBath& B = args.baths[blockIdx.z];
  const int nc = B.nc, ncs = B.ncs, blk = args.block;
  const int b0 = args.b0, ns = args.ns, ntraj = args.ntraj;
  const int s_lo = b0 + ns;
  const int M = (blk + 1 - s_lo) * nc;
  const int m0 = blockIdx.x * FAR_BM, n0 = blockIdx.y * FAR_BN;
  if (m0 >= M) return;

  extern __shared__ __align__(16) float smf[];
  float* As = smf;                                  // [STAGES][BK][LDA]
  float* Bs = As + FAR_STAGES * FAR_BK * FAR_LDA;   // [STAGES][BK][LDB]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;         // fragment coordinates
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;

  // A copies: one row m, all 16 k rows of the step
  const int am = tid;
  const bool a_ok = m0 + am < M;
  int abase = 0;
  if (a_ok) {
    const int sidx = (m0 + am) / nc, a = (m0 + am) - sidx * nc;
    // tap d = s - b0 - i for target s = s_lo + sidx; kinT row d - 1
    abase = ((s_lo + sidx - b0 - 1) * ncs) * nc + a;
  }
  // B copies: column kb of the K step, trajectories n0 + bn0 + 8 j
  const int kb = tid & 15, bn0 = tid >> 4;

  const int nbc = (nc + FAR_BK - 1) / FAR_BK;
  const int nk = ns * nbc;
  // K step it (sub-block row i, columns bc..bc+15) into stage st
  auto fetch = [&](int it, int st) {
    const int i = it / nbc, bc = (it - i * nbc) * FAR_BK;
    const int aoff = abase + (bc - i * ncs) * nc;
    float* as = As + st * FAR_BK * FAR_LDA;
#pragma unroll
    for (int kk = 0; kk < FAR_BK; ++kk) {
      const bool ok = a_ok && bc + kk < nc;
      cp_async4(as + kk * FAR_LDA + am, B.kinT + (ok ? aoff + kk * nc : 0),
                ok);
    }
    const int col = bc + kb;
    const size_t roff = (size_t)(blk - 1 - b0 - i) * nc + col;
    float* bs = Bs + st * FAR_BK * FAR_LDB;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + bn0 + 8 * j;
      const bool ok = col < nc && n < ntraj;
      cp_async4(bs + kb * FAR_LDB + bn0 + 8 * j,
                B.ring + (ok ? roff + (size_t)n * blk * nc : 0), ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

#pragma unroll
  for (int st = 0; st < FAR_STAGES - 1; ++st) {
    if (st < nk) fetch(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<FAR_STAGES - 2>();
    __syncthreads();  // step it landed; stage (it-1) % STAGES is free
    const int nxt = it + FAR_STAGES - 1;
    if (nxt < nk) fetch(nxt, nxt % FAR_STAGES);
    cp_async_commit();
    const float* as = As + (it % FAR_STAGES) * FAR_BK * FAR_LDA;
    const float* bs = Bs + (it % FAR_STAGES) * FAR_BK * FAR_LDB;
#pragma unroll
    for (int k8 = 0; k8 < FAR_BK; k8 += 8) {
      uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm + mi * 16 + g;
        const float* a0 = as + (k8 + tg) * FAR_LDA + row;
        const float* a4 = a0 + 4 * FAR_LDA;
        split_tf32(a0[0], ah[mi][0], al[mi][0]);
        split_tf32(a0[8], ah[mi][1], al[mi][1]);
        split_tf32(a4[0], ah[mi][2], al[mi][2]);
        split_tf32(a4[8], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn + ni * 8 + g;
        split_tf32(bs[(k8 + tg) * FAR_LDB + col], bh[ni][0], bl[ni][0]);
        split_tf32(bs[(k8 + tg + 4) * FAR_LDB + col], bh[ni][1], bl[ni][1]);
      }
      // the small cross terms first, then the head product
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(acc[mi][ni], al[mi], bh[ni]);
          mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
          mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
        }
    }
  }
  cp_async_wait<0>();

  // C: O[n][s_lo * nc + m] += acc, one CTA per element; fragment element
  // c sits at row g (+8 for c >= 2), column 2 tg + (c & 1)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm + mi * 16 + g + (c >= 2 ? 8 : 0);
        const int n = n0 + wn + ni * 8 + 2 * tg + (c & 1);
        if (m < M && n < ntraj)
          B.O[(size_t)n * (blk + 1) * nc + (size_t)s_lo * nc + m] +=
              acc[mi][ni][c];
      }
}

extern "C" int gle_far_f32(const FarArgs* args, void* stream) {
  const FarArgs a = *args;
  if (a.nb < 1 || a.nb > FAR_MAX_BATHS || a.ntraj < 1 || a.ns < 1 ||
      a.b0 < 0 || a.b0 + a.ns >= a.block)
    return (int)cudaErrorInvalidValue;
  int mmax = 0;
  for (int b = 0; b < a.nb; ++b) {
    const int m = (a.block + 1 - a.b0 - a.ns) * a.baths[b].nc;
    mmax = m > mmax ? m : mmax;
  }
  const int bytes =
      FAR_STAGES * FAR_BK * (FAR_LDA + FAR_LDB) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gle_far_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((mmax + FAR_BM - 1) / FAR_BM, (a.ntraj + FAR_BN - 1) / FAR_BN,
            a.nb);
  gle_far_kernel<<<grid, FAR_THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
