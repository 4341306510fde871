// K2 — block_corr_freq: the per-frequency complex contraction of the
// pre-block memory-kernel convolution (complex64 in and out, 3xTF32
// tensor-core products, sm_90a).
//
//   out[t, f, a] = sum_b khat[f, a, b] * conj(hhat[t, f, b])
//
// Replaces: the einsum inside the JAX package's PhBath.block_corr
// (sclmd_tpu/baths.py:593-604), the live successor of the deleted Pallas
// K-reduction GEMM conv_matmul (a5170d2:sclmd_tpu/ops/kernels.py:54).
// The rfft/irfft around it stay cuFFT calls through torch.fft.
//
// Every frequency is a real GEMM C (2nc x traj) = A (2nc x 2nc) B
// (2nc x traj) on the complex numbers laid out as float pairs: B is
// hhat[:, f, :] as it lies in memory (column k = 2b + d of trajectory t
// is hr for d = 0, hi for d = 1), and row a of khat[f], kr ki kr ki...,
// gives the real part's row of A as it lies; the imaginary part's row is
// the same floats with each pair swapped and its second float negated:
//   re[a] = sum_b kr hr + ki hi,   im[a] = sum_b ki hr - kr hi.
//
// What bounds it on the H100: at the primary shapes (256 trajectories,
// nf 1025, nc 90) the work is 8 nf traj nc^2 = 17 GFLOP per call, and
// 66 MB of khat plus 189 MB each of hhat and out (1025 x 256 x 90 x 8
// bytes) move: 0.13 ms at 3.35 TB/s. The float32 FMA pipes would need
// 0.25 ms at 67 TFLOP/s; in 3xTF32 the tensor cores need three TF32
// products per float32 product, 0.10 ms at 495 TFLOP/s. So HBM bounds it,
// once the products run on the tensor cores. Design:
// * one CTA per frequency stages khat[f] (64.8 KB at nc 90) in shared
//   memory once, as A's real rows, and walks over all the trajectories of
//   the call in tiles of K2_BN: khat is read from HBM once per call. A
//   16-row mma tile holds the real rows of 8 values of a and then their
//   imaginary rows, which the fragment loads read from the same floats
//   (index k ^ 1, sign by the parity of k);
// * 3xTF32: each float32 operand x is split into a TF32 head h (its top
//   19 bits) and a TF32 tail l = x - h cut the same way, and
//   a b ~ a_h b_h + a_h b_l + a_l b_h (the dropped a_l b_l is ~2^-20 of
//   the product), accumulated in float32: float32 accuracy at three TF32
//   products (a single TF32 pass keeps ~3 digits and is not used);
// * 8 warps, 4 along the rows (MT mma tiles each) and 2 along the
//   trajectories (32 each); the history comes in K2_BK-float slices of
//   the contraction through a K2_STAGES-deep cp.async ring that runs on
//   across the trajectory tiles, so the loads of the next tile overlap
//   the products of this one;
// * about 110 KB of shared memory at nc 90: two CTAs per SM, so one
//   stages its khat while the other multiplies.
// Outputs go from the accumulators straight to global memory: a thread
// holds re and im of one (t, a) pair, one 8-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

#define K2_THREADS 256
#define K2_BN 64            // trajectories per tile
#define K2_BK 32            // floats of the contraction per stage
#define K2_STAGES 4
#define K2_LDB (K2_BK + 4)  // = 4 mod 32: fragment reads conflict-free
#define K2_MTMAX 4          // mma row tiles per warp: nc <= 32 K2_MTMAX

// contraction length 2 nc padded to whole stages; kS row stride = 4 mod
// 32 (conflict-free fragment reads)
__host__ __device__ inline int k2_kpad(int nc) {
  return (2 * nc + K2_BK - 1) / K2_BK * K2_BK;
}
__host__ __device__ inline int k2_lda(int nc) { return k2_kpad(nc) + 4; }
static int k2_mt(int nc) { return (nc + 31) / 32; }
static int k2_smem_bytes(int nc) {
  return (32 * k2_mt(nc) * k2_lda(nc) + K2_STAGES * K2_BN * K2_LDB) *
         (int)sizeof(float);
}

__device__ __forceinline__ void cp_async8(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// x = h + l, h the top 19 bits of x (a TF32 value), l the rest cut the
// same way (|l| < 2^-10 |x|, so the cut loses < 2^-20 |x|)
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

template <int MT>
__global__ void __launch_bounds__(K2_THREADS, MT <= 3 ? 2 : 1)
block_corr_freq_kernel(const float* __restrict__ khat,
                       const float* __restrict__ hhat,
                       float* __restrict__ out, int ntraj, int nf, int nc) {
  extern __shared__ __align__(16) float smk[];
  const int lda = k2_lda(nc), kpad = k2_kpad(nc), nrow = 32 * MT;
  const int k2 = 2 * nc;
  float* kS = smk;               // [nrow][lda]: khat[f] rows, zero-padded
  float* Bs = smk + nrow * lda;  // [STAGES][BN][LDB]: hhat slices [t][k]
  const int f = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;   // fragment coordinates
  const int wa = (warp & 3) * MT * 8;       // the warp's first a
  const int wn = (warp >> 2) * 32;          // its first trajectory in a tile
  const int nkc = kpad / K2_BK;
  const int nit = (ntraj + K2_BN - 1) / K2_BN * nkc;

  const float* kf = khat + (size_t)f * nc * k2;
  for (int i = tid; i < nrow * (lda / 2); i += K2_THREADS) {
    const int a = i / (lda / 2), k = 2 * (i - a * (lda / 2));
    const bool ok = a < nc && k < k2;
    cp_async8(kS + a * lda + k, kf + (ok ? a * k2 + k : 0), ok);
  }
  cp_async_commit();

  // slice it (tile it / nkc, contraction floats kc K2_BK ..) into its stage
  auto fetch = [&](int it) {
    const int nt = it / nkc, kc = it - nt * nkc;
    float* bs = Bs + (it % K2_STAGES) * K2_BN * K2_LDB;
    for (int i = tid; i < K2_BN * (K2_BK / 2); i += K2_THREADS) {
      const int n = i / (K2_BK / 2), kk = 2 * (i % (K2_BK / 2));
      const int t = nt * K2_BN + n, k = kc * K2_BK + kk;
      const bool ok = t < ntraj && k < k2;
      cp_async8(bs + n * K2_LDB + kk,
                hhat + (ok ? ((size_t)t * nf + f) * k2 + k : 0), ok);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

#pragma unroll
  for (int s = 0; s < K2_STAGES - 1; ++s) {
    if (s < nit) fetch(s);
    cp_async_commit();
  }
  // the imaginary rows read the pair partner: k+1 with + for even k,
  // k-1 with - for odd k (k's parity is tg's)
  const int pk = (tg & 1) ? -1 : 1;
  const float sg = (float)pk;
  for (int it = 0; it < nit; ++it) {
    cp_async_wait<K2_STAGES - 2>();
    __syncthreads();  // slice it (and kS) landed; stage (it-1) % STAGES free
    if (it + K2_STAGES - 1 < nit) fetch(it + K2_STAGES - 1);
    cp_async_commit();
    const int nt = it / nkc, kc = it - nt * nkc;
    const float* bs = Bs + (it % K2_STAGES) * K2_BN * K2_LDB;
    const float* ks = kS + kc * K2_BK;
#pragma unroll
    for (int k8 = 0; k8 < K2_BK; k8 += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float* r = ks + (wa + mi * 8 + g) * lda + k8 + tg;
        split_tf32(r[0], ah[mi][0], al[mi][0]);
        split_tf32(sg * r[pk], ah[mi][1], al[mi][1]);
        split_tf32(r[4], ah[mi][2], al[mi][2]);
        split_tf32(sg * r[4 + pk], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* c = bs + (wn + ni * 8 + g) * K2_LDB + k8 + tg;
        split_tf32(c[0], bh[ni][0], bl[ni][0]);
        split_tf32(c[4], bh[ni][1], bl[ni][1]);
      }
      // the small cross terms first, then the head product
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(acc[mi][ni], al[mi], bh[ni]);
          mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
          mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
        }
    }
    if (kc == nkc - 1) {
      // element c of a fragment: row g (re) or g + 8 (im) of a = wa +
      // 8 mi + g, trajectory 2 tg + (c & 1) of the n8 tile
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int a = wa + mi * 8 + g;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int t = nt * K2_BN + wn + ni * 8 + 2 * tg + j;
            if (a < nc && t < ntraj)
              *reinterpret_cast<float2*>(out + ((size_t)t * nf + f) * k2 +
                                         2 * a) =
                  make_float2(acc[mi][ni][j], acc[mi][ni][2 + j]);
            acc[mi][ni][j] = acc[mi][ni][2 + j] = 0.f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int MT>
static int launch_mt(const float* khat, const float* hhat, float* out,
                     int ntraj, int nf, int nc, cudaStream_t st) {
  const int bytes = k2_smem_bytes(nc);
  cudaError_t e = cudaFuncSetAttribute(
      block_corr_freq_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(block_corr_freq_kernel<MT>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  block_corr_freq_kernel<MT><<<nf, K2_THREADS, bytes, st>>>(khat, hhat, out,
                                                            ntraj, nf, nc);
  return (int)cudaGetLastError();
}

// The widest nc the kernel takes: 32 K2_MTMAX rows of A per CTA, within
// 227 KB of shared memory (128).
extern "C" int block_corr_freq_max_nc() {
  int nc = 32 * K2_MTMAX;
  while (nc > 1 && k2_smem_bytes(nc) > 227 * 1024) --nc;
  return nc;
}

extern "C" int block_corr_freq_f32(const void* khat, const void* hhat,
                                   void* out, int ntraj, int nf, int nc,
                                   void* stream) {
  if (ntraj < 1 || nf < 1 || nc < 1 || nc > block_corr_freq_max_nc())
    return (int)cudaErrorInvalidValue;
  const float* k = (const float*)khat;
  const float* h = (const float*)hhat;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k2_mt(nc)) {
    case 1: return launch_mt<1>(k, h, o, ntraj, nf, nc, st);
    case 2: return launch_mt<2>(k, h, o, ntraj, nf, nc, st);
    case 3: return launch_mt<3>(k, h, o, ntraj, nf, nc, st);
    case 4: return launch_mt<4>(k, h, o, ntraj, nf, nc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
