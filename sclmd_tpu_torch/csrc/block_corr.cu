// K2 — block_corr_freq: the per-frequency complex contraction of the
// pre-block memory-kernel convolution (complex64, sm_90a).
//
//   out[t, f, a] = sum_b khat[f, a, b] * conj(hhat[t, f, b])
//
// Replaces: the einsum inside the JAX package's PhBath.block_corr
// (sclmd_tpu/baths.py:593-604), the live successor of the deleted Pallas
// K-reduction GEMM conv_matmul (a5170d2:sclmd_tpu/ops/kernels.py:54).
// The rfft/irfft around it stay cuFFT calls through torch.fft.
//
// Design. One CTA per (frequency, group of trajectories). The kernel
// spectrum khat[f] (nc x nc complex64: 64.8 KB at nc = 90) is shared by
// every trajectory, so the CTA stages it once in dynamic shared memory,
// transposed (kT[b][a]) so that consecutive threads (consecutive a) read
// consecutive words, and reuses it across its trajectories. Each thread
// owns one output row a and keeps K2_TT trajectories' accumulators in
// registers, so one shared-memory read of kT feeds K2_TT complex FMAs;
// the conjugated history rows of the K2_TT trajectories are staged in
// shared memory and read as broadcasts.
//
// What bounds it on the H100: at the primary shapes (256 trajectories,
// nf 1025, nc 90) the work is 8 nf traj nc^2 = 17 GFLOP per call against
// 66 MB of khat and 2 x 94 MB of hhat/out: compute (fp32 FMA issue and
// shared-memory reads), not HBM. K2_TRAJ_PER_CTA trajectories per CTA
// cut the khat re-reads to traj / K2_TRAJ_PER_CTA per frequency.

#include <cuda_runtime.h>

#define K2_TT 16
#define K2_TRAJ_PER_CTA 64

__global__ void block_corr_freq_kernel(const float2* __restrict__ khat,
                                       const float2* __restrict__ hhat,
                                       float2* __restrict__ out, int ntraj,
                                       int nf, int nc) {
  extern __shared__ float2 sm2[];
  float2* kT = sm2;            // [nc][nc], kT[b * nc + a] = khat[f, a, b]
  float2* h = kT + nc * nc;    // [K2_TT][nc], conj(hhat[t, f, :])
  const int f = blockIdx.x;
  const int tbeg = blockIdx.y * K2_TRAJ_PER_CTA;
  const int tend = min(ntraj, tbeg + K2_TRAJ_PER_CTA);
  const float2* kf = khat + (size_t)f * nc * nc;
  for (int i = threadIdx.x; i < nc * nc; i += blockDim.x) {
    const int a = i / nc, b = i % nc;
    kT[b * nc + a] = kf[i];
  }
  for (int t0 = tbeg; t0 < tend; t0 += K2_TT) {
    const int nt = min(K2_TT, tend - t0);
    __syncthreads();  // kT staged; previous tile's h no longer read
    for (int i = threadIdx.x; i < K2_TT * nc; i += blockDim.x) {
      const int t = i / nc, b = i % nc;
      float2 v = make_float2(0.f, 0.f);
      if (t < nt) {
        v = hhat[((size_t)(t0 + t) * nf + f) * nc + b];
        v.y = -v.y;
      }
      h[i] = v;
    }
    __syncthreads();
    for (int a = threadIdx.x; a < nc; a += blockDim.x) {
      float re[K2_TT], im[K2_TT];
#pragma unroll
      for (int t = 0; t < K2_TT; ++t) re[t] = im[t] = 0.f;
      for (int b = 0; b < nc; ++b) {
        const float2 k = kT[b * nc + a];
#pragma unroll
        for (int t = 0; t < K2_TT; ++t) {
          const float2 x = h[t * nc + b];
          re[t] += k.x * x.x - k.y * x.y;
          im[t] += k.x * x.y + k.y * x.x;
        }
      }
      for (int t = 0; t < nt; ++t)
        out[((size_t)(t0 + t) * nf + f) * nc + a] = make_float2(re[t], im[t]);
    }
  }
}

extern "C" int block_corr_freq_f32(const void* khat, const void* hhat,
                                   void* out, int ntraj, int nf, int nc,
                                   void* stream) {
  if (ntraj < 1 || nf < 1 || nc < 1) return (int)cudaErrorInvalidValue;
  const int bytes = (nc * nc + K2_TT * nc) * (int)sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      block_corr_freq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  int threads = ((nc + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  dim3 grid(nf, (ntraj + K2_TRAJ_PER_CTA - 1) / K2_TRAJ_PER_CTA);
  block_corr_freq_kernel<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      (const float2*)khat, (const float2*)hhat, (float2*)out, ntraj, nf, nc);
  return (int)cudaGetLastError();
}
