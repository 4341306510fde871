// K3 — noise_synth: colored-noise synthesis in the frequency domain, the
// Gaussian draw made inside the kernel and the product on the tensor
// cores (3xTF32 mma.sync, float32 in, complex64 out, sm_90a). For one
// bath and the trajectories [lo, lo + ntraj) of an ensemble:
//
//   xi[t, w, i] = sum_k U(w)[i, k] * std[w, k] * z(j = lo + t, e = w nc + k)
//
// for w in [0, h), h = nmd/2 + 1, written as y[t, i, w] = conj(xi) scale
// in the layout (ntraj, nc, h), scale = 1/(nmd dt): the input cuFFT's
// C2R transform wants for the series x = irfft(y, nmd, last dim, no
// normalisation), which is hfft(xi) / (nmd dt). The imaginary parts of
// rows 0 and h-1 are written as zero: the real series does not keep them,
// and cuFFT's C2R does not drop them. U(w) is one (nc, nc) matrix for a
// proportional spectrum or an (h, nc, nc) batch, packed once on the host
// (kernels/noise_synth.py pack_factor): nc zero-padded to ncp, a multiple
// of the mma's k of 8, and each group of 8 output channels as 16 rows,
// the real parts of U's 8 rows and then their imaginary parts, so one
// m16n8k8 tile gives both halves of 8 complex outputs.
//
// noise_c2r: that C2R transform, one cuFFT plan per shape (cached here),
// B = ntraj nc contiguous transforms, (B, h) complex to (B, nmd) real;
// cuFFT may overwrite y, which is K3's scratch. noise_transpose: the
// series (ntraj, nc, nmd) to the (ntraj, nmd, nc) that K1, K6 and K7
// read, through 32 x 32 tiles in shared memory (a general strided copy
// reads or writes 4-byte words 4 nmd bytes apart).
//
// K3b — init_draw: the thermal start's mode-space amplitudes (2, ntraj,
// n), c = am cos(2 pi u) and s = -hw am sin(2 pi u), u the uniform
// phases of the same Philox function; or the uniforms themselves (the
// check against the twin).
//
// Replaces: sclmd_tpu/ops/noise.py:186 sample_noise_parts and :205
// sample_noise_prop, vmapped per bath in _fused_chunk
// (sclmd_tpu/parallel/ensemble.py:892-899), and the draw and the
// amplitudes of sclmd_tpu/md.py:120 thermal_init. Never Pallas: XLA fused
// them (and left the FFT to XLA).
//
// The draw z is Philox4x32-10 (Random123), keyed by two words hashed from
// the ensemble seed and the stream, counter (e / 4, 0, j, 0); Box-Muller
// on the words' pairs. The schedule is written out in
// sclmd_tpu_torch/ops/philox.py, whose plain twin draws the same integers.
// A draw depends on (seed, stream, j, e) only, and every output is summed
// over k in one fixed order with no split across CTAs, so a chunk of
// trajectories gets bitwise the numbers of the whole ensemble at every
// launch shape, and no draw is written to device memory.
//
// What bounds it on the H100: 4 nc^2 operations per (trajectory,
// frequency) column against 8 nc bytes written. In 3xTF32 (three TF32
// products per float32 product, float32 accuracy) the tensor cores do the
// flagship's 1024 chunk (nc 150, h 513) in 3 x 4.7e10 / 495e12 = 0.29 ms,
// and its 0.63 GB of output take 0.19 ms at 3.35 TB/s: operations bound
// it, at about the same time as the bytes. The draw (Philox, Box-Muller,
// about 35 instructions a normal on the ALU and SFU pipes) is then of the
// order of the product. Design:
// * one persistent CTA per SM of 24 warps, warp-specialised: producer
//   warps draw the next 24-column tile of X = std z (ncp, 24) into one
//   of two shared buffers while the consumer warps run the mma on the
//   other; the two sides hand over on named barriers (FULL: producers
//   arrive, consumers sync; EMPTY: the reverse), so no draw reaches HBM;
// * the proportional path (every main-path cell) is one real GEMM,
//   [Re U; Im U] (2ncp x ncp) times X (ncp x h ntraj), the columns being
//   (trajectory, frequency) pairs, frequency fastest as the output: U is
//   staged in
//   shared memory once per CTA (185 KB at nc 150, 80 KB at nc 90); the
//   batch path keeps one CTA per frequency, its columns the trajectories;
//   where U does not fit beside two draw buffers (nc above 152), the
//   consumers read it from global memory (L1/L2);
// * a consumer warp per m-tile (16 rows of U, up to 20 warps; beyond,
//   warps walk several), each over all three n-tiles of a tile: the
//   tensor pipe then has many warps to hide the mma's latency, and the
//   three products of 3xTF32 go as three passes over the n-tiles, so
//   consecutive mma are independent; U's fragments are split into TF32
//   head and tail as they are loaded (staging U split would double its
//   shared memory), the draws' likewise; both operands are laid out so a
//   thread's two values of a fragment row are one 8-byte load;
// * the store folds conj and 1/(nmd dt): a thread holds re and im of two
//   (column, channel) outputs, one 8-byte store each; a quad of lanes
//   writes 8 consecutive frequencies of one channel (the batch path's
//   stores, a frequency per CTA, are scattered: it is off the main path);
// * producers make two 4-blocks of a column per item, their Philox
//   chains interleaved, so a producer warp has independent work between
//   a round's dependent products.

#include <cuda_runtime.h>
#include <cufft.h>
#include <stdint.h>

#define NS_NT 3               // n-tiles (8 columns) per consumer warp
#define NS_BN (8 * NS_NT)     // columns per tile
#define NS_LDX (NS_BN + 4)    // floats per column pair row of a draw tile
#define NS_MAX_THREADS 768    // launch bound: 24 warps, up to 85 registers
#define NS_SMEM_LIMIT (227 * 1024)
#define NS_CUFFT_ERR 10000    // cuFFT's result codes come back above this

struct NsArgs {
  const float* A;      // packed U: (nu, 2 ncp, lda), nu = 1 or h
  const float* std_t;  // std transposed, (nc, h)
  void* out;           // (h, ntraj, nc) complex64 pairs, or the draw
                       // (ntraj, h, nc) float32
  int ntraj, h, nc, ncp, lda;
  int batch;           // U per frequency
  int draw_only;       // write std * z as (ntraj, h, nc) float32
  unsigned lo, k0, k1;
  float scale;         // 1 / (nmd dt)
  int pw, cw;          // producer and consumer warps
  int grid;            // CTAs
  int a_smem;          // U in shared memory
  int smem_bytes;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// ((x >> 8) | 1) * 2^-24: exact in float32, in [2^-24, 1 - 2^-24]
__device__ __forceinline__ float ns_uniform(unsigned x) {
  return __uint2float_rn((x >> 8) | 1u) * 5.9604644775390625e-8f;
}

__device__ __forceinline__ float4 ns_normals(uint4 w) {
  const float r01 = sqrtf(-2.f * logf(ns_uniform(w.x)));
  const float r23 = sqrtf(-2.f * logf(ns_uniform(w.z)));
  float s1, c1, s3, c3;
  sincospif(2.f * ns_uniform(w.y), &s1, &c1);
  sincospif(2.f * ns_uniform(w.w), &s3, &c3);
  return make_float4(r01 * c1, r01 * s1, r23 * c3, r23 * s3);
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

// named barriers 1-2 (FULL, per buffer) and 3-4 (EMPTY); 0 is
// __syncthreads. Both order the shared-memory accesses made before them.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Where element (k, column c) of a draw tile lies: the rows k and k + 4
// of each 8-row block side by side, so one 8-byte load gives a thread
// both of its B fragment's values (rows tg and tg + 4 of column g); a
// row pair holds NS_LDX floats per column pair (= 24 mod 32: conflict-free)
__device__ __forceinline__ int ns_xoff(int k, int c) {
  return ((k >> 3) * 4 + (k & 3)) * (2 * NS_LDX) + 2 * c + ((k >> 2) & 1);
}

// two floats of U: from shared memory, or through the read-only cache
template <bool AS>
__device__ __forceinline__ float2 ns_ld2(const float* p) {
  return AS ? *reinterpret_cast<const float2*>(p)
            : __ldg(reinterpret_cast<const float2*>(p));
}

// trajectory t and frequency w of column c (see the kernel)
__device__ __forceinline__ void ns_column(const NsArgs& a, int c, int w_cta,
                                          int& t, int& w) {
  if (a.batch) {
    t = c;
    w = w_cta;
  } else {
    t = c / a.h;
    w = c - t * a.h;
  }
}

// Philox4x32-10 of the counters c and c + (1, 0, 0, 0), the two chains
// interleaved
__device__ __forceinline__ void philox2(uint4 c, unsigned k0, unsigned k1,
                                        uint4& x0, uint4& x1) {
  uint4 d = make_uint4(c.x + 1u, c.y, c.z, c.w);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hc0 = __umulhi(0xD2511F53u, c.x), lc0 = 0xD2511F53u * c.x;
    const unsigned hd0 = __umulhi(0xD2511F53u, d.x), ld0 = 0xD2511F53u * d.x;
    const unsigned hc1 = __umulhi(0xCD9E8D57u, c.z), lc1 = 0xCD9E8D57u * c.z;
    const unsigned hd1 = __umulhi(0xCD9E8D57u, d.z), ld1 = 0xCD9E8D57u * d.z;
    c = make_uint4(hc1 ^ c.y ^ k0, lc1, hc0 ^ c.w ^ k1, lc0);
    d = make_uint4(hd1 ^ d.y ^ k0, ld1, hd0 ^ d.w ^ k1, ld0);
  }
  x0 = c;
  x1 = d;
}

template <bool AS>
__global__ void __launch_bounds__(NS_MAX_THREADS, 1)
    noise_synth_kernel(const NsArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int nc = a.nc, ncp = a.ncp, lda = a.lda, xsz = ncp * NS_LDX;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* As = smem;                                   // (2 ncp, lda)
  float* Xs = smem + (AS ? 2 * ncp * lda : 0);        // 2 draw tiles

  // the CTA's columns: on the proportional path every (trajectory,
  // frequency) pair, c = t h + w, in tiles blockIdx, blockIdx + grid, ..;
  // on the batch path the trajectories c = t of the frequency blockIdx,
  // all its tiles
  const int w_cta = a.batch ? (int)blockIdx.x : 0;
  const int c_lo = 0;
  const int c_hi = a.batch ? a.ntraj : a.h * a.ntraj;
  const int tile0 = a.batch ? 0 : (int)blockIdx.x;
  const int tstep = a.batch ? 1 : (int)gridDim.x;
  const int ntiles = (c_hi - c_lo + NS_BN - 1) / NS_BN;
  const int nmine = ntiles > tile0 ? (ntiles - tile0 + tstep - 1) / tstep : 0;
  const float* Ag = a.A + (a.batch ? (size_t)w_cta * 2 * ncp * lda : 0);

  if (AS) {
    const float4* src = reinterpret_cast<const float4*>(Ag);
    float4* dst = reinterpret_cast<float4*>(As);
    for (int i = tid; i < 2 * ncp * lda / 4; i += nthreads)
      dst[i] = __ldg(src + i);
  }
  // the padded rows k >= nc of both draw tiles are zero (the producers
  // never write them; U's padded columns are zero too, but 0 * NaN is not)
  for (int i = tid; i < 2 * (ncp - nc) * NS_BN; i += nthreads) {
    const int b = i / ((ncp - nc) * NS_BN), r = i % ((ncp - nc) * NS_BN);
    Xs[b * xsz + ns_xoff(nc + r / NS_BN, r % NS_BN)] = 0.f;
  }
  __syncthreads();

  if (warp < a.pw) {
    // producers: draw tile j's X = std z into buffer j & 1, two 4-blocks
    // of a column per item (two independent Philox chains)
    const int pthreads = 32 * a.pw;
    // pairs of 4-blocks a column's nc elements touch
    const int npair = ((nc + 3) / 4 + 2) / 2;
    for (int j = 0; j < nmine; ++j) {
      const int buf = j & 1;
      if (j >= 2) bar_sync(3 + buf, nthreads);   // tile j - 2 consumed
      float* X = Xs + buf * xsz;
      const int cb = c_lo + (tile0 + j * tstep) * NS_BN;
      for (int it = tid; it < NS_BN * npair; it += pthreads) {
        const int col = it % NS_BN, c = cb + col;
        if (c >= c_hi) continue;
        int t, w;
        ns_column(a, c, w_cta, t, w);
        const int e0 = w * nc, b = (e0 >> 2) + 2 * (it / NS_BN);
        if (4 * b >= e0 + nc) continue;          // past the column's end
        uint4 x0, x1;
        philox2(make_uint4((unsigned)b, 0u, a.lo + t, 0u), a.k0, a.k1, x0,
                x1);
        // std transposed: a warp's columns (consecutive frequencies of a
        // trajectory, or one frequency) read consecutive or equal words
        const float* sw = a.std_t + w;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 z = ns_normals(half ? x1 : x0);
          const float zz[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int k = 4 * (b + half) + m - e0;
            if (k >= 0 && k < nc)
              X[ns_xoff(k, col)] = __ldg(sw + (size_t)k * a.h) * zz[m];
          }
        }
      }
      bar_arrive(1 + buf, nthreads);
    }
    // take the consumers' last two EMPTY arrivals, so every barrier ends
    // balanced
    for (int j = nmine > 2 ? nmine - 2 : 0; j < nmine; ++j)
      bar_sync(3 + (j & 1), nthreads);
    return;
  }

  // consumers: warp cw owns the m-tiles cw, cw + CW, .. (16 rows of U:
  // the real and imaginary rows of 8 channels) and every n-tile
  const int cw = warp - a.pw;
  const int g = lane >> 2, tg = lane & 3;
  const int m16 = ncp / 8;
  const float* Ab = AS ? As : Ag;
  float2* out = reinterpret_cast<float2*>(a.out);
  for (int j = 0; j < nmine; ++j) {
    const int buf = j & 1;
    bar_sync(1 + buf, nthreads);                  // tile j drawn
    const float* X = Xs + buf * xsz;
    const int cb = c_lo + (tile0 + j * tstep) * NS_BN;
    if (a.draw_only) {
      float* o = reinterpret_cast<float*>(a.out);
      for (int it = 32 * cw + lane; it < NS_BN * nc; it += 32 * a.cw) {
        const int col = it / nc, k = it - col * nc, c = cb + col;
        if (c >= c_hi) continue;
        int t, w;
        ns_column(a, c, w_cta, t, w);
        o[((size_t)t * a.h + w) * nc + k] = X[ns_xoff(k, col)];
      }
      bar_arrive(3 + buf, nthreads);
      continue;
    }
    if (cw >= m16) bar_arrive(3 + buf, nthreads);
    for (int mi = cw; mi < m16; mi += a.cw) {
      float acc[NS_NT][4];
#pragma unroll
      for (int nt = 0; nt < NS_NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
      // U's columns are stored so that k and k + 4 of each 8 lie side by
      // side (pack_factor): one 8-byte load gives a0, a2 (row g) and one
      // gives a1, a3 (row g + 8)
      const float* ar = Ab + (size_t)(16 * mi + g) * lda + 2 * tg;
      const float* xr = X + tg * (2 * NS_LDX) + 2 * g;
#pragma unroll 2
      for (int k8 = 0; k8 < ncp; k8 += 8) {
        const float2 r0 = ns_ld2<AS>(ar + k8);
        const float2 r1 = ns_ld2<AS>(ar + 8 * lda + k8);
        uint32_t ah[4], al[4], bh[NS_NT][2], bl[NS_NT][2];
        split_tf32(r0.x, ah[0], al[0]);
        split_tf32(r1.x, ah[1], al[1]);
        split_tf32(r0.y, ah[2], al[2]);
        split_tf32(r1.y, ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NS_NT; ++nt) {
          const float2 b = *reinterpret_cast<const float2*>(
              xr + (k8 / 2) * (2 * NS_LDX) + 16 * nt);
          split_tf32(b.x, bh[nt][0], bl[nt][0]);
          split_tf32(b.y, bh[nt][1], bl[nt][1]);
        }
        // the small cross terms first, then the head products; each pass
        // over the n-tiles, so consecutive products are independent
#pragma unroll
        for (int nt = 0; nt < NS_NT; ++nt) mma_tf32(acc[nt], al, bh[nt]);
#pragma unroll
        for (int nt = 0; nt < NS_NT; ++nt) mma_tf32(acc[nt], ah, bl[nt]);
#pragma unroll
        for (int nt = 0; nt < NS_NT; ++nt) mma_tf32(acc[nt], ah, bh[nt]);
      }
      if (mi + a.cw >= m16) bar_arrive(3 + buf, nthreads);   // X free
      // element r of a fragment: row g (re) or g + 8 (im) of channel
      // i = 8 mi + g, column 2 tg + (r & 1) of the n-tile
      const int i = 8 * mi + g;
      if (i >= nc) continue;
#pragma unroll
      for (int nt = 0; nt < NS_NT; ++nt) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int c = cb + nt * 8 + 2 * tg + s;
          if (c >= c_hi) continue;
          int t, w;
          ns_column(a, c, w_cta, t, w);
          const bool edge = w == 0 || w == a.h - 1;   // DC and Nyquist
          out[((size_t)t * nc + i) * a.h + w] = make_float2(
              acc[nt][s] * a.scale, edge ? 0.f : -acc[nt][2 + s] * a.scale);
        }
      }
    }
  }
}

// K3b: item (trajectory j, 4-block b) of the phases of modes 4b..4b+3
__global__ void init_draw_kernel(float* out, const float* am, const float* hw,
                                 int ntraj, int n, unsigned lo, unsigned k0,
                                 unsigned k1) {
  const int nblk = (n + 3) / 4;
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long long)ntraj * nblk) return;
  const int j = (int)(item / nblk), b = (int)(item % nblk);
  const uint4 x = philox4x32_10(make_uint4((unsigned)b, 0u, lo + j, 0u), k0, k1);
  const unsigned ws[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = 4 * b + m;
    if (i >= n) break;
    const float u = ns_uniform(ws[m]);
    const size_t o = (size_t)j * n + i;
    if (am == nullptr) {
      out[o] = u;
    } else {
      float s, c;
      sincospif(2.f * u, &s, &c);
      const float a = __ldg(am + i);
      out[o] = a * c;
      out[(size_t)ntraj * n + o] = -(__ldg(hw + i) * a) * s;
    }
  }
}

extern "C" int noise_synth_tiles(int* bn, int* ldx) {
  *bn = NS_BN;
  *ldx = NS_LDX;
  return NS_MAX_THREADS;
}

template <bool AS>
static int ns_launch(const NsArgs& a, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      noise_synth_kernel<AS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  noise_synth_kernel<AS><<<a.grid, NS_MAX_THREADS, a.smem_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int noise_synth_f32(const NsArgs* a, void* stream) {
  const int threads = 32 * (a->pw + a->cw);
  if (a->ntraj < 1 || a->h < 1 || a->nc < 1 || a->ncp < a->nc ||
      a->ncp % 8 || a->lda < a->ncp || a->lda % 4 || a->pw < 1 ||
      a->cw < 1 || a->grid < 1 ||
      threads > NS_MAX_THREADS || a->smem_bytes > NS_SMEM_LIMIT ||
      (long long)a->h * a->ntraj * a->nc >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (threads != NS_MAX_THREADS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return a->a_smem ? ns_launch<true>(*a, st) : ns_launch<false>(*a, st);
}

// am == hw == null: the uniforms (ntraj, n); else the amplitudes (2, ntraj, n)
extern "C" int init_draw_f32(void* out, const void* am, const void* hw,
                             int ntraj, int n, unsigned lo, unsigned k0,
                             unsigned k1, void* stream) {
  if (ntraj < 1 || n < 1 || (am == nullptr) != (hw == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)ntraj * ((n + 3) / 4);
  const int threads = 256;
  const long long blocks = (items + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  init_draw_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)out, (const float*)am, (const float*)hw, ntraj, n, lo, k0, k1);
  return (int)cudaGetLastError();
}

// --- the C2R transform after K3: cuFFT plans cached per shape -------------
struct C2rPlan {
  int used, dev, nmd;
  long long batch;
  cufftHandle plan;
  size_t work;
};
#define NS_PLANS 8
static C2rPlan c2r_plans[NS_PLANS];
static int c2r_next = 0;

// the plan of ``batch`` contiguous nmd-point C2R transforms: input
// (batch, nmd/2 + 1) complex, output (batch, nmd) real, made with no
// work area of its own (the caller passes one)
static int c2r_plan(int nmd, long long batch, C2rPlan** out) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < NS_PLANS; ++i) {
    C2rPlan& p = c2r_plans[i];
    if (p.used && p.dev == dev && p.nmd == nmd && p.batch == batch) {
      *out = &p;
      return 0;
    }
  }
  C2rPlan& p = c2r_plans[c2r_next];
  c2r_next = (c2r_next + 1) % NS_PLANS;
  if (p.used) {
    cufftDestroy(p.plan);
    p.used = 0;
  }
  cufftResult r = cufftCreate(&p.plan);
  if (r != CUFFT_SUCCESS) return NS_CUFFT_ERR + (int)r;
  long long n[1] = {nmd};
  r = cufftSetAutoAllocation(p.plan, 0);
  if (r == CUFFT_SUCCESS)
    r = cufftMakePlanMany64(p.plan, 1, n, nullptr, 1, nmd / 2 + 1, nullptr,
                            1, nmd, CUFFT_C2R, batch, &p.work);
  if (r != CUFFT_SUCCESS) {
    cufftDestroy(p.plan);
    return NS_CUFFT_ERR + (int)r;
  }
  p.used = 1;
  p.dev = dev;
  p.nmd = nmd;
  p.batch = batch;
  *out = &p;
  return 0;
}

extern "C" int noise_c2r_plan(int nmd, long long batch, size_t* work) {
  if (nmd < 2 || nmd % 2 || batch < 1) return (int)cudaErrorInvalidValue;
  C2rPlan* p;
  const int rc = c2r_plan(nmd, batch, &p);
  if (rc) return rc;
  *work = p->work;
  return 0;
}

extern "C" int noise_c2r_f32(void* in, void* out, int nmd, long long batch,
                             void* work, void* stream) {
  if (nmd < 2 || nmd % 2 || batch < 1) return (int)cudaErrorInvalidValue;
  C2rPlan* p;
  int rc = c2r_plan(nmd, batch, &p);
  if (rc) return rc;
  if (p->work && !work) return (int)cudaErrorInvalidValue;
  cufftResult r = cufftSetStream(p->plan, (cudaStream_t)stream);
  if (r == CUFFT_SUCCESS) r = cufftSetWorkArea(p->plan, work);
  if (r == CUFFT_SUCCESS)
    r = cufftExecC2R(p->plan, (cufftComplex*)in, (cufftReal*)out);
  if (r != CUFFT_SUCCESS) return NS_CUFFT_ERR + (int)r;
  return (int)cudaGetLastError();
}

// out[b, c, r] = in[b, r, c] for in (nb, rows, cols) float32
#define NS_TT 32
__global__ void __launch_bounds__(NS_TT * 8)
    noise_transpose_kernel(const float* __restrict__ in,
                           float* __restrict__ out, int rows, int cols) {
  __shared__ float tile[NS_TT][NS_TT + 1];
  const size_t base = (size_t)blockIdx.z * rows * cols;
  const int c0 = blockIdx.x * NS_TT, r0 = blockIdx.y * NS_TT;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = ty; j < NS_TT; j += 8) {
    const int r = r0 + j, c = c0 + tx;
    if (r < rows && c < cols)
      tile[j][tx] = __ldg(in + base + (size_t)r * cols + c);
  }
  __syncthreads();
#pragma unroll
  for (int j = ty; j < NS_TT; j += 8) {
    const int c = c0 + j, r = r0 + tx;
    if (r < rows && c < cols) out[base + (size_t)c * rows + r] = tile[tx][j];
  }
}

extern "C" int noise_transpose_f32(const void* in, void* out, int nb,
                                   int rows, int cols, void* stream) {
  if (nb < 1 || rows < 1 || cols < 1 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + NS_TT - 1) / NS_TT, (rows + NS_TT - 1) / NS_TT, nb);
  noise_transpose_kernel<<<grid, dim3(NS_TT, 8), 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, rows, cols);
  return (int)cudaGetLastError();
}
