// K13 — dp_descriptor: DeepPot-SE's descriptor from the embedding net's
// last hidden activation, for every atom of a batch of configurations:
// the forward pass (dp_descriptor_fwd) and its input gradient
// (dp_descriptor_bwd), float32, sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves its DeepPot-SE
// (sclmd_tpu/models/nnp.py:119 DeepPotSE) to XLA's fusion of the
// products and of their gradient. It was added because the port's
// autograd of the per-entry form spent 46 % of an evaluation in cuBLAS
// products on 4- to 100-wide operands and in the 100-wide per-entry
// embedding they wrote and read (PERF.md, Findings).
//
// For an atom's row of nn table entries j (padding entries have R_j = 0),
// h2_j its embedding's last hidden activation (h wide), t_j its neighbour
// type and (W3_t, b3_t) the embedding's last layer of type t, which is
// linear (no activation follows a net's last layer):
//
//   G^T = (1/nn) sum_j R_j^T (h2_j W3_{t_j} + b3_{t_j})       (4, E)
//   D   = G^T^T G^T[:, :naxis], flattened a-major: D[a naxis + b]
//
// A linear layer moves past the sum over entries, exactly:
//
//   G^T = sum_t (A_t W3_t + r1_t b3_t^T) / nn,
//   A_t = sum_{j: t_j = t} R_j^T h2_j  (4, h),   r1_t = sum_{j: t_j = t} R_j
//
// so an entry costs 4 h multiply-adds (not 4 E + h E) and nothing E wide
// exists per entry. The gradient from dD, by the same identities:
//
//   dG^T[k][a] = sum_{b < naxis} G^T[k][b] dD[a][b]
//                + [a < naxis] sum_c G^T[k][c] dD[c][a]
//   M_t = dG^T W3_t^T / nn  (4, h),   q_t = dG^T b3_t / nn  (4)
//   dh2_j = R_j M_{t_j},   dR_j[k] = M_{t_j}[k] . h2_j + q_{t_j}[k]
//
// What bounds it on the H100: bytes. On the silicon slab at 4
// trajectories (13,824 rows of 48 entries; h 50, E 100, naxis 16) the
// forward reads h2 (133 MB) and R, and writes D (88 MB) and G^T (22 MB);
// the backward reads dD, G^T, h2 and R and writes dh2 and dR: about 246
// and 381 MB, 0.073 and 0.114 ms at 3.35 TB/s, against 1.0 and 1.3 GFLOP
// (0.015 and 0.020 ms at 67 TFLOP/s float32).
//
// The design. A warp takes one atom's row at a time (rows in a
// grid-stride loop); a block stages the weights W3, b3 once in shared
// memory (W3 at an odd row pitch, so that a lane an input column reads it
// without bank conflicts). Both kernels walk a row's entries a lane an
// input column c, DP_GROUP entries at a time, through a ring of DP_STAGES
// stages in the warp's shared memory that 16-byte cp.async fills (a
// group's h2 rows, then its R), DP_STAGES - 1 groups ahead of the one in
// use: the loads of a row are in flight together, and no register holds
// them. On the silicon slab this took the pair from 0.49 ms (each lane
// loading its entries as it used them) to 0.29 on an H100 (PERF.md).
//   Forward: the walk runs on across the warp's rows and adds each group
// into A and r1 in entry order; at a row's last group a lane an output
// column forms G^T from A (broadcast from shared memory), writes it (kept
// for the backward as (rows, E, 4)), and the lanes write D's row four
// values a store.
//   Backward: G^T's and dD's rows reach shared memory by 16-byte cp.async
// (dD's 16-byte pieces swizzled, so that a lane an output column reads its
// row's pieces without bank conflicts); a lane an output column forms
// dG^T (the second factor's term split over lane groups and summed by
// shuffles). The walk's ring then takes dD's place and its first groups
// fly while the warp forms q and, a lane an input column, M. The walk
// writes dh2_j (a lane its column) and forms each lane's share of
// M . h2_j for the group's 8 entries and 4 axes: 32 numbers that one
// butterfly of shuffles sums across the warp, leaving entry l / 4's axis
// l % 4 on lane l, so that dR's rows are written coalesced.
// Every sum runs in a fixed order, with no atomics: a launch gives the
// same bits at any grid, and a graph replay the eager run's bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define DP_MAX_TYPES 4
#define DP_MAX_IN 64    // h: two 32-wide column slots a lane
#define DP_MAX_EMB 128  // E: four 32-wide column slots a lane
#define DP_MAX_AXIS 32  // and a multiple of 4
#define DP_WARPS 8
#define DP_GROUP 8      // entries a group of the walk (8 x 4 axes = 32 lanes)
#define DP_SMEM_MAX (227 * 1024)
#define DP_FULL 0xffffffffu
#define DP_STAGES 3     // the walk's ring: two groups in flight ahead

struct DpArgs {
  const float* h2;   // (rows, nn, h)
  const float* R;    // (rows, nn, 4)
  const int* ntype;  // (na, nn) neighbour types; null with one type
  const float* w3;   // (nt, h, E)
  const float* b3;   // (nt, E)
  float* D;          // (rows, E naxis)            forward's output
  float* GT;         // (rows, E, 4)               forward's, backward's input
  const float* dD;   // (rows, E naxis)            backward's input
  float* dh2;        // (rows, nn, h)              backward's outputs
  float* dR;         // (rows, nn, 4)
  int rows, na, nn, h, e, naxis, nt;
};

__host__ __device__ inline int dp_up4(int n) { return (n + 3) & ~3; }

// floats of shared memory: the block's weights, and each warp's region
// (forward: A by type and input column, G^T, the walk's ring; backward:
// G^T, dG^T, and dD's row or the walk's ring)
__host__ __device__ inline int dp_head(const DpArgs& a) {
  return dp_up4(a.nt * a.h * (a.e | 1) + a.nt * a.e);
}
// a stage of the walk's ring: a group's h2 rows, then its R
__host__ __device__ inline int dp_stage_floats(const DpArgs& a) {
  return dp_up4(DP_GROUP * a.h) + 4 * DP_GROUP;
}
__host__ __device__ inline int dp_fwd_warp(const DpArgs& a) {
  return 4 * (a.nt * a.h + a.e) + DP_STAGES * dp_stage_floats(a);
}
__host__ __device__ inline int dp_bwd_warp(const DpArgs& a) {
  const int x = a.e * a.naxis, r = DP_STAGES * dp_stage_floats(a);
  return 8 * a.e + (x > r ? x : r);
}

__device__ inline void dp_stage_weights(const DpArgs& a, float* w, float* b) {
  const int ep = a.e | 1, n = a.nt * a.h * a.e;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const int r = x / a.e;
    w[r * ep + (x - r * a.e)] = __ldg(a.w3 + x);
  }
  for (int x = threadIdx.x; x < a.nt * a.e; x += blockDim.x)
    b[x] = __ldg(a.b3 + x);
  __syncthreads();
}

__device__ __forceinline__ void dp_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ inline void dp_fma4(float4& acc, const float4& v, float s) {
  acc.x = fmaf(v.x, s, acc.x);
  acc.y = fmaf(v.y, s, acc.y);
  acc.z = fmaf(v.z, s, acc.z);
  acc.w = fmaf(v.w, s, acc.w);
}

__device__ inline float dp_warp_sum(float v) {
  // a butterfly: every lane ends with the same bits
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(DP_FULL, v, off);
  return v;
}

// a stage of the butterfly over 2 O numbers a lane (O = 16, 8, .., 1): a
// lane keeps the half that its bit O names and adds its partner's share of
// that half, so that after the five stages lane l holds the warp's sum of
// number l
template <int O>
__device__ __forceinline__ void dp_stage(float* v, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(DP_FULL, send, O);
  }
}

__device__ __forceinline__ void dp_cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void dp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void dp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the copies of a group of the walk (entries s0 .. of a row, DP_GROUP or
// the row's last ones) into a stage by the warp's lanes: h2's rows (16-byte
// pieces where the group's start and length allow), then R
__device__ inline void dp_issue(const DpArgs& a, float* st, int row, int s0,
                                int lane) {
  const int ns = min(DP_GROUP, a.nn - s0), n = ns * a.h;
  const size_t j0 = (size_t)row * a.nn + s0;
  const float* hs = a.h2 + j0 * a.h;
  if (!(reinterpret_cast<uintptr_t>(hs) & 15) && !(n & 3)) {
    for (int x = 4 * lane; x < n; x += 128) dp_cp16(st + x, hs + x);
  } else {
    for (int x = lane; x < n; x += 32) dp_cp4(st + x, hs + x);
  }
  if (lane < ns)
    dp_cp16(st + dp_up4(DP_GROUP * a.h) + 4 * lane, a.R + (j0 + lane) * 4);
}

template <int NT>
__global__ void __launch_bounds__(32 * DP_WARPS)
    dp_descriptor_fwd(DpArgs a) {
  extern __shared__ float4 dp_smem[];
  float* sm = reinterpret_cast<float*>(dp_smem);
  const int h = a.h, e = a.e, nn = a.nn, ep = e | 1;
  const int n4 = a.naxis / 4;  // D's row, four values a store
  float* w3s = sm;
  float* b3s = sm + NT * h * ep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* At = reinterpret_cast<float4*>(sm + dp_head(a) +
                                         warp * dp_fwd_warp(a));
  float4* Gt = At + NT * h;
  float* ring = reinterpret_cast<float*>(Gt + e);
  const int sz = dp_stage_floats(a), hsz = dp_up4(DP_GROUP * h);
  dp_stage_weights(a, w3s, b3s);
  const float fnn = (float)nn;
  const bool c0 = lane < h, c1 = lane + 32 < h;
  const int ng = (nn + DP_GROUP - 1) / DP_GROUP;
  const int row0 = blockIdx.x * DP_WARPS + warp, stride = gridDim.x * DP_WARPS;
  // the warp's groups in order, across its rows: group it % ng of row
  // row0 + it / ng stride, DP_STAGES - 1 of them in flight ahead
  auto issue = [&](int it) {
    const int row = row0 + (it / ng) * stride;
    if (row < a.rows)
      dp_issue(a, ring + (it % DP_STAGES) * sz, row, (it % ng) * DP_GROUP,
               lane);
    dp_commit();
  };
  float4 acc[NT][2], r1[NT];
#pragma unroll
  for (int i = 0; i < DP_STAGES - 1; ++i) issue(i);
  for (int it = 0;; ++it) {
    const int row = row0 + (it / ng) * stride;
    if (row >= a.rows) break;
    issue(it + DP_STAGES - 1);
    dp_wait<DP_STAGES - 1>();
    __syncwarp();
    const int gi = it % ng, s0 = gi * DP_GROUP;
    const float* st = ring + (it % DP_STAGES) * sz;
    const float4* sr = reinterpret_cast<const float4*>(st + hsz);
    const int* tr =
        NT > 1 ? a.ntype + (size_t)(row % a.na) * nn + s0 : nullptr;
    if (gi == 0) {
#pragma unroll
      for (int u = 0; u < NT; ++u)
        acc[u][0] = acc[u][1] = r1[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // A_t and r1_t over the group's entries in order, a lane an input
    // column
#pragma unroll
    for (int j = 0; j < DP_GROUP; ++j) {
      if (s0 + j < nn) {
        const float4 r = sr[j];
        const float x0 = c0 ? st[j * h + lane] : 0.f;
        const float x1 = c1 ? st[j * h + lane + 32] : 0.f;
        const int t = NT > 1 ? __ldg(tr + j) : 0;
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          // another type's entry adds exact zeros
          const float4 rt = (NT == 1 || t == u)
                                ? r
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          dp_fma4(acc[u][0], rt, x0);
          dp_fma4(acc[u][1], rt, x1);
          r1[u].x += rt.x;
          r1[u].y += rt.y;
          r1[u].z += rt.z;
          r1[u].w += rt.w;
        }
      }
    }
    if (gi == ng - 1) {
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        if (c0) At[u * h + lane] = acc[u][0];
        if (c1) At[u * h + lane + 32] = acc[u][1];
      }
      __syncwarp();
      // G^T, a lane an output column: (A W3 + r1 b3) / nn
      float4 g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) g[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const float* wu = w3s + u * h * ep + lane;
#pragma unroll 2
        for (int c = 0; c < h; ++c) {
          const float4 av = At[u * h + c];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (lane + 32 * j < e) dp_fma4(g[j], av, wu[c * ep + 32 * j]);
        }
      }
      float4* gdst = reinterpret_cast<float4*>(a.GT) + (size_t)row * e;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ej = lane + 32 * j;
        if (ej < e) {
#pragma unroll
          for (int u = 0; u < NT; ++u) dp_fma4(g[j], r1[u], b3s[u * e + ej]);
          g[j].x /= fnn;
          g[j].y /= fnn;
          g[j].z /= fnn;
          g[j].w /= fnn;
          Gt[ej] = g[j];
          gdst[ej] = g[j];
        }
      }
      __syncwarp();
      // D[a naxis + b] = sum_k G^T[k][a] G^T[k][b], four b a lane and
      // store, the row written coalesced
      float4* dr = reinterpret_cast<float4*>(a.D) + (size_t)row * e * n4;
      int ia = lane / n4, ib = lane - ia * n4;
      const int da = 32 / n4, db = 32 - da * n4;
      for (int x = lane; x < e * n4; x += 32) {
        const float4 p = Gt[ia];
        float d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 q = Gt[4 * ib + i];
          d[i] = fmaf(p.w, q.w, fmaf(p.z, q.z, fmaf(p.y, q.y, p.x * q.x)));
        }
        dr[x] = make_float4(d[0], d[1], d[2], d[3]);
        ia += da;
        ib += db;
        if (ib >= n4) {
          ib -= n4;
          ++ia;
        }
      }
    }
    __syncwarp();  // the stage, and At and Gt, free for what follows
  }
  dp_wait<0>();
}

template <int NT>
__global__ void __launch_bounds__(32 * DP_WARPS)
    dp_descriptor_bwd(DpArgs a) {
  extern __shared__ float4 dp_smem[];
  float* sm = reinterpret_cast<float*>(dp_smem);
  const int h = a.h, e = a.e, nn = a.nn, naxis = a.naxis, ep = e | 1;
  const int n4 = naxis / 4;
  float* w3s = sm;
  float* b3s = sm + NT * h * ep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* Gt = reinterpret_cast<float4*>(sm + dp_head(a) +
                                         warp * dp_bwd_warp(a));
  float4* dGt = Gt + e;
  float4* X4 = dGt + e;  // dD's row (its 16-byte pieces swizzled), then
                         // the walk's ring
  const float* X = reinterpret_cast<const float*>(X4);
  float* ring = reinterpret_cast<float*>(X4);
  const int sz = dp_stage_floats(a), hsz = dp_up4(DP_GROUP * h);
  dp_stage_weights(a, w3s, b3s);
  const float fnn = (float)nn;
  const bool c0 = lane < h, c1 = lane + 32 < h;
  const int ng = (nn + DP_GROUP - 1) / DP_GROUP;
  // the swizzle: piece b4 of dD's row a sits at b4 ^ ((a >> sh) & msk)
  // where n4 is a power of two, so that the 8 lanes of a quarter warp
  // reading piece b4 of rows a .. a + 7 meet 8 different bank groups
  int sh = 3, msk = 0;
  if (!(n4 & (n4 - 1))) {
    msk = n4 - 1;
    for (int p = n4; p > 1; p >>= 1) --sh;
  }
  int P = 1;  // the lanes of a group of the second term: naxis rounded up
  while (P < naxis) P <<= 1;
  for (int row = blockIdx.x * DP_WARPS + warp; row < a.rows;
       row += gridDim.x * DP_WARPS) {
    const int* tr = NT > 1 ? a.ntype + (size_t)(row % a.na) * nn : nullptr;
    // G^T's and dD's rows to shared memory, every piece in flight at once
    {
      const float4* gsrc = reinterpret_cast<const float4*>(a.GT) +
                           (size_t)row * e;
      for (int x = lane; x < e; x += 32) dp_cp16(Gt + x, gsrc + x);
      const float4* dsrc = reinterpret_cast<const float4*>(a.dD) +
                           (size_t)row * e * n4;
      int ia = lane / n4, ib = lane - ia * n4;
      const int da = 32 / n4, db = 32 - da * n4;
      for (int x = lane; x < e * n4; x += 32) {
        dp_cp16(X4 + ia * n4 + (ib ^ ((ia >> sh) & msk)), dsrc + x);
        ia += da;
        ib += db;
        if (ib >= n4) {
          ib -= n4;
          ++ia;
        }
      }
      dp_commit();
      dp_wait<0>();
    }
    __syncwarp();
    // dG^T, a lane an output column
    float4 dg[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dg[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b4 = 0; b4 < n4; ++b4) {
      const float4 g0 = Gt[4 * b4], g1 = Gt[4 * b4 + 1],
                   g2 = Gt[4 * b4 + 2], g3 = Gt[4 * b4 + 3];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ej = lane + 32 * j;
        if (ej < e) {
          const float4 x = X4[ej * n4 + (b4 ^ ((ej >> sh) & msk))];
          dp_fma4(dg[j], g0, x.x);
          dp_fma4(dg[j], g1, x.y);
          dp_fma4(dg[j], g2, x.z);
          dp_fma4(dg[j], g3, x.w);
        }
      }
    }
    {
      // the second factor's term, for a < naxis: the columns c split over
      // the warp's 32 / P groups of P lanes, the groups' sums added by
      // shuffles
      const int a2 = lane & (P - 1);
      float4 t2 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a2 < naxis)
        for (int c = lane / P; c < e; c += 32 / P)
          dp_fma4(t2, Gt[c],
                  X[c * naxis + 4 * ((a2 >> 2) ^ ((c >> sh) & msk)) +
                    (a2 & 3)]);
      for (int off = P; off < 32; off <<= 1) {
        t2.x += __shfl_xor_sync(DP_FULL, t2.x, off);
        t2.y += __shfl_xor_sync(DP_FULL, t2.y, off);
        t2.z += __shfl_xor_sync(DP_FULL, t2.z, off);
        t2.w += __shfl_xor_sync(DP_FULL, t2.w, off);
      }
      if (lane < naxis) {
        dg[0].x += t2.x;
        dg[0].y += t2.y;
        dg[0].z += t2.z;
        dg[0].w += t2.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (lane + 32 * j < e) dGt[lane + 32 * j] = dg[j];
    __syncwarp();  // dD read: the ring takes its place
    // the walk's first groups in flight while q and M are formed
    auto issue = [&](int gi) {
      if (gi < ng)
        dp_issue(a, ring + (gi % DP_STAGES) * sz, row, gi * DP_GROUP, lane);
      dp_commit();
    };
#pragma unroll
    for (int i = 0; i < DP_STAGES - 1; ++i) issue(i);
    // q_t = dG^T b3_t / nn: the lanes' columns, then the warp's sum
    float4 q[NT];
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (lane + 32 * j < e) dp_fma4(v, dg[j], b3s[u * e + lane + 32 * j]);
      q[u].x = dp_warp_sum(v.x) / fnn;
      q[u].y = dp_warp_sum(v.y) / fnn;
      q[u].z = dp_warp_sum(v.z) / fnn;
      q[u].w = dp_warp_sum(v.w) / fnn;
    }
    // M_t / nn, a lane an input column
    float4 m[NT][2];
#pragma unroll
    for (int u = 0; u < NT; ++u)
      m[u][0] = m[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int x = 0; x < e; ++x) {
      const float4 gv = dGt[x];
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const float* wu = w3s + u * h * ep + x;
        if (c0) dp_fma4(m[u][0], gv, wu[lane * ep]);
        if (c1) dp_fma4(m[u][1], gv, wu[(lane + 32) * ep]);
      }
    }
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[u][i].x /= fnn;
        m[u][i].y /= fnn;
        m[u][i].z /= fnn;
        m[u][i].w /= fnn;
      }
    // the walk: dh2_j = R_j M_{t_j}, a lane its input column; and each
    // lane's share of M_{t_j} . h2_j for the group's entries and axes,
    // summed across the warp by a butterfly that leaves entry l / 4's axis
    // l % 4 on lane l, plus q_{t_j}: dR's rows, coalesced
    float* dh = a.dh2 + (size_t)row * nn * h;
    float* dRr = a.dR + (size_t)row * nn * 4;
    for (int gi = 0; gi < ng; ++gi) {
      issue(gi + DP_STAGES - 1);
      dp_wait<DP_STAGES - 1>();
      __syncwarp();
      const int s0 = gi * DP_GROUP;
      const float* st = ring + (gi % DP_STAGES) * sz;
      const float4* sr = reinterpret_cast<const float4*>(st + hsz);
      float v[4 * DP_GROUP];
      int tg[DP_GROUP];
#pragma unroll
      for (int j = 0; j < DP_GROUP; ++j) {
        const int s = s0 + j;
        const bool in = s < nn;
        tg[j] = NT > 1 && in ? __ldg(tr + s) : 0;
        float4 m0 = m[0][0], m1 = m[0][1];
#pragma unroll
        for (int u = 1; u < NT; ++u)
          if (tg[j] == u) {
            m0 = m[u][0];
            m1 = m[u][1];
          }
        const float4 r = in ? sr[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float x0 = in && c0 ? st[j * h + lane] : 0.f;
        const float x1 = in && c1 ? st[j * h + lane + 32] : 0.f;
        if (in) {
          if (c0)
            dh[(size_t)s * h + lane] = fmaf(
                r.w, m0.w, fmaf(r.z, m0.z, fmaf(r.y, m0.y, r.x * m0.x)));
          if (c1)
            dh[(size_t)s * h + lane + 32] = fmaf(
                r.w, m1.w, fmaf(r.z, m1.z, fmaf(r.y, m1.y, r.x * m1.x)));
        }
        v[4 * j] = fmaf(m1.x, x1, m0.x * x0);
        v[4 * j + 1] = fmaf(m1.y, x1, m0.y * x0);
        v[4 * j + 2] = fmaf(m1.z, x1, m0.z * x0);
        v[4 * j + 3] = fmaf(m1.w, x1, m0.w * x0);
      }
      dp_stage<16>(v, lane);
      dp_stage<8>(v, lane);
      dp_stage<4>(v, lane);
      dp_stage<2>(v, lane);
      dp_stage<1>(v, lane);
      const int j = lane >> 2, k = lane & 3;
      if (s0 + j < nn) {
        int tj = tg[0];
#pragma unroll
        for (int i = 1; i < DP_GROUP; ++i)
          if (i == j) tj = tg[i];
        float4 qq = q[0];
#pragma unroll
        for (int u = 1; u < NT; ++u)
          if (tj == u) qq = q[u];
        const float qk = k == 0 ? qq.x : k == 1 ? qq.y : k == 2 ? qq.z : qq.w;
        dRr[(size_t)s0 * 4 + lane] = v[0] + qk;
      }
      __syncwarp();  // the stage free for the copies issued next
    }
    dp_wait<0>();
  }
}

static int dp_check(const DpArgs& a, bool grad) {
  if (a.rows < 1 || a.na < 1 || a.rows % a.na || a.nn < 1 || a.h < 1 ||
      a.h > DP_MAX_IN || a.e < 1 || a.e > DP_MAX_EMB || a.naxis < 4 ||
      a.naxis > DP_MAX_AXIS || (a.naxis & 3) || a.naxis > a.e || a.nt < 1 ||
      a.nt > DP_MAX_TYPES || (a.nt > 1 && !a.ntype) || !a.h2 || !a.R ||
      !a.w3 || !a.b3 || !a.GT)
    return (int)cudaErrorInvalidValue;
  if (grad ? (!a.dD || !a.dh2 || !a.dR) : !a.D)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads of R, G^T and dD, 16-byte stores of D
  if ((reinterpret_cast<uintptr_t>(a.R) & 15) ||
      (reinterpret_cast<uintptr_t>(a.GT) & 15) ||
      (grad ? (reinterpret_cast<uintptr_t>(a.dD) & 15)
            : (reinterpret_cast<uintptr_t>(a.D) & 15)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int NT>
static int dp_launch(const DpArgs& a, bool grad, cudaStream_t st) {
  static int smem_set[2] = {0, 0};
  static int nsm = 0;
  void (*fn)(DpArgs) = grad ? dp_descriptor_bwd<NT> : dp_descriptor_fwd<NT>;
  const int smem =
      4 * (dp_head(a) + DP_WARPS * (grad ? dp_bwd_warp(a) : dp_fwd_warp(a)));
  if (smem > DP_SMEM_MAX) return (int)cudaErrorInvalidValue;
  int rc;
  if (smem > smem_set[grad]) {
    rc = (int)cudaFuncSetAttribute((const void*)fn,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
    if (rc) return rc;
    smem_set[grad] = smem;
  }
  if (!nsm) {
    int dev = 0;
    rc = (int)cudaGetDevice(&dev);
    if (!rc)
      rc = (int)cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                       dev);
    if (rc) return rc;
  }
  int occ = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, fn, 32 * DP_WARPS, (size_t)smem);
  if (rc) return rc;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  // as few rows a warp as the resident warps allow, then as few blocks as
  // give every warp that many
  const long slots = (long)nsm * occ * DP_WARPS;
  const long per = (a.rows + slots - 1) / slots;
  const long blocks = (a.rows + per * DP_WARPS - 1) / (per * DP_WARPS);
  fn<<<(unsigned)blocks, 32 * DP_WARPS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

static int dp_dispatch(const DpArgs* args, bool grad, void* stream) {
  const DpArgs& a = *args;
  const int rc = dp_check(a, grad);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.nt) {
    case 1: return dp_launch<1>(a, grad, st);
    case 2: return dp_launch<2>(a, grad, st);
    case 3: return dp_launch<3>(a, grad, st);
    default: return dp_launch<4>(a, grad, st);
  }
}

extern "C" int dp_descriptor_f32(const DpArgs* args, void* stream) {
  return dp_dispatch(args, false, stream);
}

extern "C" int dp_descriptor_grad_f32(const DpArgs* args, void* stream) {
  return dp_dispatch(args, true, stream);
}
