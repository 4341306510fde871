// The common half of K9 (sw_force.cu) and K10 (eam_force.cu): the slot
// table of a per-centre many-body force, the layout of a batch with a
// trajectory on each lane, and the two launches around each kernel's
// centre pass (the transpose of q in, the gather of the forces out).
//
// A *slot* is one live entry (i, j) of the padded neighbour table, listed
// row by row (a compacted CSR by centre i; i is the slot's tail, j its
// head). Every term of the energy is a function of the slots' difference
// vectors
//   d = x_j - x_i = d0 + (u_j - u_i),   u = conv q,
// with d0 taken on the host from the float64 reference geometry (minimum
// image in a cell), so the float32 rounding of a 65-angstrom coordinate
// never enters a 2.35-angstrom bond. In a periodic cell d then takes the
// minimum image on each periodic axis, d -= L rint(d / L) (rint is half
// to even, as the reference's jnp.round), skipped where |d| < L / 2, where
// it would subtract a zero.
//
// Layout: a warp is one centre for 32 trajectories (a trajectory group,
// one per lane), so every lane reads the same table entry (one broadcast)
// and a neighbour's coordinate is one 128-byte row across the warp. Three
// launches an evaluation:
//   1. slot_transpose_kernel: u = conv q, stored (3 na, tp), trajectory
//      innermost, tp = ntraj rounded up to 32; the pad columns are zero;
//   2. the centre pass (each kernel's own file): a block is a tile of
//      consecutive centres of one trajectory group; its rows of the table
//      are staged once in shared memory by cp.async and serve the
//      block's 32 trajectories. A warp writes dE_i/dd of every slot of its
//      row that some lane of the group takes (inside the cutoff) as whole
//      rows of g (ns, 3, tp), marks those slots in live (ntg, ns), adds
//      its own (tail) share into the centre's force in registers and
//      stores it in ftail (3 na, tp);
//   3. slot_gather_kernel: each atom's force is its ftail minus the
//      live slots it is the head of, in a fixed order from a list made
//      once on the host, scaled by conv, minus f0; written through shared
//      memory in the (ntraj, 3 na) layout of the integrator.
// Where a slot's gradient is a scalar times its own vector (a pair term,
// K10), g holds the scalar only, (ns, tp), and the gather takes the
// vector again from the record and u (L2-resident) with the same
// arithmetic as the centre pass: a third of the bytes.
// The energy sums only the centre's own row, so the force is the gradient
// of that sum even where the table is not symmetric (a truncated table: j
// in row i without i in row j). Every decision a lane takes on its own
// trajectory (the cutoff, what it adds) depends on its data alone, and a
// slot stored for another lane holds +0 for this one, which subtracts
// nothing: a trajectory's force has the same bits in any batch. No float
// atomics, so two calls on the same input agree bitwise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SLOT_LANES 32            // trajectories of a warp (a group)
#define SLOT_MAX_WARPS 4         // centres (warps) of a centre-pass block
#define SLOT_CHUNK 4             // slots whose loads a walk issues together
#define SLOT_GATHER_WARPS 8      // atoms (warps) of a gather block
#define SLOT_SMEM_MAX 232448     // shared memory a block may take (H100)

struct SlotArgs {
  const float* q;        // (ntraj, 3 na) mass-weighted displacements
  float* f;              // (ntraj, 3 na) out: conv * F - f0
  float* e;              // (ntraj) out: energy, or null
  float* u;              // (3 na, tp) scratch: conv q, trajectory innermost
  float* g;              // (ns, 3, tp) scratch: the live slots' gradients,
                         // or (ns, tp) their scalars where scalar is 1
  float* ftail;          // (3 na, tp) scratch: each centre's own share
  float* ecen;           // (na, tp) scratch: each centre's energy
  unsigned char* live;   // (ntg, ns) scratch: 1 where a lane takes the slot
  float* scr;            // a kernel's per-lane scratch on the wide route
  const int* row_ptr;    // (na + 1) slots of centre i: [row_ptr[i], row_ptr[i+1])
  const int4* rec;       // (ns) per slot: float bits of d0 (x, y, z), head j
  const int* head_ptr;   // (na + 1) each atom's list in head
  const int2* head;      // (ns) (slot, its tail) of the slots each atom is
                         // the head of, in slot order
  const float* conv;     // (3 na)
  const float* f0;       // (3 na) the kernel's own force at rest, or null
  int ntraj, na, ns, tp;
  int wpb;               // centres (warps) of a centre-pass block
  int width;             // the widest row (its shared memory per warp)
  int wide;              // 1: rows not staged, scratch in global memory
  int scalar;            // 1: g holds a scalar a slot (gradient = g d)
  float cx, cy, cz;      // periodic lengths, 0 on an open axis
};

__device__ __forceinline__ float slot_mic(float d, float c) {
  return (c > 0.f && fabsf(d) >= 0.5f * c) ? d - c * rintf(d / c) : d;
}

// the difference vector of a slot (record r4) for this lane's trajectory,
// whose centre moved by (uix, uiy, uiz); u points at the lane's column
__device__ __forceinline__ float3 slot_vec(const SlotArgs& s, const float* u,
                                           int4 r4, float uix, float uiy,
                                           float uiz) {
  const size_t tp = s.tp, j3 = 3 * (size_t)r4.w;
  const float dx = __int_as_float(r4.x) + (u[j3 * tp] - uix);
  const float dy = __int_as_float(r4.y) + (u[(j3 + 1) * tp] - uiy);
  const float dz = __int_as_float(r4.z) + (u[(j3 + 2) * tp] - uiz);
  return make_float3(slot_mic(dx, s.cx), slot_mic(dy, s.cy),
                     slot_mic(dz, s.cz));
}

// x^n for an integer n of 0 to 63, by multiplies (the squarings of x
// taken in turn, those of n's bits multiplied in: no branch)
__device__ __forceinline__ float powi(float x, int n) {
  float acc = 1.f;
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    acc = (n >> b) & 1 ? acc * x : acc;
    x *= x;
  }
  return acc;
}

// x^e for x > 0: by multiplies where the power is a small non-negative
// integer (ni, its value), by powf where it is not (ni = -1)
__device__ __forceinline__ float power(float x, int ni, float e) {
  return ni >= 0 ? powi(x, ni) : powf(x, e);
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sa),
                 "l"(gmem));
}

// The block's rows [c0, c0 + wpb) of the table: their slot records (16
// bytes a slot) and, where extra is given, an 8-byte word a slot of
// another per-slot array, copied once into shared memory (records first,
// then the extra words) by cp.async. Returns the block's first slot; the
// slot k of these rows is then rec[k - first]. Every thread of the block
// calls it, before any returns.
__device__ __forceinline__ int slot_stage(const SlotArgs& s, int c0,
                                          int4* rec, const int2* extra,
                                          int2* xs) {
  const int c1 = min(c0 + s.wpb, s.na);
  const int k0 = s.row_ptr[c0], n = s.row_ptr[c1] - k0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    cp_async(rec + k, s.rec + k0 + k, 16);
    if (extra) cp_async(xs + k, extra + k0 + k, 8);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  __syncthreads();
  return k0;
}

// blockIdx.x < atom tiles: the forces of SLOT_GATHER_WARPS atoms (a warp
// each) of trajectory group blockIdx.y; the block after them (when the
// energy is asked for): the group's energies, the centres' energies
// summed in a fixed order (static: each file that includes this header
// has its own copy)
template <bool kScalar>
static __global__ void __launch_bounds__(SLOT_GATHER_WARPS * 32)
slot_gather_kernel(const SlotArgs s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tg = blockIdx.y, t = tg * SLOT_LANES + lane;
  const size_t tp = s.tp;
  const int ntile = (s.na + SLOT_GATHER_WARPS - 1) / SLOT_GATHER_WARPS;
  if ((int)blockIdx.x == ntile) {
    __shared__ float red[SLOT_GATHER_WARPS][SLOT_LANES];
    const int per = (s.na + SLOT_GATHER_WARPS - 1) / SLOT_GATHER_WARPS;
    const int i1 = min(s.na, (warp + 1) * per);
    float acc = 0.f;
    for (int i = warp * per; i < i1; ++i) acc += s.ecen[(size_t)i * tp + t];
    red[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && t < s.ntraj) {
      float tot = 0.f;
      for (int w = 0; w < SLOT_GATHER_WARPS; ++w) tot += red[w][lane];
      s.e[t] = tot;
    }
    return;
  }
  // [trajectory][3 x atom of the tile], odd row length: no bank conflicts
  __shared__ float tile[SLOT_LANES][3 * SLOT_GATHER_WARPS + 1];
  const int a0 = blockIdx.x * SLOT_GATHER_WARPS, at = a0 + warp;
  if (at < s.na) {
    const unsigned char* live = s.live + (size_t)tg * s.ns;
    const float* ft = s.ftail + 3 * (size_t)at * tp + t;
    float fx = ft[0], fy = ft[tp], fz = ft[2 * tp];
    const float* u = s.u + t;
    const size_t a3 = 3 * (size_t)at;
    const float uax = u[a3 * tp], uay = u[(a3 + 1) * tp],
                uaz = u[(a3 + 2) * tp];
    const int e1 = s.head_ptr[at + 1];
    // every load of an entry is issued before its first use, none under
    // a branch (a slot that is not live this call holds what an earlier
    // call left: it is read and not used)
#pragma unroll 4
    for (int e = s.head_ptr[at]; e < e1; ++e) {
      const int2 kt = s.head[e];
      const bool lv = live[kt.x] != 0;
      if (kScalar) {
        const float c0 = s.g[(size_t)kt.x * tp + t];
        const int4 r4 = s.rec[kt.x];
        const size_t i3 = 3 * (size_t)kt.y;
        const float uix = u[i3 * tp], uiy = u[(i3 + 1) * tp],
                    uiz = u[(i3 + 2) * tp];
        // the slot's vector as its centre took it (slot_vec: d0 + (u_j -
        // u_i), the atom the head j); a lane that does not take the slot
        // holds 0 and subtracts nothing
        const float c = lv ? c0 : 0.f;
        if (c != 0.f) {
          const float dx = slot_mic(__int_as_float(r4.x) + (uax - uix), s.cx);
          const float dy = slot_mic(__int_as_float(r4.y) + (uay - uiy), s.cy);
          const float dz = slot_mic(__int_as_float(r4.z) + (uaz - uiz), s.cz);
          fx -= __fmul_rn(c, dx);
          fy -= __fmul_rn(c, dy);
          fz -= __fmul_rn(c, dz);
        }
      } else {
        const float* gk = s.g + 3 * (size_t)kt.x * tp + t;
        const float g0 = gk[0], g1 = gk[tp], g2 = gk[2 * tp];
        if (lv) {
          fx -= g0;
          fy -= g1;
          fz -= g2;
        }
      }
    }
    const int d = 3 * at;
    // (a product rounded on its own: fused with the subtraction it would
    // leave the rounding's remainder where f0 is meant to cancel exactly)
    const float p0 = __fmul_rn(s.conv[d], fx), p1 = __fmul_rn(s.conv[d + 1], fy),
                p2 = __fmul_rn(s.conv[d + 2], fz);
    tile[lane][3 * warp] = s.f0 ? p0 - s.f0[d] : p0;
    tile[lane][3 * warp + 1] = s.f0 ? p1 - s.f0[d + 1] : p1;
    tile[lane][3 * warp + 2] = s.f0 ? p2 - s.f0[d + 2] : p2;
  }
  __syncthreads();
  const int nph = 3 * s.na, d0 = 3 * a0;
  const int nd = min(3 * SLOT_GATHER_WARPS, nph - d0);
  for (int x = threadIdx.x; x < SLOT_LANES * 3 * SLOT_GATHER_WARPS;
       x += blockDim.x) {
    const int r = x / (3 * SLOT_GATHER_WARPS), c = x % (3 * SLOT_GATHER_WARPS);
    const int tt = tg * SLOT_LANES + r;
    if (tt < s.ntraj && c < nd) s.f[(size_t)tt * nph + d0 + c] = tile[r][c];
  }
}

// u = conv q as (3 na, tp), the pad columns zero; 32 x 32 tiles
static __global__ void __launch_bounds__(256)
slot_transpose_kernel(const SlotArgs s) {
  __shared__ float tile[32][33];
  const int nph = 3 * s.na;
  const int d0 = blockIdx.x * 32, t0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int t = t0 + r, d = d0 + tx;
    tile[r][tx] = (t < s.ntraj && d < nph)
                      ? __fmul_rn(s.conv[d], s.q[(size_t)t * nph + d])
                      : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int d = d0 + r;
    if (d < nph) s.u[(size_t)d * s.tp + t0 + tx] = tile[tx][r];
  }
}

static inline bool slot_args_ok(const SlotArgs& s) {
  return s.ntraj >= 1 && s.ntraj <= 65535 && s.na >= 1 && s.ns >= 0 &&
         s.tp == (s.ntraj + SLOT_LANES - 1) / SLOT_LANES * SLOT_LANES &&
         s.wpb >= 1 && s.wpb <= SLOT_MAX_WARPS && s.width >= 0 &&
         s.q && s.f && s.u && s.g && s.ftail && s.ecen && s.live &&
         s.row_ptr && s.head_ptr && s.conv &&
         (s.ns == 0 || (s.rec && s.head));
}

// the dynamic shared memory of a centre-pass launch, set once per kernel
// above the 48 KB default
static inline int slot_smem_attr(const void* fn, int bytes, int* set) {
  if (bytes > SLOT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (bytes > *set) {
    const int rc = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc) return rc;
    *set = bytes;
  }
  return 0;
}

static inline int slot_transpose_launch(const SlotArgs& s, cudaStream_t st) {
  dim3 grid((3 * s.na + 31) / 32, s.tp / 32);
  slot_transpose_kernel<<<grid, 256, 0, st>>>(s);
  return (int)cudaGetLastError();
}

// the gather launch, after a centre pass on the same stream
static inline int slot_gather_launch(const SlotArgs& s, cudaStream_t st) {
  const int ntile = (s.na + SLOT_GATHER_WARPS - 1) / SLOT_GATHER_WARPS;
  dim3 grid(ntile + (s.e ? 1 : 0), s.tp / SLOT_LANES);
  if (s.scalar)
    slot_gather_kernel<true><<<grid, SLOT_GATHER_WARPS * 32, 0, st>>>(s);
  else
    slot_gather_kernel<false><<<grid, SLOT_GATHER_WARPS * 32, 0, st>>>(s);
  return (int)cudaGetLastError();
}
