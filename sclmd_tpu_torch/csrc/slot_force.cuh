// The common half of K9 (sw_force.cu) and K10 (eam_force.cu): the slot
// table of a per-centre many-body force, its difference vectors, and the
// gather that turns the slots' gradients into forces.
//
// A *slot* is one live entry (i, j) of the padded neighbour table, listed
// row by row (a compacted CSR by centre i). Every term of the energy is a
// function of the slots' difference vectors
//   d = x_j - x_i = d0 + (u_j - u_i),   u = conv q,
// with d0 taken on the host from the float64 reference geometry (minimum
// image in a cell), so the float32 rounding of a 65-angstrom coordinate
// never enters a 2.35-angstrom bond. In a periodic cell d then takes the
// minimum image on each periodic axis, d -= L rint(d / L) (rint is half
// to even, as the reference's jnp.round).
//
// The centre pass (one thread per trajectory and centre, in each
// kernel's own file) writes dE/dd of every slot of its row; each slot is
// written by exactly one thread, once. The energy sums only the centre's
// own row, so the force is the gradient of that sum even where the table
// is not symmetric (a truncated table: j in row i without i in row j).
// The gather pass (one thread per trajectory and atom) then adds the
// slots that touch the atom, in a fixed order from a list made once on
// the host: the tail of a slot (its centre) is pushed along the gradient,
// its head against it. No float atomics, so two calls on the same input
// agree bitwise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SLOT_CENTRE_THREADS 128
#define SLOT_GATHER_THREADS 256

struct SlotArgs {
  const float* q;       // (ntraj, 3 na) mass-weighted displacements
  float* f;             // (ntraj, 3 na) out: conv * F - f0
  float* e;             // (ntraj) out: energy, or null
  float* g;             // (ntraj, ns, 3) scratch: the slots' gradients
  float* ecen;          // (ntraj, na) scratch: each centre's energy
  const int* row_ptr;   // (na + 1) slots of centre i: [row_ptr[i], row_ptr[i+1])
  const int* slot_j;    // (ns) the neighbour (head) of each slot
  const float* d0;      // (ns, 3) reference difference vectors
  const int* csr_ptr;   // (na + 1) each atom's list in csr
  const int* csr;       // slot << 1 | 1 where the atom is the slot's head
  const float* conv;    // (3 na)
  const float* f0;      // (3 na) the kernel's own force at rest, or null
  int ntraj, na, ns;
  float cx, cy, cz;     // periodic lengths, 0 on an open axis
};

__device__ __forceinline__ float3 slot_disp(const SlotArgs& s, const float* q,
                                            int atom) {
  const int d = 3 * atom;
  return make_float3(s.conv[d] * q[d], s.conv[d + 1] * q[d + 1],
                     s.conv[d + 2] * q[d + 2]);
}

// the difference vector of slot k whose centre moved by ui
__device__ __forceinline__ float3 slot_vec(const SlotArgs& s, const float* q,
                                           int k, float3 ui) {
  const float3 uj = slot_disp(s, q, s.slot_j[k]);
  float dx = s.d0[3 * k] + (uj.x - ui.x);
  float dy = s.d0[3 * k + 1] + (uj.y - ui.y);
  float dz = s.d0[3 * k + 2] + (uj.z - ui.z);
  if (s.cx > 0.f) dx -= s.cx * rintf(dx / s.cx);
  if (s.cy > 0.f) dy -= s.cy * rintf(dy / s.cy);
  if (s.cz > 0.f) dz -= s.cz * rintf(dz / s.cz);
  return make_float3(dx, dy, dz);
}

// x^n for a small non-negative integer n, by multiplies
__device__ __forceinline__ float powi(float x, int n) {
  float acc = 1.f;
  while (n) {
    if (n & 1) acc *= x;
    n >>= 1;
    if (n) x *= x;
  }
  return acc;
}

// x^e for x > 0: by multiplies where the power is a small non-negative
// integer (ni, its value), by powf where it is not (ni = -1)
__device__ __forceinline__ float power(float x, int ni, float e) {
  return ni >= 0 ? powi(x, ni) : powf(x, e);
}

// blockIdx.x < atom blocks: the forces of SLOT_GATHER_THREADS atoms of
// trajectory blockIdx.y; the block after them (when the energy is asked
// for): the trajectory's energy, the centres' energies summed in a fixed
// order (static: each file that includes this header has its own copy)
static __global__ void __launch_bounds__(SLOT_GATHER_THREADS)
slot_gather_kernel(const SlotArgs s) {
  const int t = blockIdx.y;
  const int nblk = (s.na + SLOT_GATHER_THREADS - 1) / SLOT_GATHER_THREADS;
  if ((int)blockIdx.x == nblk) {
    __shared__ float red[SLOT_GATHER_THREADS / 32];
    const float* ec = s.ecen + (size_t)t * s.na;
    float acc = 0.f;
    for (int i = threadIdx.x; i < s.na; i += SLOT_GATHER_THREADS)
      acc += ec[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.f;
      for (int w = 0; w < SLOT_GATHER_THREADS / 32; ++w) tot += red[w];
      s.e[t] = tot;
    }
    return;
  }
  const int at = blockIdx.x * SLOT_GATHER_THREADS + threadIdx.x;
  if (at >= s.na) return;
  const float* g = s.g + (size_t)t * s.ns * 3;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int k = s.csr_ptr[at]; k < s.csr_ptr[at + 1]; ++k) {
    const int ent = s.csr[k];
    const float* gs = g + 3 * (size_t)(ent >> 1);
    const float sg = (ent & 1) ? -1.f : 1.f;
    fx += sg * gs[0];
    fy += sg * gs[1];
    fz += sg * gs[2];
  }
  const int d = 3 * at;
  float* f = s.f + (size_t)t * 3 * s.na;
  // (a product rounded on its own: fused with the subtraction it would
  // leave the rounding's remainder where f0 is meant to cancel exactly)
  const float a0 = __fmul_rn(s.conv[d], fx), a1 = __fmul_rn(s.conv[d + 1], fy),
              a2 = __fmul_rn(s.conv[d + 2], fz);
  f[d] = s.f0 ? a0 - s.f0[d] : a0;
  f[d + 1] = s.f0 ? a1 - s.f0[d + 1] : a1;
  f[d + 2] = s.f0 ? a2 - s.f0[d + 2] : a2;
}

static inline bool slot_args_ok(const SlotArgs& s) {
  return s.ntraj >= 1 && s.ntraj <= 65535 && s.na >= 1 && s.ns >= 0 &&
         s.q && s.f && s.g && s.ecen && s.row_ptr && s.csr_ptr && s.conv &&
         (s.ns == 0 || (s.slot_j && s.d0 && s.csr));
}

// the gather launch, after a centre pass on the same stream
static inline int slot_gather_launch(const SlotArgs& s, cudaStream_t st) {
  const int nblk = (s.na + SLOT_GATHER_THREADS - 1) / SLOT_GATHER_THREADS;
  dim3 grid(nblk + (s.e ? 1 : 0), s.ntraj);
  slot_gather_kernel<<<grid, SLOT_GATHER_THREADS, 0, st>>>(s);
  return (int)cudaGetLastError();
}
