// K5 (C/H) and K8 (Tersoff): the many-body force of a carbon system, with
// or without hydrogen terminators, for a batch of trajectories, in one
// launch per evaluation (float32, sm_90a).
//
// Replaces: the XLA computation that the JAX package gets from jax.grad of
// sclmd_tpu/models/hydrocarbon.py:ch_energy (the Tersoff sum of
// sclmd_tpu/models/tersoff.py:186-223 over the carbon sublattice, the C-H
// Morse bonds and auxiliary springs of models/pair.py, and the out-of-plane
// wag term of hydrocarbon.py:135-149), and for a single-element Tersoff
// system jax.grad of tersoff.py:160 tersoff_energy. Neither was a Pallas
// kernel. Here the gradient is written out analytically.
//
//   in : q (ntraj, nph) mass-weighted displacements
//   out: f (ntraj, nph) = conv * F(xyz + conv q) - f0, and on request the
//        energy e (ntraj) of each trajectory
//
// Every term of the energy is a function of difference vectors
// x_b - x_a = d0 + (u_b - u_a), u = conv q, with d0 taken on the host from
// the float64 reference geometry (minimum image where a cell is given), so
// the float32 rounding of a 50-angstrom coordinate never enters a
// 1.4-angstrom bond. In a periodic cell d then takes the minimum image on
// each periodic axis, d -= L rint(d / L), as the reference's jnp.round does.
// Each difference vector is a *slot*: one per live entry of the Tersoff
// table (a compacted CSR by centre, tail the centre, head the neighbour),
// one per Morse bond and spring, three per wag term.
//
// What bounds it: neither bytes (a trajectory reads and writes 2.4 KB) nor
// the operations the geometry needs (about 1.5e5 a trajectory on the
// flagship, 0.3 us at 128 trajectories) but each trajectory's chain of
// dependent phases (sqrt, sincos, exp, pow, two divisions a pair) and the
// SM's issue slots for the instructions around it. Measured on an H100 by
// the phase stamps (tools/plain_bench.py --workload flagship_mb): at 128
// trajectories, one group of 800 threads to an SM, about 13k cycles, of
// which the bond order (B) and the gradient (C) take 4-4.5k each and the
// geometry (A) and the gather (D) 2k each; at 1024, four groups of 256 to
// an SM in two rounds, the SM issues for all four groups at once and B and
// C take 9k cycles each. The design:
//  * work by table entry, not by row: one thread per live entry in each of
//    three phases, split by barriers (in phases B and C the threads take
//    the entries in the pack's order: those inside the cutoff at the
//    reference geometry first, by row length, so that a warp's entries
//    do the same work),
//      (A) geometry: r and the unit vector to shared memory (fc and fc' are
//          recomputed from r where needed: cheap away from the switching
//          zone); threads left over take the bonds, springs and wag terms
//          and write their slots' gradients,
//      (B) bond order: zeta_ij over the row, b_ij, the pair energy,
//          a_ij = dE/dzeta_ij and the radial coefficient,
//      (C) gradient: a slot's gradient is its radial term, plus its terms
//          as j summed over k (weighted by its own a_ij), plus its terms as
//          k summed over j (weighted by a_ij of each j), in row order;
//    so a thread's serial work is about two passes over one row, not
//    2 nn^2 angular terms, no per-thread row arrays live in registers (no
//    spills), and the row width is a loop bound, not a compile-time limit;
//  * then one thread per atom adds the slots that touch it, from a list
//    made once on the host, in a fixed order: no float atomics, so two
//    calls on the same input agree bitwise;
//  * the constants (slot vectors d0, the table and its order, the pair and
//    wag lists, the atoms' slot lists, conv and f0: one packed block) are
//    staged into shared memory once per CTA by 16-byte cp.async, and a CTA
//    holds several trajectory groups of TT threads each (TPC of them, one
//    CTA per SM, persistent over the trajectories), so at 1024
//    trajectories the block is read ~132 times a launch, not 1024. Each
//    group synchronises on its own named barrier and never waits for
//    another group;
//  * a group's working region (u, the entries' geometry, the slots'
//    gradients) takes about 4 (max(3 na, 2 ne) + 4 ne + 3 nslots) bytes,
//    and the constant block about 4 (3 ne + 5 nslots + 7 na) bytes. Where
//    the block and one region do not fit in an SM's shared memory (by
//    launch_plan's sizes, above ~450 atoms of a C/H ribbon or ~350
//    carbons of a sheet), the same kernel reads the constants from global
//    memory (L2), and where one region does not fit alone (above ~900 C/H
//    atoms or ~700 carbons) it keeps the regions there too, one per group
//    in a buffer of the wrapper's. The template arguments CSM and WSM say
//    which lives in shared memory (the constants only beside the
//    regions); every placement gives the same bits (the same arithmetic
//    in the same order).
//
// Entries that the plain version masks give exactly zero here: a pair
// beyond the cutoff has fc = fc' = 0 and is skipped, zeta = 0 (an isolated
// bond) takes b = 1 and db/dzeta = 0 instead of the unbounded derivative of
// (beta zeta)^n, and a wag term whose plane normal vanishes gives no energy
// and no force. g(cos) is taken as gamma (1 + c^2 (h - cos)^2 / (d^2 (d^2 +
// (h - cos)^2))), the published form without its cancellation of two
// numbers near 7.7e7.

#include <cuda_runtime.h>
#include <stdint.h>

#define CH_MAX_THREADS 1024   // TT * TPC: one CTA to an SM, 64 registers
#define CH_MAX_GROUPS 15      // named barriers 1..15, one per group
#define CH_MAX_DEVICES 64
// phase stamps of a group's first trajectory when traced: entry, constants
// staged, after (A), (B), (C), and after the gather (D)
#define CH_TRACE 6

struct ChArgs {
  const float* q;        // (ntraj, 3 na)
  float* f;              // (ntraj, 3 na)
  float* e;              // (ntraj) or null
  const float* conv;     // (3 na)
  const void* cblock;    // packed constants, cwords 4-byte words
  long long* trace;      // null, or (grid * tpc, CH_TRACE) clock64 stamps
  float* work;           // !wsm: (grid * tpc, traj_words) working regions
  // word offsets inside the constant block
  int o_ent_ab, o_ent_row, o_row_ptr, o_order, o_d0, o_pair_ab, o_pair_r0,
      o_oop, o_csr_ptr, o_csr, o_conv, o_f0;
  // float offsets inside a group's region: geometry, slots, partial sums
  int g_off, s_off, red_off, traj_words;
  int cwords, ntraj, na, nc, ne, nbond, npair, noop, nslots;
  int tt, tpc, grid, smem_bytes;   // grid: CTAs, persistent over trajectories
  int csm, wsm;          // constants, working regions in shared memory
  float cx, cy, cz;      // orthorhombic cell; 0 = open along that axis
  // Tersoff set
  float A, B, lam1, lam2, lam3, beta, n, c2, d2, h, gamma, m, R, D;
  // Morse bond, springs, wag term
  float mD, malpha, mr0, mcut, meshift, kbend, koop, n2min;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// the barrier of one group of tt threads
__device__ __forceinline__ void group_sync(int g, int tt) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(tt) : "memory");
}

// cutoff function and its derivative
__device__ __forceinline__ void ch_cutoff(float r, float R, float D,
                                          float& fc, float& dfc) {
  if (r < R - D) {
    fc = 1.f;
    dfc = 0.f;
  } else if (r > R + D) {
    fc = 0.f;
    dfc = 0.f;
  } else {
    float w = 1.57079632679489662f / D;
    float sn, cs;
    sincosf(w * (r - R), &sn, &cs);
    fc = 0.5f - 0.5f * sn;
    dfc = -0.5f * w * cs;
  }
}

// minimum image along one axis of length L (0: open)
__device__ __forceinline__ float ch_mic(float d, float L) {
  return L > 0.f ? d - L * rintf(d / L) : d;
}

// difference vector of a slot whose tail is atom ta and head atom hb
__device__ __forceinline__ float3 ch_diff(const ChArgs& a, const float* D0,
                                          const float* su, int slot, int ta,
                                          int hb) {
  float3 d;
  d.x = ch_mic(D0[3 * slot] + (su[3 * hb] - su[3 * ta]), a.cx);
  d.y = ch_mic(D0[3 * slot + 1] + (su[3 * hb + 1] - su[3 * ta + 1]), a.cy);
  d.z = ch_mic(D0[3 * slot + 2] + (su[3 * hb + 2] - su[3 * ta + 2]), a.cz);
  return d;
}

// the lam3 exponential exp((lam3 y)^m) and its derivative by y
__device__ __forceinline__ void ch_expo(const ChArgs& a, float y, float& ex,
                                        float& dex) {
  float z = a.lam3 * y;
  ex = expf(powf(z, a.m));
  dex = ex * a.m * powf(z, a.m - 1.f) * a.lam3;
}

// a Morse bond (p < nbond) or a harmonic spring: energy, slot gradient
__device__ __forceinline__ float ch_pair(const ChArgs& a, const int* cw,
                                         const float* D0, int p,
                                         const float* su, float* S) {
  const int slot = a.ne + p;
  const uint32_t ab = (uint32_t)cw[a.o_pair_ab + p];
  const float3 d = ch_diff(a, D0, su, slot, ab & 0xffffu, ab >> 16);
  float r = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
  float e = 0.f, dedr = 0.f;
  if (p < a.nbond) {
    if (r < a.mcut) {
      float ex = expf(-a.malpha * (r - a.mr0));
      e = a.mD * (ex * ex - 2.f * ex) - a.meshift;
      dedr = 2.f * a.malpha * a.mD * ex * (1.f - ex);
    }
  } else {
    float dr = r - __int_as_float(cw[a.o_pair_r0 + p]);
    e = 0.5f * a.kbend * dr * dr;
    dedr = a.kbend * dr;
  }
  float s = dedr / r;
  float* o = S + 3 * slot;
  o[0] = s * d.x;
  o[1] = s * d.y;
  o[2] = s * d.z;
  return e;
}

// an out-of-plane wag term: u = H - anchor, e1, e2 = adjacents - anchor,
// E = k/2 (u . n / |n|)^2 with n = e1 x e2
__device__ __forceinline__ float ch_wag(const ChArgs& a, const int* cw,
                                        const float* D0, int o,
                                        const float* su, float* S) {
  const int slot = a.ne + a.npair + 3 * o;
  const uint32_t w0 = (uint32_t)cw[a.o_oop + 2 * o];
  const uint32_t w1 = (uint32_t)cw[a.o_oop + 2 * o + 1];
  const int hh = w0 & 0xffffu, c0 = w0 >> 16, c1 = w1 & 0xffffu,
            c2 = w1 >> 16;
  const float3 u = ch_diff(a, D0, su, slot, c0, hh);
  const float3 e1 = ch_diff(a, D0, su, slot + 1, c0, c1);
  const float3 e2 = ch_diff(a, D0, su, slot + 2, c0, c2);
  float nx = e1.y * e2.z - e1.z * e2.y, ny = e1.z * e2.x - e1.x * e2.z,
        nz = e1.x * e2.y - e1.y * e2.x;
  float n2 = nx * nx + ny * ny + nz * nz;
  float e = 0.f;
  float g[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (n2 > a.n2min) {
    float inv = rsqrtf(n2);
    float px = nx * inv, py = ny * inv, pz = nz * inv;    // unit normal
    float s = u.x * px + u.y * py + u.z * pz;
    e = 0.5f * a.koop * s * s;
    float ks = a.koop * s;
    g[0] = ks * px;
    g[1] = ks * py;
    g[2] = ks * pz;
    // dE/dn, then through n = e1 x e2
    float wx = ks * (u.x - s * px) * inv, wy = ks * (u.y - s * py) * inv,
          wz = ks * (u.z - s * pz) * inv;
    g[3] = e2.y * wz - e2.z * wy;     // e2 x w
    g[4] = e2.z * wx - e2.x * wz;
    g[5] = e2.x * wy - e2.y * wx;
    g[6] = wy * e1.z - wz * e1.y;     // w x e1
    g[7] = wz * e1.x - wx * e1.z;
    g[8] = wx * e1.y - wy * e1.x;
  }
  float* out = S + 3 * slot;
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = g[i];
  return e;
}

// q -> u = conv q for one trajectory, into the group's region
__device__ __forceinline__ void ch_load_u(const ChArgs& a, int t, int lt,
                                          float* U) {
  const int nph = 3 * a.na;
  const float* q = a.q + (size_t)t * nph;
  for (int i = lt; i < nph; i += a.tt) U[i] = __ldg(a.conv + i) * q[i];
}

template <bool CSM, bool WSM>
__global__ void __launch_bounds__(CH_MAX_THREADS, 1)
ch_force_kernel(const ChArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int g = tid / a.tt, lt = tid - g * a.tt;
  long long* trace =
      (a.trace != nullptr && lt == 0)
          ? a.trace + (size_t)(blockIdx.x * a.tpc + g) * CH_TRACE
          : nullptr;
  if (trace) trace[0] = clock64();
  const int* cw = CSM ? reinterpret_cast<const int*>(sm)
                      : reinterpret_cast<const int*>(a.cblock);
  const float* D0 = reinterpret_cast<const float*>(cw) + a.o_d0;
  float* U = WSM ? sm + (CSM ? a.cwords : 0) + g * a.traj_words
                 : a.work + (size_t)(blockIdx.x * a.tpc + g) * a.traj_words;
  // U: u, then a_ij and the radial coefficients
  float4* G = reinterpret_cast<float4*>(U + a.g_off);   // unit vector, r
  float* S = U + a.s_off;                        // slot gradients
  float* red = U + a.red_off;                    // one partial per warp
  float* AZ = U;
  float* RAD = U + a.ne;

  // the constant block: 16-byte copies that need no registers, in flight
  // while the group loads its first trajectory's displacements
  if (CSM) {
    const int4* src = reinterpret_cast<const int4*>(a.cblock);
    int4* dst = reinterpret_cast<int4*>(sm);
    for (int i = tid; i < a.cwords / 4; i += nt) cp_async16(dst + i, src + i);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  const int stride = gridDim.x * a.tpc;
  int t = blockIdx.x * a.tpc + g;
  if (t < a.ntraj) ch_load_u(a, t, lt, U);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (trace) trace[1] = clock64();

  const bool with_l3 = a.lam3 != 0.f;
  const float cd = a.c2 / a.d2;
  const int nph = 3 * a.na;
  const int* ent_row = cw + a.o_ent_row;
  const int* row_ptr = cw + a.o_row_ptr;
  const int* order = cw + a.o_order;
  const float* conv = reinterpret_cast<const float*>(cw) + a.o_conv;
  const float* f0 = reinterpret_cast<const float*>(cw) + a.o_f0;
  for (bool first = true; t < a.ntraj; t += stride, first = false) {
    if (!first) {
      ch_load_u(a, t, lt, U);
      group_sync(g, a.tt);
    }
    float energy = 0.f;

    // (A) geometry of the table's entries; bonds, springs, wag terms
    const int nitems = a.ne + a.npair + a.noop;
    for (int it = lt; it < nitems; it += a.tt) {
      if (it < a.ne) {
        const uint32_t ab = (uint32_t)cw[a.o_ent_ab + it];
        const float3 d = ch_diff(a, D0, U, it, ab & 0xffffu, ab >> 16);
        const float r = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
        const float inv = 1.f / r;
        G[it] = make_float4(d.x * inv, d.y * inv, d.z * inv, r);
      } else if (it < a.ne + a.npair) {
        energy += ch_pair(a, cw, D0, it - a.ne, U, S);
      } else {
        energy += ch_wag(a, cw, D0, it - a.ne - a.npair, U, S);
      }
    }
    group_sync(g, a.tt);
    if (first && trace) trace[2] = clock64();

    // (B) bond order of each entry (i, j): u is no longer read, so a_ij and
    // the radial coefficient take its place
    for (int i = lt; i < a.ne; i += a.tt) {
      const int e = order[i];
      const float4 hj = G[e];
      float fcj, dfcj;
      ch_cutoff(hj.w, a.R, a.D, fcj, dfcj);
      float az = 0.f, rad = 0.f;
      if (fcj != 0.f) {
        const int row = ent_row[e];
        const int k1 = row_ptr[row + 1];
        float zeta = 0.f;
        for (int k = row_ptr[row]; k < k1; ++k) {
          if (k == e) continue;
          const float4 hk = G[k];
          float fck, dfck;
          ch_cutoff(hk.w, a.R, a.D, fck, dfck);
          if (fck == 0.f) continue;
          float cs = hj.x * hk.x + hj.y * hk.y + hj.z * hk.z;
          float hc = a.h - cs;
          float gg = a.gamma * (1.f + cd * hc * hc / (a.d2 + hc * hc));
          float ex = with_l3 ? expf(powf(a.lam3 * (hj.w - hk.w), a.m)) : 1.f;
          zeta += fck * gg * ex;
        }
        float bz = a.beta * zeta;
        float b = 1.f, dbdz = 0.f;
        if (bz > 0.f) {
          float bzn = powf(bz, a.n);
          b = powf(1.f + bzn, -0.5f / a.n);
          dbdz = -0.5f * b * bzn / ((1.f + bzn) * zeta);
        }
        float fR = a.A * expf(-a.lam1 * hj.w);
        float fA = -a.B * expf(-a.lam2 * hj.w);
        energy += 0.5f * fcj * (fR + b * fA);
        rad = 0.5f * (dfcj * (fR + b * fA) +
                      fcj * (-a.lam1 * fR - a.lam2 * b * fA));
        az = 0.5f * fcj * fA * dbdz;     // dE/dzeta_ij
      }
      AZ[e] = az;
      RAD[e] = rad;
    }
    group_sync(g, a.tt);
    if (first && trace) trace[3] = clock64();

    // (C) gradient of each entry's slot s, against each other entry t of
    // its row: s as j with t as k (weight a_is), s as k with t as j (a_it)
    for (int i = lt; i < a.ne; i += a.tt) {
      const int s = order[i];
      const float4 hs = G[s];
      float fcs, dfcs;
      ch_cutoff(hs.w, a.R, a.D, fcs, dfcs);
      const float as = AZ[s];
      const float rs = RAD[s];
      float gx = rs * hs.x, gy = rs * hs.y, gz = rs * hs.z;
      const bool as_k = fcs != 0.f || dfcs != 0.f;
      if (as != 0.f || as_k) {
        const float invs = 1.f / hs.w;
        const int row = ent_row[s];
        const int k1 = row_ptr[row + 1];
        for (int k = row_ptr[row]; k < k1; ++k) {
          if (k == s) continue;
          const float4 ht = G[k];
          float fct, dfct;
          ch_cutoff(ht.w, a.R, a.D, fct, dfct);
          const float at = AZ[k];
          const bool jrole = as != 0.f && fct != 0.f;
          const bool krole = at != 0.f && as_k;
          if (!jrole && !krole) continue;
          float cs = hs.x * ht.x + hs.y * ht.y + hs.z * ht.z;
          float hc = a.h - cs;
          float iden = 1.f / (a.d2 + hc * hc);
          float gg = a.gamma * (1.f + cd * hc * hc * iden);
          float dg = -2.f * a.gamma * a.c2 * hc * iden * iden;
          // r_s d(cos)/d(d_s)
          float px = ht.x - cs * hs.x, py = ht.y - cs * hs.y,
                pz = ht.z - cs * hs.z;
          if (jrole) {
            float ex = 1.f, dex = 0.f;
            if (with_l3) ch_expo(a, hs.w - ht.w, ex, dex);
            float radj = as * fct * gg * dex;
            float angj = as * fct * ex * dg * invs;
            gx += radj * hs.x + angj * px;
            gy += radj * hs.y + angj * py;
            gz += radj * hs.z + angj * pz;
          }
          if (krole) {
            float ex = 1.f, dex = 0.f;
            if (with_l3) ch_expo(a, ht.w - hs.w, ex, dex);
            float radk = at * (dfcs * gg * ex - fcs * gg * dex);
            float angk = at * fcs * ex * dg * invs;
            gx += radk * hs.x + angk * px;
            gy += radk * hs.y + angk * py;
            gz += radk * hs.z + angk * pz;
          }
        }
      }
      float* o = S + 3 * s;
      o[0] = gx;
      o[1] = gy;
      o[2] = gz;
    }
    group_sync(g, a.tt);
    if (first && trace) trace[4] = clock64();

    // (D) forces: per atom, the slots that touch it, in slot order
    float* f = a.f + (size_t)t * nph;
    const int* csr_ptr = cw + a.o_csr_ptr;
    const int* csr = cw + a.o_csr;
    for (int at = lt; at < a.na; at += a.tt) {
      float fx = 0.f, fy = 0.f, fz = 0.f;
      const int e1 = csr_ptr[at + 1];
      for (int k = csr_ptr[at]; k < e1; ++k) {
        const int ent = csr[k];
        const float* gs = S + 3 * (ent >> 1);
        // the tail of a difference vector is pushed along the gradient,
        // its head against it
        const float sg = (ent & 1) ? -1.f : 1.f;
        fx += sg * gs[0];
        fy += sg * gs[1];
        fz += sg * gs[2];
      }
      const int d = 3 * at;
      // (a product rounded on its own: fused with the subtraction it would
      // leave the rounding's remainder where f0 is meant to cancel exactly)
      f[d] = __fmul_rn(conv[d], fx) - f0[d];
      f[d + 1] = __fmul_rn(conv[d + 1], fy) - f0[d + 1];
      f[d + 2] = __fmul_rn(conv[d + 2], fz) - f0[d + 2];
    }

    if (a.e != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        energy += __shfl_down_sync(0xffffffffu, energy, off);
      if ((lt & 31) == 0) red[lt >> 5] = energy;
      group_sync(g, a.tt);
      if (lt == 0) {
        float s = 0.f;
        for (int w = 0; w < a.tt / 32; ++w) s += red[w];
        a.e[t] = s;
      }
    }
    // the next trajectory overwrites u and the pair and wag slots
    group_sync(g, a.tt);
    if (first && trace) trace[5] = clock64();
  }
}

// one instantiation per placement: the opt-in above 48 KB of shared memory
// once per device and size (a host call per launch otherwise), then the
// launch
template <bool CSM, bool WSM>
static int ch_launch(const ChArgs& a, cudaStream_t st) {
  static int smem_set[CH_MAX_DEVICES] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= CH_MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  if (a.smem_bytes > 48 * 1024 && a.smem_bytes > smem_set[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        ch_force_kernel<CSM, WSM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = a.smem_bytes;
  }
  ch_force_kernel<CSM, WSM><<<a.grid, a.tt * a.tpc, a.smem_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ch_force_f32(const ChArgs* args, void* stream) {
  const ChArgs& a = *args;
  if (a.ntraj < 1 || a.na < 1 || a.na > 65535 || a.ne < 0 || a.tt < 32 ||
      a.tt % 32 || a.tpc < 1 || a.tpc > CH_MAX_GROUPS ||
      a.tt * a.tpc > CH_MAX_THREADS || a.grid < 1 || a.cwords % 4 ||
      a.nslots != a.ne + a.npair + 3 * a.noop || a.g_off % 4 ||
      a.traj_words % 4 || (reinterpret_cast<uintptr_t>(a.cblock) & 15) ||
      (a.csm && !a.wsm) ||
      (!a.wsm && (a.work == nullptr ||
                  (reinterpret_cast<uintptr_t>(a.work) & 15))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.csm) return ch_launch<true, true>(a, st);
  return a.wsm ? ch_launch<false, true>(a, st) : ch_launch<false, false>(a, st);
}

extern "C" int ch_force_max_threads(void) { return CH_MAX_THREADS; }
extern "C" int ch_force_max_groups(void) { return CH_MAX_GROUPS; }
extern "C" int ch_force_trace_len(void) { return CH_TRACE; }
