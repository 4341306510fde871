// K5: the many-body force of a hydrogen-terminated carbon junction, for a
// batch of trajectories, in one launch per evaluation.
//
// Replaces: the XLA computation that the JAX package gets from jax.grad of
// sclmd_tpu/models/hydrocarbon.py:ch_energy (the Tersoff sum of
// sclmd_tpu/models/tersoff.py:186-223 over the carbon sublattice, the C-H
// Morse bonds and auxiliary springs of models/pair.py, and the out-of-plane
// wag term of hydrocarbon.py:135-149). It never was a Pallas kernel. Here
// the gradient is written out analytically.
//
//   in : q (ntraj, nph) mass-weighted displacements
//   out: f (ntraj, nph) = conv * F(xyz + conv q) - f0, and on request the
//        energy e (ntraj) of each trajectory
//
// Bound: a trajectory reads 603 floats and writes 603; its work is a few
// thousand angular terms, so the launch is bound by neither bytes nor
// operations but by the latency of its dependent phases. Design: one CTA
// per trajectory; the displacements u = conv q go to shared memory once;
// every term of the energy is a function of difference vectors
// x_b - x_a = d0 + (u_b - u_a), with d0 taken from the float64 reference
// geometry on the host (so the float32 rounding of a 50-angstrom coordinate
// never enters a 1.4-angstrom bond). One work item per carbon atom (its
// whole row of the padded neighbour table: zeta_ij and b_ij per (i, j) in a
// first pass over k, the gradients in a second), per bond, per spring and
// per wag term; an item writes the energy's gradient with respect to each of
// its difference vectors into that vector's own slot in shared memory. Then
// one thread per atom adds the slots that touch it, from a list made once
// on the host, in a fixed order: no float atomics, so two calls on the same
// input agree bitwise.
//
// Entries that the plain version masks give exactly zero here: a padded
// table entry is skipped, a pair beyond the cutoff has fc = fc' = 0 and is
// skipped, zeta = 0 (an isolated bond) takes b = 1 and db/dzeta = 0 instead
// of the unbounded derivative of (beta zeta)^n, and a wag term whose plane
// normal vanishes gives no energy and no force.

#include <cuda_runtime.h>

// two CTAs of up to 320 threads to an SM: see kernels/ch_force.py
#define CH_MAX_THREADS 320
#define CH_MAX_NN 16

struct ChArgs {
  const float* q;        // (ntraj, 3 na)
  float* f;              // (ntraj, 3 na)
  float* e;              // (ntraj) or null
  const float* conv;     // (3 na)
  const float* f0;       // (3 na)
  const float* d0;       // (nslots, 3) reference difference vectors
  const int* catom;      // (nc) atom index of each carbon centre
  const int* nbr;        // (nc, nn) atom index of each neighbour, -1 = none
  const int* pair_ab;    // (npair, 2): the first nbond pairs are Morse bonds
  const float* pair_r0;  // (npair) rest lengths of the springs
  const int* oop;        // (noop, 4): H, anchor, adjacent 1, adjacent 2
  const int* csr_ptr;    // (na + 1)
  const int* csr;        // slot << 1 | (1 if the atom is the vector's head)
  int ntraj, na, nc, nn, nbond, npair, noop, nslots, threads, smem_bytes;
  // Tersoff set of the carbon sublattice
  float A, B, lam1, lam2, lam3, beta, n, c2, d2, h, gamma, m, R, D;
  // Morse bond, springs, wag term
  float mD, malpha, mr0, mcut, meshift, kbend, koop, n2min;
};

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

// One carbon centre: its row of the table. g(cos) is taken in the form
// gamma (1 + c^2 (h - cos)^2 / (d^2 (d^2 + (h - cos)^2))), which is the
// published one without its cancellation of two numbers near 7.7e7.
template <int NN>
__device__ __forceinline__ float ch_tersoff_atom(const ChArgs& a, int i,
                                                 const float* su,
                                                 float* slots) {
  const int ai = __ldg(a.catom + i);
  const float uix = su[3 * ai], uiy = su[3 * ai + 1], uiz = su[3 * ai + 2];
  float hx[NN], hy[NN], hz[NN], r[NN], fc[NN], dfc[NN];
  float gx[NN], gy[NN], gz[NN];
  // rows of up to 8 are unrolled, so that the arrays above live in
  // registers; wider rows loop (local memory), which keeps the build short
  constexpr int UNR = NN <= 8 ? NN : 1;
#pragma unroll UNR
  for (int s = 0; s < NN; ++s) {
    gx[s] = gy[s] = gz[s] = 0.f;
    fc[s] = dfc[s] = 0.f;
    r[s] = 1.f;
    hx[s] = hy[s] = hz[s] = 0.f;
    const int b = __ldg(a.nbr + i * NN + s);
    if (b >= 0) {
      const float* d0 = a.d0 + 3 * (i * NN + s);
      float dx = __ldg(d0) + (su[3 * b] - uix);
      float dy = __ldg(d0 + 1) + (su[3 * b + 1] - uiy);
      float dz = __ldg(d0 + 2) + (su[3 * b + 2] - uiz);
      float rr = sqrtf(dx * dx + dy * dy + dz * dz);
      float inv = 1.f / rr;
      r[s] = rr;
      hx[s] = dx * inv;
      hy[s] = dy * inv;
      hz[s] = dz * inv;
      ch_cutoff(rr, a.R, a.D, fc[s], dfc[s]);
    }
  }
  const bool with_l3 = a.lam3 != 0.f;
  const float cd = a.c2 / a.d2;
  float energy = 0.f;
#pragma unroll UNR
  for (int j = 0; j < NN; ++j) {
    if (fc[j] == 0.f) continue;
    float zeta = 0.f;
#pragma unroll UNR
    for (int k = 0; k < NN; ++k) {
      if (k == j || fc[k] == 0.f) continue;
      float cs = hx[j] * hx[k] + hy[j] * hy[k] + hz[j] * hz[k];
      float hc = a.h - cs;
      float g = a.gamma * (1.f + cd * hc * hc / (a.d2 + hc * hc));
      float ex = with_l3 ? expf(powf(a.lam3 * (r[j] - r[k]), a.m)) : 1.f;
      zeta += fc[k] * g * ex;
    }
    float bz = a.beta * zeta;
    float b = 1.f, dbdz = 0.f;
    if (bz > 0.f) {
      float bzn = powf(bz, a.n);
      b = powf(1.f + bzn, -0.5f / a.n);
      dbdz = -0.5f * b * bzn / ((1.f + bzn) * zeta);
    }
    float fR = a.A * expf(-a.lam1 * r[j]);
    float fA = -a.B * expf(-a.lam2 * r[j]);
    energy += 0.5f * fc[j] * (fR + b * fA);
    float rad = 0.5f * (dfc[j] * (fR + b * fA) +
                        fc[j] * (-a.lam1 * fR - a.lam2 * b * fA));
    float jx = rad * hx[j], jy = rad * hy[j], jz = rad * hz[j];
    const float az = 0.5f * fc[j] * fA * dbdz;     // dE/dzeta_ij
    if (az != 0.f) {
      const float invj = 1.f / r[j];
#pragma unroll UNR
      for (int k = 0; k < NN; ++k) {
        if (k == j || (fc[k] == 0.f && dfc[k] == 0.f)) continue;
        float cs = hx[j] * hx[k] + hy[j] * hy[k] + hz[j] * hz[k];
        float hc = a.h - cs;
        float den = a.d2 + hc * hc;
        float g = a.gamma * (1.f + cd * hc * hc / den);
        float dg = -2.f * a.gamma * a.c2 * hc / (den * den);
        float ex = 1.f, dex = 0.f;        // exp term and d/dr_ij of it
        if (with_l3) {
          float y = a.lam3 * (r[j] - r[k]);
          ex = expf(powf(y, a.m));
          dex = ex * a.m * powf(y, a.m - 1.f) * a.lam3;
        }
        float radk = az * (dfc[k] * g * ex - fc[k] * g * dex);
        float ang = az * fc[k] * ex * dg;
        float angk = ang / r[k];
        gx[k] += radk * hx[k] + angk * (hx[j] - cs * hx[k]);
        gy[k] += radk * hy[k] + angk * (hy[j] - cs * hy[k]);
        gz[k] += radk * hz[k] + angk * (hz[j] - cs * hz[k]);
        float radj = az * fc[k] * g * dex;
        float angj = ang * invj;
        jx += radj * hx[j] + angj * (hx[k] - cs * hx[j]);
        jy += radj * hy[j] + angj * (hy[k] - cs * hy[j]);
        jz += radj * hz[j] + angj * (hz[k] - cs * hz[j]);
      }
    }
    gx[j] += jx;
    gy[j] += jy;
    gz[j] += jz;
  }
#pragma unroll UNR
  for (int s = 0; s < NN; ++s) {
    float* o = slots + 3 * (i * NN + s);
    o[0] = gx[s];
    o[1] = gy[s];
    o[2] = gz[s];
  }
  return energy;
}

// difference vector of a slot whose tail is atom ta and head atom hb
__device__ __forceinline__ void ch_diff(const ChArgs& a, const float* su,
                                        int slot, int ta, int hb, float& dx,
                                        float& dy, float& dz) {
  const float* d0 = a.d0 + 3 * slot;
  dx = __ldg(d0) + (su[3 * hb] - su[3 * ta]);
  dy = __ldg(d0 + 1) + (su[3 * hb + 1] - su[3 * ta + 1]);
  dz = __ldg(d0 + 2) + (su[3 * hb + 2] - su[3 * ta + 2]);
}

// a Morse bond (p < nbond) or a harmonic spring
__device__ __forceinline__ float ch_pair(const ChArgs& a, int p,
                                         const float* su, float* slots) {
  const int slot = a.nc * a.nn + p;
  const int ta = __ldg(a.pair_ab + 2 * p), hb = __ldg(a.pair_ab + 2 * p + 1);
  float dx, dy, dz;
  ch_diff(a, su, slot, ta, hb, dx, dy, dz);
  float r = sqrtf(dx * dx + dy * dy + dz * dz);
  float e = 0.f, dedr = 0.f;
  if (p < a.nbond) {
    if (r < a.mcut) {
      float ex = expf(-a.malpha * (r - a.mr0));
      e = a.mD * (ex * ex - 2.f * ex) - a.meshift;
      dedr = 2.f * a.malpha * a.mD * ex * (1.f - ex);
    }
  } else {
    float dr = r - __ldg(a.pair_r0 + p);
    e = 0.5f * a.kbend * dr * dr;
    dedr = a.kbend * dr;
  }
  float s = dedr / r;
  float* o = slots + 3 * slot;
  o[0] = s * dx;
  o[1] = s * dy;
  o[2] = s * dz;
  return e;
}

// an out-of-plane wag term: u = H - anchor, e1, e2 = adjacents - anchor,
// E = k/2 (u . n / |n|)^2 with n = e1 x e2
__device__ __forceinline__ float ch_wag(const ChArgs& a, int o,
                                        const float* su, float* slots) {
  const int slot = a.nc * a.nn + a.npair + 3 * o;
  const int hh = __ldg(a.oop + 4 * o), c0 = __ldg(a.oop + 4 * o + 1);
  const int c1 = __ldg(a.oop + 4 * o + 2), c2 = __ldg(a.oop + 4 * o + 3);
  float ux, uy, uz, ax, ay, az, bx, by, bz;
  ch_diff(a, su, slot, c0, hh, ux, uy, uz);
  ch_diff(a, su, slot + 1, c0, c1, ax, ay, az);
  ch_diff(a, su, slot + 2, c0, c2, bx, by, bz);
  float nx = ay * bz - az * by, ny = az * bx - ax * bz, nz = ax * by - ay * bx;
  float n2 = nx * nx + ny * ny + nz * nz;
  float e = 0.f;
  float g[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (n2 > a.n2min) {
    float inv = rsqrtf(n2);
    float px = nx * inv, py = ny * inv, pz = nz * inv;    // unit normal
    float s = ux * px + uy * py + uz * pz;
    e = 0.5f * a.koop * s * s;
    float ks = a.koop * s;
    g[0] = ks * px;
    g[1] = ks * py;
    g[2] = ks * pz;
    // dE/dn, then through n = e1 x e2
    float wx = ks * (ux - s * px) * inv, wy = ks * (uy - s * py) * inv,
          wz = ks * (uz - s * pz) * inv;
    g[3] = by * wz - bz * wy;     // e2 x w
    g[4] = bz * wx - bx * wz;
    g[5] = bx * wy - by * wx;
    g[6] = wy * az - wz * ay;     // w x e1
    g[7] = wz * ax - wx * az;
    g[8] = wx * ay - wy * ax;
  }
  float* out = slots + 3 * slot;
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = g[i];
  return e;
}

template <int NN>
__global__ void __launch_bounds__(CH_MAX_THREADS, 2)
ch_force_kernel(const ChArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int nph = 3 * a.na;
  float* su = sm;                       // (nph) displacements conv * q
  float* slots = sm + ((nph + 3) & ~3); // (nslots, 3) gradients
  float* red = slots + 3 * a.nslots;    // one partial energy per warp
  const int t = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const float* q = a.q + (size_t)t * nph;
  for (int i = tid; i < nph; i += nt) su[i] = __ldg(a.conv + i) * q[i];
  __syncthreads();

  float energy = 0.f;
  const int nitems = a.nc + a.npair + a.noop;
  for (int it = tid; it < nitems; it += nt) {
    if (it < a.nc)
      energy += ch_tersoff_atom<NN>(a, it, su, slots);
    else if (it < a.nc + a.npair)
      energy += ch_pair(a, it - a.nc, su, slots);
    else
      energy += ch_wag(a, it - a.nc - a.npair, su, slots);
  }
  __syncthreads();

  float* f = a.f + (size_t)t * nph;
  for (int at = tid; at < a.na; at += nt) {
    float fx = 0.f, fy = 0.f, fz = 0.f;
    const int e0 = __ldg(a.csr_ptr + at), e1 = __ldg(a.csr_ptr + at + 1);
    for (int k = e0; k < e1; ++k) {
      const int ent = __ldg(a.csr + k);
      const float* g = slots + 3 * (ent >> 1);
      // the tail of a difference vector is pushed along the gradient,
      // its head against it
      const float sg = (ent & 1) ? -1.f : 1.f;
      fx += sg * g[0];
      fy += sg * g[1];
      fz += sg * g[2];
    }
    const int d = 3 * at;
    // (a product rounded on its own: fused with the subtraction it would
    // leave the rounding's remainder where f0 is meant to cancel exactly)
    f[d] = __fmul_rn(__ldg(a.conv + d), fx) - __ldg(a.f0 + d);
    f[d + 1] = __fmul_rn(__ldg(a.conv + d + 1), fy) - __ldg(a.f0 + d + 1);
    f[d + 2] = __fmul_rn(__ldg(a.conv + d + 2), fz) - __ldg(a.f0 + d + 2);
  }

  if (a.e != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      energy += __shfl_down_sync(0xffffffffu, energy, off);
    if ((tid & 31) == 0) red[tid >> 5] = energy;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < (nt + 31) / 32; ++w) s += red[w];
      a.e[t] = s;
    }
  }
}

template <int NN>
static int ch_launch(const ChArgs& a, cudaStream_t st) {
  if (a.smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ch_force_kernel<NN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        a.smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ch_force_kernel<NN><<<a.ntraj, a.threads, a.smem_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ch_force_f32(const ChArgs* args, void* stream) {
  const ChArgs& a = *args;
  if (a.ntraj < 1 || a.na < 1 || a.nc < 0 || a.threads < 32 ||
      a.threads > CH_MAX_THREADS || a.threads % 32 ||
      a.nslots != a.nc * a.nn + a.npair + 3 * a.noop)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.nn) {
    case 4: return ch_launch<4>(a, st);
    case 8: return ch_launch<8>(a, st);
    case 12: return ch_launch<12>(a, st);
    case 16: return ch_launch<16>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ch_force_max_threads(void) { return CH_MAX_THREADS; }
extern "C" int ch_force_max_nn(void) { return CH_MAX_NN; }
