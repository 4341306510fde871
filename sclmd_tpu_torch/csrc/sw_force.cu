// K9 — sw_force: the Stillinger-Weber force of a single-element system for
// a batch of trajectories (float32, sm_90a).
//
// Replaces: the XLA computation that the JAX package gets from jax.grad of
// sclmd_tpu/models/sw.py:63 sw_energy (never a Pallas kernel). Here the
// gradient is written out analytically:
//
//   E   = sum_i E_i,  over each centre's own row of the padded table
//   E_i = 1/2 sum_j phi2(r_ij) + 1/2 sum_{j != k} phi3(j, k)
//   phi2 = A eps (B s^p - s^q) exp(sig / (r - a sig)),  s = sig / r
//   phi3 = lam eps (cos_jk - cos0)^2 h_j h_k,  h = exp(gam sig / (r - a sig))
//
// both zero from r >= a sig on (the reference's _tail). For a slot j of
// centre i, with d_j = x_j - x_i and r_j, rhat_j its length and direction:
//   dE_i/dd_j = 1/2 phi2'(r_j) rhat_j
//     + sum_{k != j} lam eps [2 (c - cos0) h_j h_k (rhat_k - c rhat_j) / r_j
//                             + (c - cos0)^2 h_k h'_j rhat_j],
//   h' = -h gam sig / (r - a sig)^2,   c = rhat_j . rhat_k.
// The exponential is taken only inside the cutoff (the test comes first),
// and h' only where h > 0: near the cutoff h underflows to 0 while
// 1 / (r - a sig)^2 grows without bound, and 0 * inf would be NaN.
//
//   in : q (ntraj, nph) mass-weighted displacements
//   out: f (ntraj, nph) = conv * F(xyz + conv q) - f0, and on request the
//        energy e (ntraj) of each trajectory
//
// Two launches an evaluation (slot_force.cuh): the centre pass, one
// thread per (trajectory, centre), writes every slot gradient of its row;
// the gather adds them onto the atoms. A thread walks its row once, and
// for each entry inside the cutoff (4 of the slab's 16 at rest) walks the
// row again for its partners, recomputing their geometry from q (a few
// loads from L1) rather than keeping per-entry arrays in registers: the
// row width is a loop bound, never a compile-time limit, and nothing
// spills.
//
// What bounds it on the H100: neither bytes (q read and f written once,
// 83 KB a trajectory on the 3,456-atom slab, with 1.4 MB of table) nor
// the operations the geometry needs (4.0e6 a trajectory by work_counts:
// 3.8 us at 64 trajectories at the float32 peak), but the latency of
// each thread's dependent chain (sqrt, division and exponentials per
// entry, over a row of 16, again for each entry inside the cutoff) and
// the loads of its neighbours' q through L1 and L2. A simple design
// first: table and working memory in global memory, no staging.

#include "slot_force.cuh"

struct SwArgs {
  SlotArgs s;
  float A, B, eps, sig, rc, lam, gam, cos0;
  int p, q;      // the powers as integers 0-16, or -1: powf of pf, qf
  float pf, qf;
};

__global__ void __launch_bounds__(SLOT_CENTRE_THREADS)
sw_centre_kernel(const SwArgs a) {
  const SlotArgs& s = a.s;
  const int i = blockIdx.x * SLOT_CENTRE_THREADS + threadIdx.x;
  const int t = blockIdx.y;
  if (i >= s.na) return;
  const float* q = s.q + (size_t)t * 3 * s.na;
  float* g = s.g + (size_t)t * s.ns * 3;
  const float3 ui = slot_disp(s, q, i);
  const int k0 = s.row_ptr[i], k1 = s.row_ptr[i + 1];
  const float c2 = a.A * a.eps, c3 = a.lam * a.eps, gs = a.gam * a.sig;
  float e = 0.f;
  for (int kj = k0; kj < k1; ++kj) {
    const float3 dj = slot_vec(s, q, kj, ui);
    const float rj = sqrtf(dj.x * dj.x + dj.y * dj.y + dj.z * dj.z);
    float gx = 0.f, gy = 0.f, gz = 0.f;
    if (rj < a.rc) {
      const float inv = 1.f / rj;
      const float hx = dj.x * inv, hy = dj.y * inv, hz = dj.z * inv;
      const float den = rj - a.rc;
      // two-body
      const float sr = a.sig * inv;
      const float sp = power(sr, a.p, a.pf), sq = power(sr, a.q, a.qf);
      const float t1 = expf(a.sig / den);
      const float poly = a.B * sp - sq;
      e += 0.5f * c2 * poly * t1;
      float dr = 0.5f * c2 * t1 *
                 (-(a.B * a.pf * sp - a.qf * sq) * inv -
                  (t1 > 0.f ? poly * a.sig / (den * den) : 0.f));
      // three-body, this entry as j against every other entry k
      const float hj = expf(gs / den);
      const float hpj = hj > 0.f ? -hj * gs / (den * den) : 0.f;
      float px = 0.f, py = 0.f, pz = 0.f;
      if (hj > 0.f) {
        for (int kk = k0; kk < k1; ++kk) {
          if (kk == kj) continue;
          const float3 dk = slot_vec(s, q, kk, ui);
          const float rk = sqrtf(dk.x * dk.x + dk.y * dk.y + dk.z * dk.z);
          if (!(rk < a.rc)) continue;
          const float hk = expf(gs / (rk - a.rc));
          if (hk == 0.f) continue;
          const float ik = 1.f / rk;
          const float kx = dk.x * ik, ky = dk.y * ik, kz = dk.z * ik;
          const float c = hx * kx + hy * ky + hz * kz;
          const float dc = c - a.cos0;
          e += 0.5f * c3 * dc * dc * hj * hk;
          // along rhat_k, and radial
          const float wk = 2.f * c3 * dc * hj * hk * inv;
          px += wk * kx;
          py += wk * ky;
          pz += wk * kz;
          dr += -wk * c + c3 * dc * dc * hk * hpj;
        }
      }
      gx = dr * hx + px;
      gy = dr * hy + py;
      gz = dr * hz + pz;
    }
    float* gk = g + 3 * (size_t)kj;
    gk[0] = gx;
    gk[1] = gy;
    gk[2] = gz;
  }
  s.ecen[(size_t)t * s.na + i] = e;
}

extern "C" int sw_force_f32(const SwArgs* args, void* stream) {
  const SwArgs& a = *args;
  if (!slot_args_ok(a.s) || a.p < -1 || a.p > 16 || a.q < -1 || a.q > 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((a.s.na + SLOT_CENTRE_THREADS - 1) / SLOT_CENTRE_THREADS,
            a.s.ntraj);
  sw_centre_kernel<<<grid, SLOT_CENTRE_THREADS, 0, st>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return slot_gather_launch(a.s, st);
}
