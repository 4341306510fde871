// K10 — eam_force: the embedded-atom-method force of a metal for a batch
// of trajectories, analytic Sutton-Chen or tabulated (setfl splines), in
// one kernel with two modes (float32, sm_90a).
//
// Replaces: the XLA computation that the JAX package gets from jax.grad of
// sclmd_tpu/models/eam.py:72 sutton_chen_energy and :269
// eam_tabulated_energy (splines of :149 _spline_eval); neither was a
// Pallas kernel. Here the gradient is written out analytically:
//
//   E   = sum_i E_i,  over each centre's own row of the padded table
//   E_i = 1/2 sum_j w_ij phi(r_ij) + F_{t_i}(rho_i),
//   rho_i = sum_j w_ij rho_{t_j}(r_ij)
//   analytic:  w phi = sw(r) eps (a/r)^n,  w rho = sw(r) (a/r)^m,
//              F = -eps c sqrt(rho) (0 where rho <= 0), sw the C2 switch
//              from rc - width to rc, w = 0 from rc on;
//   tabulated: phi = rphi(r) / r, rho_t(r) and F_t(rho) natural cubic
//              splines on uniform grids (value a + b t + c t^2 + d t^3,
//              derivative b + 2 c t + 3 d t^2, segment
//              clip(int(x / h), 0, nseg - 1), t = x - idx h: past the
//              last knot the end segment extrapolates), w = [r < rc].
//
// rho_i depends on row i only, so the gradient of E_i by a slot j of its
// row needs only the centre's own F'(rho_i):
//   dE_i/dd_j = [1/2 (w phi)'(r_j) + F'_{t_i}(rho_i) (w rho_{t_j})'(r_j)]
//               rhat_j.
// It is the exact gradient of the twin's energy whether the table is
// symmetric or not (a truncated table); no term assumes j in row i <=>
// i in row j. F' = -eps c / (2 sqrt(rho)) is masked where rho <= 0, as the
// twin masks sqrt(rho).
//
// Two passes over each row in the centre kernel (rho_i and F'(rho_i),
// then the slots' gradients and the pair energy), one thread per
// (trajectory, centre); then the gather of slot_force.cuh. Integer
// powers by multiplies (n and m of the Sutton-Chen sets are 6 to 14),
// others by powf.
//
// What bounds it on the H100: not bytes (q read and f written once, 41
// KB a trajectory on the 1,728-atom gold slab, with 3.6 MB of table, 4.9
// MB tabulated with the splines and types, all in L2) nor the operations
// (1.3e7 a trajectory by work_counts) but each thread's two walks over a
// row of 88 entries (sqrt, division, a switch or a spline lookup per
// entry) and the neighbours' q through L1 and L2. A simple design first:
// everything in global memory, no staging.

#include "slot_force.cuh"

struct EamArgs {
  SlotArgs s;
  const float* fc;      // (nel, nseg_rho, 4) F splines (tabulated)
  const float* rhoc;    // (nel, nseg_r, 4) rho splines
  const float* rphic;   // (npair, nseg_r, 4) r * phi splines
  const int* type;      // (na) element row of each atom
  const int* slot_t;    // (ns) element row of each slot's neighbour
  const int* slot_pair; // (ns) pair row of each slot
  int mode;             // 0 analytic Sutton-Chen, 1 tabulated
  int n, m;             // Sutton-Chen powers as integers 0-32, or -1
  float nf, mf;         // the powers (powf of these where n or m is -1)
  int nseg_rho, nseg_r;
  float eps, a, c, rc, r_on;
  float drho, dr;
};

struct SplineVal {
  float v, d;
};

__device__ __forceinline__ SplineVal spline(const float* coefs, int nseg,
                                            float h, float x) {
  const int idx = (int)fminf(fmaxf(x / h, 0.f), (float)(nseg - 1));
  const float t = x - (float)idx * h;
  const float4 cc = reinterpret_cast<const float4*>(coefs)[idx];
  SplineVal out;
  out.v = ((cc.w * t + cc.z) * t + cc.y) * t + cc.x;
  out.d = (3.f * cc.w * t + 2.f * cc.z) * t + cc.y;
  return out;
}

// the C2 switch and its derivative
__device__ __forceinline__ void switch_fn(float r, float r_on, float rc,
                                          float& sw, float& dsw) {
  const float width = rc - r_on;
  const float u = (r - r_on) / width;
  if (u <= 0.f) {
    sw = 1.f, dsw = 0.f;
  } else if (u >= 1.f) {
    sw = 0.f, dsw = 0.f;
  } else {
    const float u2 = u * u, u3 = u2 * u;
    sw = 1.f - 6.f * u3 * u2 + 15.f * u2 * u2 - 10.f * u3;
    dsw = (-30.f * u2 * u2 + 60.f * u3 - 30.f * u2) / width;
  }
}

__global__ void __launch_bounds__(SLOT_CENTRE_THREADS)
eam_centre_kernel(const EamArgs a) {
  const SlotArgs& s = a.s;
  const int i = blockIdx.x * SLOT_CENTRE_THREADS + threadIdx.x;
  const int t = blockIdx.y;
  if (i >= s.na) return;
  const float* q = s.q + (size_t)t * 3 * s.na;
  float* g = s.g + (size_t)t * s.ns * 3;
  const float3 ui = slot_disp(s, q, i);
  const int k0 = s.row_ptr[i], k1 = s.row_ptr[i + 1];
  const bool tab = a.mode == 1;
  const int nr4 = 4 * a.nseg_r;

  // pass 1: the density and the embedding energy and its derivative
  float rho = 0.f;
  for (int k = k0; k < k1; ++k) {
    const float3 d = slot_vec(s, q, k, ui);
    const float r = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
    if (!(r < a.rc)) continue;
    if (tab) {
      rho += spline(a.rhoc + (size_t)a.slot_t[k] * nr4, a.nseg_r, a.dr, r).v;
    } else {
      float sw, dsw;
      switch_fn(r, a.r_on, a.rc, sw, dsw);
      rho += sw * power(a.a / r, a.m, a.mf);
    }
  }
  float e, fp;
  if (tab) {
    const SplineVal F = spline(a.fc + (size_t)a.type[i] * 4 * a.nseg_rho,
                               a.nseg_rho, a.drho, rho);
    e = F.v, fp = F.d;
  } else if (rho > 0.f) {
    const float sr = sqrtf(rho);
    e = -a.eps * a.c * sr;
    fp = -0.5f * a.eps * a.c / sr;
  } else {
    e = 0.f, fp = 0.f;
  }

  // pass 2: the pair energy and every slot's gradient
  for (int k = k0; k < k1; ++k) {
    const float3 d = slot_vec(s, q, k, ui);
    const float r = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
    float coef = 0.f;
    if (r < a.rc) {
      const float inv = 1.f / r;
      if (tab) {
        const SplineVal rp =
            spline(a.rphic + (size_t)a.slot_pair[k] * nr4, a.nseg_r, a.dr, r);
        const SplineVal rh =
            spline(a.rhoc + (size_t)a.slot_t[k] * nr4, a.nseg_r, a.dr, r);
        e += 0.5f * rp.v * inv;
        coef = 0.5f * (rp.d * inv - rp.v * inv * inv) + fp * rh.d;
      } else {
        float sw, dsw;
        switch_fn(r, a.r_on, a.rc, sw, dsw);
        const float ar = a.a * inv;
        const float arn = power(ar, a.n, a.nf), arm = power(ar, a.m, a.mf);
        e += 0.5f * a.eps * sw * arn;
        coef = 0.5f * a.eps * (dsw * arn - sw * a.nf * arn * inv) +
               fp * (dsw * arm - sw * a.mf * arm * inv);
      }
      coef *= inv;
    }
    float* gk = g + 3 * (size_t)k;
    gk[0] = coef * d.x;
    gk[1] = coef * d.y;
    gk[2] = coef * d.z;
  }
  s.ecen[(size_t)t * s.na + i] = e;
}

extern "C" int eam_force_f32(const EamArgs* args, void* stream) {
  const EamArgs& a = *args;
  if (!slot_args_ok(a.s) || a.mode < 0 || a.mode > 1 || !(a.rc > 0.f))
    return (int)cudaErrorInvalidValue;
  if (a.mode == 0 && (a.n < -1 || a.n > 32 || a.m < -1 || a.m > 32 ||
                      !(a.rc > a.r_on)))
    return (int)cudaErrorInvalidValue;
  if (a.mode == 1 &&
      (!a.fc || !a.rhoc || !a.rphic || !a.type || a.nseg_rho < 1 ||
       a.nseg_r < 1 || (a.s.ns && (!a.slot_t || !a.slot_pair)) ||
       (reinterpret_cast<uintptr_t>(a.fc) & 15) ||
       (reinterpret_cast<uintptr_t>(a.rhoc) & 15) ||
       (reinterpret_cast<uintptr_t>(a.rphic) & 15)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((a.s.na + SLOT_CENTRE_THREADS - 1) / SLOT_CENTRE_THREADS,
            a.s.ntraj);
  eam_centre_kernel<<<grid, SLOT_CENTRE_THREADS, 0, st>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return slot_gather_launch(a.s, st);
}
