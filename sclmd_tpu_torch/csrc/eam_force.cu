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
// Three launches an evaluation (slot_force.cuh): the transpose of q, this
// centre pass, the gather. A warp is one centre for 32 trajectories, a
// block a tile of consecutive centres whose rows (records, and in the
// tabulated mode each slot's neighbour type and pair row) are staged in
// shared memory by cp.async. The warp walks its row twice: the density
// pass finds rho_i and F'(rho_i); the pair pass writes each live slot's
// gradient as its scalar c (the gradient is c d) in whole rows of g (ns,
// tp), and keeps the centre's own share c d in registers; the gather
// takes d again from the record and u, with the same arithmetic. The
// pair pass takes the slot's vector again from the broadcast record and
// the lane's coalesced row of u, and r from it: the direction is needed
// again in any case, and keeping r for the pass would take 11 KB of
// shared memory a warp at the gold slab's rows of 86 (about 18 warps an
// SM, where the grid gives each 26), to save a sqrt and three multiply-
// adds a slot. The spline rows are
// read through L1, not staged: the lanes' r of one slot differ by thermal
// motion only, so they nearly always read the same segment (a
// broadcast). Divisions by constants are products with their reciprocals
// (the switch's width, the grids' spacings); integer powers are
// multiplies (n and m of the Sutton-Chen sets are 6 to 14), others powf.
//
// What bounds it on the H100: the operations (1.26e7 a trajectory by
// work_counts, each slot's geometry and each entry's terms once: 12 us at
// 64 gold-slab trajectories at the float32 peak; the pair pass and the
// gather take the geometry again), issued one slot after another down
// each warp's row, and the slots' scalars between the centre pass and the
// gather: 86 of 88 a row are live, 38 MB at 64 trajectories (a vector a
// slot would be 114 MB, more than L2 holds). PR 9's first port (a thread
// per trajectory and centre, each lane on another row, the table read
// again for each trajectory, the gather reading each slot twice) was bound
// by scattered loads: 1.05 ms analytic, 1.21 tabulated at 64 gold-slab
// trajectories.

#include "slot_force.cuh"

struct EamArgs {
  SlotArgs s;
  const float* fc;      // (nel, nseg_rho, 4) F splines (tabulated)
  const float* rhoc;    // (nel, nseg_r, 4) rho splines
  const float* rphic;   // (npair, nseg_r, 4) r * phi splines
  const int* type;      // (na) element row of each atom
  const int2* slot_tp;  // (ns) each slot's neighbour type and pair row
  int mode;             // 0 analytic Sutton-Chen, 1 tabulated
  int n, m;             // Sutton-Chen powers as integers 0-32, or -1
  float nf, mf;         // the powers (powf of these where n or m is -1)
  int nseg_rho, nseg_r;
  float eps, a, c, rc, r_on;
  float drho, dr;
  float iw, idrho, idr;  // 1 / (rc - r_on), 1 / drho, 1 / dr
};

struct SplineVal {
  float v, d;
};

__device__ __forceinline__ SplineVal spline(const float* coefs, int nseg,
                                            float h, float ih, float x) {
  const int idx = (int)fminf(fmaxf(x * ih, 0.f), (float)(nseg - 1));
  const float t = x - (float)idx * h;
  const float4 cc = reinterpret_cast<const float4*>(coefs)[idx];
  SplineVal out;
  out.v = ((cc.w * t + cc.z) * t + cc.y) * t + cc.x;
  out.d = (3.f * cc.w * t + 2.f * cc.z) * t + cc.y;
  return out;
}

// the C2 switch and its derivative (iw = 1 / its width)
__device__ __forceinline__ void switch_fn(float r, float r_on, float iw,
                                          float& sw, float& dsw) {
  const float u = (r - r_on) * iw;
  if (u <= 0.f) {
    sw = 1.f, dsw = 0.f;
  } else if (u >= 1.f) {
    sw = 0.f, dsw = 0.f;
  } else {
    const float u2 = u * u, u3 = u2 * u;
    sw = 1.f - 6.f * u3 * u2 + 15.f * u2 * u2 - 10.f * u3;
    dsw = (-30.f * u2 * u2 + 60.f * u3 - 30.f * u2) * iw;
  }
}

template <bool kWide>
__global__ void __launch_bounds__(SLOT_MAX_WARPS * 32)
eam_centre_kernel(const EamArgs a) {
  extern __shared__ __align__(16) int4 smem[];
  const SlotArgs& s = a.s;
  const bool tab = a.mode == 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tg = blockIdx.y, t = tg * SLOT_LANES + lane;
  const int c0 = blockIdx.x * s.wpb;
  const int4* rec = s.rec;
  const int2* stp = a.slot_tp;
  int first = 0;
  if (!kWide) {
    int2* xs = reinterpret_cast<int2*>(smem + s.wpb * s.width);
    first = slot_stage(s, c0, smem, tab ? a.slot_tp : nullptr, xs);
    rec = smem;
    stp = xs;
  }
  const int i = c0 + warp;
  if (i >= s.na) return;
  const bool on = t < s.ntraj;
  const size_t tp = s.tp;
  const float* u = s.u + t;
  const float uix = u[3 * (size_t)i * tp], uiy = u[(3 * (size_t)i + 1) * tp],
              uiz = u[(3 * (size_t)i + 2) * tp];
  const int k0 = s.row_ptr[i], k1 = s.row_ptr[i + 1];
  const int nr4 = 4 * a.nseg_r;
  unsigned char* live = s.live + (size_t)tg * s.ns;

  // the density pass: rho_i, the embedding energy and its derivative;
  // the loads of SLOT_CHUNK slots issued together
  float rho = 0.f;
  for (int kb = k0; kb < k1; kb += SLOT_CHUNK) {
    float3 dv[SLOT_CHUNK];
#pragma unroll
    for (int m = 0; m < SLOT_CHUNK; ++m)
      if (kb + m < k1)
        dv[m] = slot_vec(s, u, rec[kb + m - first], uix, uiy, uiz);
#pragma unroll
    for (int m = 0; m < SLOT_CHUNK; ++m) {
      const int k = kb + m;
      if (k >= k1) break;
      const float3 d = dv[m];
      const float r = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
      const bool in = r < a.rc;
      const bool any = __ballot_sync(0xffffffffu, in && on) != 0u;
      if (lane == 0) live[k] = any;
      if (!in) continue;
      if (tab) {
        rho += spline(a.rhoc + (size_t)stp[k - first].x * nr4, a.nseg_r,
                      a.dr, a.idr, r).v;
      } else {
        float sw, dsw;
        switch_fn(r, a.r_on, a.iw, sw, dsw);
        rho += sw * power(a.a * (1.f / r), a.m, a.mf);
      }
    }
  }
  float e, fp;
  if (tab) {
    const SplineVal F = spline(a.fc + (size_t)a.type[i] * 4 * a.nseg_rho,
                               a.nseg_rho, a.drho, a.idrho, rho);
    e = F.v, fp = F.d;
  } else if (rho > 0.f) {
    const float sr = sqrtf(rho);
    e = -a.eps * a.c * sr;
    fp = -0.5f * a.eps * a.c / sr;
  } else {
    e = 0.f, fp = 0.f;
  }

  // the pair pass: the pair energy, every live slot's gradient as its
  // scalar c (gradient c d), and the centre's own share (it is each
  // slot's tail: pushed along)
  __syncwarp();
  float fx = 0.f, fy = 0.f, fz = 0.f;
  float* g = s.g + t;
  for (int kb = k0; kb < k1; kb += SLOT_CHUNK) {
    float3 dv[SLOT_CHUNK];
    bool lv[SLOT_CHUNK];
#pragma unroll
    for (int m = 0; m < SLOT_CHUNK; ++m) {
      lv[m] = kb + m < k1 && live[kb + m];
      if (lv[m]) dv[m] = slot_vec(s, u, rec[kb + m - first], uix, uiy, uiz);
    }
#pragma unroll
    for (int m = 0; m < SLOT_CHUNK; ++m) {
      if (!lv[m]) continue;
      const int k = kb + m;
      const float3 d = dv[m];
      const float r = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
      float coef = 0.f;
      if (r < a.rc) {
        const float inv = 1.f / r;
        if (tab) {
          const int2 tpk = stp[k - first];
          const SplineVal rp = spline(a.rphic + (size_t)tpk.y * nr4,
                                      a.nseg_r, a.dr, a.idr, r);
          const SplineVal rh = spline(a.rhoc + (size_t)tpk.x * nr4,
                                      a.nseg_r, a.dr, a.idr, r);
          e += 0.5f * rp.v * inv;
          coef = 0.5f * (rp.d * inv - rp.v * inv * inv) + fp * rh.d;
        } else {
          float sw, dsw;
          switch_fn(r, a.r_on, a.iw, sw, dsw);
          const float ar = a.a * inv;
          const float arn = power(ar, a.n, a.nf), arm = power(ar, a.m, a.mf);
          e += 0.5f * a.eps * sw * arn;
          coef = 0.5f * a.eps * (dsw * arn - sw * a.nf * arn * inv) +
                 fp * (dsw * arm - sw * a.mf * arm * inv);
        }
        coef *= inv;
        // (products rounded on their own: the gather takes the same ones)
        fx += __fmul_rn(coef, d.x);
        fy += __fmul_rn(coef, d.y);
        fz += __fmul_rn(coef, d.z);
      }
      g[(size_t)k * tp] = coef;
    }
  }
  float* ft = s.ftail + 3 * (size_t)i * tp + t;
  ft[0] = fx;
  ft[tp] = fy;
  ft[2 * tp] = fz;
  s.ecen[(size_t)i * tp + t] = e;
}

extern "C" int eam_force_f32(const EamArgs* args, void* stream) {
  static int smem_set = 0;
  const EamArgs& a = *args;
  const SlotArgs& s = a.s;
  if (!slot_args_ok(s) || !s.scalar || a.mode < 0 || a.mode > 1 ||
      !(a.rc > 0.f))
    return (int)cudaErrorInvalidValue;
  if (a.mode == 0 && (a.n < -1 || a.n > 32 || a.m < -1 || a.m > 32 ||
                      !(a.rc > a.r_on)))
    return (int)cudaErrorInvalidValue;
  if (a.mode == 1 &&
      (!a.fc || !a.rhoc || !a.rphic || !a.type || a.nseg_rho < 1 ||
       a.nseg_r < 1 || (s.ns && !a.slot_tp) ||
       (reinterpret_cast<uintptr_t>(a.fc) & 15) ||
       (reinterpret_cast<uintptr_t>(a.rhoc) & 15) ||
       (reinterpret_cast<uintptr_t>(a.rphic) & 15)))
    return (int)cudaErrorInvalidValue;
  // the rows' records, and their type and pair words when tabulated
  const size_t smem =
      s.wide ? 0 : (size_t)s.wpb * s.width * (16 + (a.mode == 1 ? 8 : 0));
  if (smem > SLOT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = slot_transpose_launch(s, st);
  if (rc) return rc;
  dim3 grid((s.na + s.wpb - 1) / s.wpb, s.tp / SLOT_LANES);
  if (s.wide) {
    eam_centre_kernel<true><<<grid, 32 * s.wpb, 0, st>>>(a);
  } else {
    rc = slot_smem_attr((const void*)eam_centre_kernel<false>, (int)smem,
                        &smem_set);
    if (rc) return rc;
    eam_centre_kernel<false><<<grid, 32 * s.wpb, smem, st>>>(a);
  }
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return slot_gather_launch(s, st);
}
