// K10 — eam_force: the embedded-atom-method force of a metal for a batch
// of trajectories, analytic Sutton-Chen or tabulated (setfl splines), in
// one kernel file with two modes and two routes (float32, sm_90a).
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
// F' = -eps c / (2 sqrt(rho)) is masked where rho <= 0, as the twin masks
// sqrt(rho). Divisions by constants are products with their reciprocals
// (the switch's width, the grids' spacings); integer powers are multiplies
// (n and m of the Sutton-Chen sets are 6 to 14), others powf. The spline
// rows are read through L1, not staged: the lanes' r of one slot differ by
// thermal motion only, so they nearly always read the same segment (a
// broadcast).
//
// Both routes keep the layout of slot_force.cuh: a warp is one centre for
// 32 trajectories (a lane each), a block a tile of consecutive centres
// whose rows (records, and in the tabulated mode each slot's neighbour
// type and pair row) are staged in shared memory by cp.async, or read from
// global memory on the wide route; each walk over a row takes its slots in
// chunks of four. Three launches an evaluation either way.
// The route is chosen once, from the table, on the host
// (kernels/eam_force.py pack_operands).
//
// The symmetric route (sym = 1: j is in row i exactly when i is in row j,
// with the opposite reference vector and, tabulated, the same pair row).
// The energy's gradient by x_i then takes each pair once, from row i:
//   F_i = sum_j [phi'(r_ij) + F'_{t_i}(rho_i) rho'_{t_j}(r_ij)
//                + F'_{t_j}(rho_j) rho'_{t_i}(r_ij)] d_ij / r_ij,
// d_ij = x_j - x_i. The transpose of q; eam_centre_kernel_rho, a walk of
// each row that writes F'(rho_i) (and, when the energy is asked for, the
// embedding energy) to (na, tp) scratch; eam_centre_kernel_force, a walk
// of each row that reads the neighbour's F'(rho_j) (one coalesced 128-byte
// row a slot besides u_j) and adds each slot's c d in registers, then
// writes the force (conv F - f0) through shared memory in the integrator's
// (ntraj, 3 na) layout. No slot array, no gather. Its energy (when asked
// for) is summed by the force pass's last block of each trajectory group,
// which finds itself by an integer counter after a __threadfence and
// resets it for the next call (or replay), in the fixed order of the
// gather's energy block: the same bits at any launch shape.
//
// The general route (sym = 0; any other table, a truncated one): rho_i
// depends on row i only, so the gradient of E_i by a slot j of its row
// needs only the centre's own F'(rho_i):
//   dE_i/dd_j = [1/2 (w phi)'(r_j) + F'_{t_i}(rho_i) (w rho_{t_j})'(r_j)]
//               rhat_j,
// the exact gradient of the twin's energy whether the table is symmetric
// or not. The transpose; eam_centre_kernel, whose warp walks its row twice
// (the density walk finds rho_i and F'(rho_i), marking the slots some lane
// takes; the pair walk writes each live slot's gradient as its scalar c
// (the gradient is c d) in whole rows of g (ns, tp) and keeps the centre's
// own share c d in registers); the gather (slot_force.cuh), which takes d
// again from the record and u with the same arithmetic and subtracts c d
// from each slot's head.
//
// What bounds it on the H100: the operations (1.26e7 a trajectory by
// work_counts, each slot's geometry and each entry's terms once: 12 us at
// 64 gold-slab trajectories at the float32 peak), issued one slot after
// another down each warp's row by a grid of about 26 warps an SM. The
// general route takes each slot's geometry three times (its two walks,
// whose loads wait on the slot before, and the gather, seven loads an
// entry) and stores the slots' scalars in between: 86 of 88 a row are
// live, 38 MB at 64 trajectories. The symmetric route takes the geometry
// twice and stores nothing per slot; its walks issue all the loads of a
// chunk of slots before using any, and its force walk evaluates both
// density derivatives (two spline lookups where the types differ). On
// the gold slab at 64 trajectories (H100) it takes 0.134 ms analytic
// (density 0.056, force 0.073) and 0.125 tabulated, against the general
// route's 0.226 and 0.209. Neither the chunk's depth (1 to 16) nor the
// centres of a block (1 to 4) moves it: the loads are hidden, and what
// is left is the arithmetic each slot issues (the IEEE square root and
// reciprocal, the minimum image's tests, the powers' predicated
// multiplies). The first port (a thread per trajectory and centre, each
// lane on another row, the table read again for each trajectory, the
// gather reading each slot twice) was bound by scattered loads: 1.05 ms
// analytic, 1.21 tabulated at 64 gold-slab trajectories.

#include "slot_force.cuh"

// slots whose loads a walk of the symmetric route issues together (4:
// 2, 6, 8 and 12 were no faster on the gold slab; 8 in the force pass
// took registers past a single wave of its grid)
#define EAM_CHUNK 4

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
  float* fp;            // (na, tp) scratch of the symmetric route: F'(rho_i)
  int* done;            // (ntg) its force pass's finished blocks, zero
                        // between calls (the energy's last block)
  int sym;              // 1: the symmetric route
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

// x^n and x^m together (power of each; the integer powers share their
// squarings, with the bits of two powi calls)
__device__ __forceinline__ void power2(float x, int ni, float ne, int mi,
                                       float me, float& xn, float& xm) {
  if (ni < 0 || mi < 0) {
    xn = power(x, ni, ne), xm = power(x, mi, me);
    return;
  }
  float an = 1.f, am = 1.f;
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    an = (ni >> b) & 1 ? an * x : an;
    am = (mi >> b) & 1 ? am * x : am;
    x *= x;
  }
  xn = an, xm = am;
}

// A block's view of its rows: the records (staged, or the table's own on
// the wide route), the type and pair words, and the first slot of the
// staged rows. Every thread of the block constructs it, before any returns.
struct EamRows {
  const int4* rec;
  const int2* stp;
  int first;
};

template <bool kWide>
__device__ __forceinline__ EamRows eam_rows(const EamArgs& a, int c0,
                                            int4* smem) {
  EamRows w{a.s.rec, a.slot_tp, 0};
  if (!kWide) {
    int2* xs = reinterpret_cast<int2*>(smem + a.s.wpb * a.s.width);
    w.first = slot_stage(a.s, c0, smem, a.mode == 1 ? a.slot_tp : nullptr,
                         xs);
    w.rec = smem;
    w.stp = xs;
  }
  return w;
}

// the density term of slot k at r < rc: rho_{t_j}(r), or sw (a/r)^m
__device__ __forceinline__ float rho_term(const EamArgs& a, const EamRows& w,
                                          int k, float r) {
  if (a.mode == 1)
    return spline(a.rhoc + (size_t)w.stp[k - w.first].x * 4 * a.nseg_r,
                  a.nseg_r, a.dr, a.idr, r).v;
  float sw, dsw;
  switch_fn(r, a.r_on, a.iw, sw, dsw);
  return sw * power(a.a * (1.f / r), a.m, a.mf);
}

// The loads of the slots [kb, kb + C) of a row that ends at k1, all issued
// before any is used: each head's u_j and, with kFp, its F'(rho_j). A slot
// past the row's end reads the row's last again, so that no branch
// separates the loads (slot_vec's minimum image branches between one
// slot's loads and the next slot's).
template <int C, bool kFp>
__device__ __forceinline__ void chunk_loads(const EamRows& w, const float* u,
                                            const float* fpt, size_t tp,
                                            int kb, int k1, float (&ux)[C],
                                            float (&uy)[C], float (&uz)[C],
                                            float (&fj)[C]) {
  int j[C];
#pragma unroll
  for (int m = 0; m < C; ++m) j[m] = w.rec[min(kb + m, k1 - 1) - w.first].w;
#pragma unroll
  for (int m = 0; m < C; ++m) {
    const float* uj = u + 3 * (size_t)j[m] * tp;
    ux[m] = uj[0];
    uy[m] = uj[tp];
    uz[m] = uj[2 * tp];
    if (kFp) fj[m] = fpt[(size_t)j[m] * tp];
  }
}

// a slot's vector from its record and its head's loaded u_j (slot_vec's
// arithmetic)
__device__ __forceinline__ float3 loaded_vec(const SlotArgs& s, int4 r4,
                                             float ujx, float ujy, float ujz,
                                             float uix, float uiy,
                                             float uiz) {
  return make_float3(slot_mic(__int_as_float(r4.x) + (ujx - uix), s.cx),
                     slot_mic(__int_as_float(r4.y) + (ujy - uiy), s.cy),
                     slot_mic(__int_as_float(r4.z) + (ujz - uiz), s.cz));
}

// the embedding energy F_{t_i}(rho) and its derivative
__device__ __forceinline__ void embed(const EamArgs& a, int i, float rho,
                                      float& e, float& fp) {
  if (a.mode == 1) {
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
}

// the general route's centre pass
template <bool kWide>
__global__ void __launch_bounds__(SLOT_MAX_WARPS * 32)
eam_centre_kernel(const EamArgs a) {
  extern __shared__ __align__(16) int4 smem[];
  const SlotArgs& s = a.s;
  const bool tab = a.mode == 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tg = blockIdx.y, t = tg * SLOT_LANES + lane;
  const int c0 = blockIdx.x * s.wpb;
  const EamRows w = eam_rows<kWide>(a, c0, smem);
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

  // the density walk: rho_i, the embedding energy and its derivative;
  // the loads of SLOT_CHUNK slots issued together
  float rho = 0.f;
  for (int kb = k0; kb < k1; kb += SLOT_CHUNK) {
    float3 dv[SLOT_CHUNK];
#pragma unroll
    for (int m = 0; m < SLOT_CHUNK; ++m)
      if (kb + m < k1)
        dv[m] = slot_vec(s, u, w.rec[kb + m - w.first], uix, uiy, uiz);
#pragma unroll
    for (int m = 0; m < SLOT_CHUNK; ++m) {
      const int k = kb + m;
      if (k >= k1) break;
      const float3 d = dv[m];
      const float r = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
      const bool in = r < a.rc;
      const bool any = __ballot_sync(0xffffffffu, in && on) != 0u;
      if (lane == 0) live[k] = any;
      if (in) rho += rho_term(a, w, k, r);
    }
  }
  float e, fp;
  embed(a, i, rho, e, fp);

  // the pair walk: the pair energy, every live slot's gradient as its
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
      if (lv[m])
        dv[m] = slot_vec(s, u, w.rec[kb + m - w.first], uix, uiy, uiz);
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
          const int2 tpk = w.stp[k - w.first];
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

// the symmetric route's density pass: F'(rho_i) of every centre and
// trajectory, and its embedding energy when the energy is asked for
template <bool kWide>
__global__ void __launch_bounds__(SLOT_MAX_WARPS * 32)
eam_centre_kernel_rho(const EamArgs a) {
  extern __shared__ __align__(16) int4 smem[];
  const SlotArgs& s = a.s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.y * SLOT_LANES + lane;
  const int c0 = blockIdx.x * s.wpb;
  const EamRows w = eam_rows<kWide>(a, c0, smem);
  const int i = c0 + warp;
  if (i >= s.na) return;
  const size_t tp = s.tp;
  const float* u = s.u + t;
  const float uix = u[3 * (size_t)i * tp], uiy = u[(3 * (size_t)i + 1) * tp],
              uiz = u[(3 * (size_t)i + 2) * tp];
  const int k0 = s.row_ptr[i], k1 = s.row_ptr[i + 1];
  float rho = 0.f;
  for (int kb = k0; kb < k1; kb += EAM_CHUNK) {
    float ux[EAM_CHUNK], uy[EAM_CHUNK], uz[EAM_CHUNK], fj[EAM_CHUNK];
    chunk_loads<EAM_CHUNK, false>(w, u, nullptr, tp, kb, k1, ux, uy, uz, fj);
#pragma unroll
    for (int m = 0; m < EAM_CHUNK; ++m) {
      const int k = kb + m;
      if (k >= k1) break;
      const float3 d = loaded_vec(s, w.rec[k - w.first], ux[m], uy[m], uz[m],
                                  uix, uiy, uiz);
      const float r = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
      if (r < a.rc) rho += rho_term(a, w, k, r);
    }
  }
  float e, fp;
  embed(a, i, rho, e, fp);
  a.fp[(size_t)i * tp + t] = fp;
  if (s.e) s.ecen[(size_t)i * tp + t] = e;
}

// the symmetric route's force pass: each centre's force from its own row
// and its neighbours' F'(rho_j), written as conv F - f0 through shared
// memory in the (ntraj, 3 na) layout; the energy by the last block
template <bool kWide>
__global__ void __launch_bounds__(SLOT_MAX_WARPS * 32)
eam_centre_kernel_force(const EamArgs a) {
  extern __shared__ __align__(16) int4 smem[];
  // [trajectory][3 x centre of the tile], odd row length
  __shared__ float tile[SLOT_LANES][3 * SLOT_MAX_WARPS + 1];
  const SlotArgs& s = a.s;
  const bool tab = a.mode == 1, en = s.e != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tg = blockIdx.y, t = tg * SLOT_LANES + lane;
  const int c0 = blockIdx.x * s.wpb;
  const EamRows w = eam_rows<kWide>(a, c0, smem);
  const int i = c0 + warp;
  const size_t tp = s.tp;
  if (i < s.na) {
    const float* u = s.u + t;
    const float* fpt = a.fp + t;
    const float uix = u[3 * (size_t)i * tp],
                uiy = u[(3 * (size_t)i + 1) * tp],
                uiz = u[(3 * (size_t)i + 2) * tp];
    const float fpi = fpt[(size_t)i * tp];
    const int k0 = s.row_ptr[i], k1 = s.row_ptr[i + 1];
    const int nr4 = 4 * a.nseg_r;
    const int ti = tab ? a.type[i] : 0;
    float e = en ? s.ecen[(size_t)i * tp + t] : 0.f;
    float fx = 0.f, fy = 0.f, fz = 0.f;
    for (int kb = k0; kb < k1; kb += EAM_CHUNK) {
      float ux[EAM_CHUNK], uy[EAM_CHUNK], uz[EAM_CHUNK], fpj[EAM_CHUNK];
      chunk_loads<EAM_CHUNK, true>(w, u, fpt, tp, kb, k1, ux, uy, uz, fpj);
#pragma unroll
      for (int m = 0; m < EAM_CHUNK; ++m) {
        const int k = kb + m;
        if (k >= k1) break;
        const float3 d = loaded_vec(s, w.rec[k - w.first], ux[m], uy[m],
                                    uz[m], uix, uiy, uiz);
        const float r = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
        if (!(r < a.rc)) continue;
        const float inv = 1.f / r;
        float coef;
        if (tab) {
          const int2 tpk = w.stp[k - w.first];
          const SplineVal rp = spline(a.rphic + (size_t)tpk.y * nr4,
                                      a.nseg_r, a.dr, a.idr, r);
          const SplineVal rj = spline(a.rhoc + (size_t)tpk.x * nr4,
                                      a.nseg_r, a.dr, a.idr, r);
          // rho'_{t_i}: the same lookup where the two types agree
          const float dri =
              tpk.x == ti ? rj.d
                          : spline(a.rhoc + (size_t)ti * nr4, a.nseg_r, a.dr,
                                   a.idr, r).d;
          if (en) e += 0.5f * rp.v * inv;
          coef = (rp.d * inv - rp.v * inv * inv) + fpi * rj.d + fpj[m] * dri;
        } else {
          float sw, dsw;
          switch_fn(r, a.r_on, a.iw, sw, dsw);
          float arn, arm;
          power2(a.a * inv, a.n, a.nf, a.m, a.mf, arn, arm);
          if (en) e += 0.5f * a.eps * sw * arn;
          coef = a.eps * (dsw * arn - sw * a.nf * arn * inv) +
                 (fpi + fpj[m]) * (dsw * arm - sw * a.mf * arm * inv);
        }
        coef *= inv;
        fx += coef * d.x;
        fy += coef * d.y;
        fz += coef * d.z;
      }
    }
    const int dd = 3 * i;
    // (a product rounded on its own: fused with the subtraction it would
    // leave the rounding's remainder where f0 is meant to cancel exactly)
    const float p0 = __fmul_rn(s.conv[dd], fx),
                p1 = __fmul_rn(s.conv[dd + 1], fy),
                p2 = __fmul_rn(s.conv[dd + 2], fz);
    tile[lane][3 * warp] = s.f0 ? p0 - s.f0[dd] : p0;
    tile[lane][3 * warp + 1] = s.f0 ? p1 - s.f0[dd + 1] : p1;
    tile[lane][3 * warp + 2] = s.f0 ? p2 - s.f0[dd + 2] : p2;
    if (en) s.ecen[(size_t)i * tp + t] = e;
  }
  __syncthreads();
  const int nph = 3 * s.na, d0 = 3 * c0, row = 3 * s.wpb;
  const int nd = min(row, nph - d0);
  for (int x = threadIdx.x; x < SLOT_LANES * row; x += blockDim.x) {
    const int r = x / row, c = x % row;
    const int tt = tg * SLOT_LANES + r;
    if (tt < s.ntraj && c < nd) s.f[(size_t)tt * nph + d0 + c] = tile[r][c];
  }
  if (!en) return;

  // the energy: the group's last block to finish sums the centres' energies
  // in the gather's fixed order (SLOT_GATHER_WARPS parts, then the parts)
  __shared__ float red[SLOT_GATHER_WARPS][SLOT_LANES];
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.done + tg, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int per = (s.na + SLOT_GATHER_WARPS - 1) / SLOT_GATHER_WARPS;
  for (int p = warp; p < SLOT_GATHER_WARPS; p += s.wpb) {
    const int i1 = min(s.na, (p + 1) * per);
    float acc = 0.f;
    for (int c = p * per; c < i1; ++c)
      acc += __ldcg(s.ecen + (size_t)c * tp + t);
    red[p][lane] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    if (t < s.ntraj) {
      float tot = 0.f;
      for (int p = 0; p < SLOT_GATHER_WARPS; ++p) tot += red[p][lane];
      s.e[t] = tot;
    }
    if (lane == 0) a.done[tg] = 0;
  }
}

// a centre-pass launch: the wide form, or the staged one with its shared
// memory (set once per kernel above the default)
static int eam_launch(void (*wide)(EamArgs), void (*staged)(EamArgs),
                      int* smem_set, const EamArgs& a, dim3 grid,
                      size_t smem, cudaStream_t st) {
  const int threads = 32 * a.s.wpb;
  if (a.s.wide) {
    wide<<<grid, threads, 0, st>>>(a);
  } else {
    const int rc = slot_smem_attr((const void*)staged, (int)smem, smem_set);
    if (rc) return rc;
    staged<<<grid, threads, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" int eam_force_f32(const EamArgs* args, void* stream) {
  static int smem_centre = 0, smem_rho = 0, smem_force = 0;
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
  if (a.sym && (!a.fp || (s.e && !a.done))) return (int)cudaErrorInvalidValue;
  // the rows' records, and their type and pair words when tabulated
  const size_t smem =
      s.wide ? 0 : (size_t)s.wpb * s.width * (16 + (a.mode == 1 ? 8 : 0));
  if (smem > SLOT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = slot_transpose_launch(s, st);
  if (rc) return rc;
  dim3 grid((s.na + s.wpb - 1) / s.wpb, s.tp / SLOT_LANES);
  if (a.sym) {
    rc = eam_launch(eam_centre_kernel_rho<true>, eam_centre_kernel_rho<false>,
                    &smem_rho, a, grid, smem, st);
    if (rc) return rc;
    return eam_launch(eam_centre_kernel_force<true>,
                      eam_centre_kernel_force<false>, &smem_force, a, grid,
                      smem, st);
  }
  rc = eam_launch(eam_centre_kernel<true>, eam_centre_kernel<false>,
                  &smem_centre, a, grid, smem, st);
  if (rc) return rc;
  return slot_gather_launch(s, st);
}
