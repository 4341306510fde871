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
// Three launches an evaluation (slot_force.cuh): the transpose of q, this
// centre pass, the gather. A warp is one centre for 32 trajectories, a
// block a tile of consecutive centres whose rows are staged in shared
// memory. The warp walks its row once, taking each slot's geometry once:
// the slots some lane takes (inside the cutoff) are kept, with each
// lane's unit vector, h and r in shared memory, and each lane sets a bit
// for each kept entry it takes itself. The pair and angular loops then
// run per lane over its own bits, so no geometry is taken again and a
// lane's angular double loop covers only the entries it takes: at
// thermal displacements nearly every second neighbour of the silicon slab
// (3.84 angstrom against a cutoff of 3.77) is inside for a few lanes of
// a warp, so all 16 slots of a row are kept while a lane takes about 6.
// A lane writes its gradient of each slot it takes into its own column
// of the slot's rows of g, and 0 into those of the kept slots it does
// not take; no other lane writes that column. The row width stays a loop
// bound: shared
// memory is sized by the widest row at launch (kernels/slots.py
// launch_plan), and a table too wide for one warp's entries takes the
// wide route (rows read from global memory, entries in a global scratch
// laid out by slot), with the same bits.
//
// What bounds it on the H100: not bytes (q read and f written once, 83
// KB a trajectory on the 3,456-atom slab, with 1.2 MB of table) but the
// operations the geometry needs (4.0e6 a trajectory by work_counts: 3.8 us
// at 64 trajectories at the float32 peak), and in practice the issue of
// each warp's instructions (sqrt, divisions, exponentials, the angular
// loop) at the occupancy the entries' shared memory allows, with the
// lanes of a warp idle where their trajectories take fewer entries than
// the warp's busiest. PR 9's first port (a thread per trajectory and
// centre, walking its row again for every entry inside the cutoff, each
// lane on another row) was bound by scattered loads: 0.659 ms at 64 slab
// trajectories.

#include "slot_force.cuh"

struct SwArgs {
  SlotArgs s;
  float A, B, eps, sig, rc, lam, gam, cos0;
  int p, q;      // the powers as integers 0-16, or -1: powf of pf, qf
  float pf, qf;
};

// per lane and kept entry: the unit vector (3), h and r; per kept entry
// its slot; and per lane a bit a kept entry, set where the lane takes it
#define SW_KEEP 5

// a lane's kept entries (component c of entry e), its mask words, and
// the warp's slot of each kept entry
struct LaneEntries {
  float* p;
  size_t ce, ee;
  unsigned* m;
  size_t me;
  int* slot;
  __device__ __forceinline__ float& operator()(int c, int e) const {
    return p[c * ce + e * ee];
  }
  __device__ __forceinline__ unsigned& mask(int w) const { return m[w * me]; }
};

template <bool kWide>
__global__ void __launch_bounds__(SLOT_MAX_WARPS * 32)
sw_centre_kernel(const SwArgs a) {
  extern __shared__ __align__(16) int4 smem[];
  const SlotArgs& s = a.s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tg = blockIdx.y, t = tg * SLOT_LANES + lane;
  const int c0 = blockIdx.x * s.wpb;
  const int4* rec = s.rec;
  int first = 0;
  if (!kWide) {
    first = slot_stage(s, c0, smem, nullptr, nullptr);
    rec = smem;
  }
  const int i = c0 + warp;
  if (i >= s.na) return;
  const bool on = t < s.ntraj;
  const size_t tp = s.tp;
  const float* u = s.u + t;
  const float uix = u[3 * (size_t)i * tp], uiy = u[(3 * (size_t)i + 1) * tp],
              uiz = u[(3 * (size_t)i + 2) * tp];
  const int k0 = s.row_ptr[i], k1 = s.row_ptr[i + 1];
  LaneEntries ent;
  if (kWide) {
    // (SW_KEEP + 2, ns, tp): the entries, the mask words, and the slots
    // (ntg, ns) at each row's own positions
    ent.p = s.scr + (size_t)k0 * tp + t;
    ent.ce = (size_t)s.ns * tp;
    ent.ee = tp;
    ent.m = reinterpret_cast<unsigned*>(ent.p + SW_KEEP * ent.ce);
    ent.me = tp;
    ent.slot = reinterpret_cast<int*>(s.scr + (SW_KEEP + 1) * ent.ce) +
               (size_t)tg * s.ns + k0;
  } else {
    float* base = reinterpret_cast<float*>(smem + s.wpb * s.width);
    const int nwmax = (s.width + 31) >> 5;
    ent.p = base + (size_t)warp * SW_KEEP * s.width * SLOT_LANES + lane;
    ent.ce = (size_t)s.width * SLOT_LANES;
    ent.ee = SLOT_LANES;
    unsigned* mb = reinterpret_cast<unsigned*>(
        base + (size_t)s.wpb * SW_KEEP * s.width * SLOT_LANES);
    ent.m = mb + (size_t)warp * nwmax * SLOT_LANES + lane;
    ent.me = SLOT_LANES;
    ent.slot = reinterpret_cast<int*>(mb + (size_t)s.wpb * nwmax *
                                               SLOT_LANES) +
               (size_t)warp * s.width;
  }
  unsigned char* live = s.live + (size_t)tg * s.ns;
  float* g = s.g + t;
  const float gs = a.gam * a.sig;

  // each slot's geometry, once, the loads of SLOT_CHUNK slots issued
  // together; the slots some lane takes are kept, each lane marks those
  // it takes and writes 0 as its gradient of the others
  int nk = 0;
  unsigned word = 0u;
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
      if (!any) continue;
      float hx = 0.f, hy = 0.f, hz = 0.f, h = 0.f;
      if (in) {
        const float inv = 1.f / r;
        hx = d.x * inv, hy = d.y * inv, hz = d.z * inv;
        h = expf(gs / (r - a.rc));
        word |= 1u << (nk & 31);
      } else {
        float* gk = g + 3 * (size_t)k * tp;
        gk[0] = 0.f;
        gk[tp] = 0.f;
        gk[2 * tp] = 0.f;
      }
      ent(0, nk) = hx;
      ent(1, nk) = hy;
      ent(2, nk) = hz;
      ent(3, nk) = h;
      ent(4, nk) = r;
      if (lane == 0) ent.slot[nk] = k;
      if ((++nk & 31) == 0) {
        ent.mask((nk >> 5) - 1) = word;
        word = 0u;
      }
    }
  }
  if (nk & 31) ent.mask(nk >> 5) = word;
  const int nw = (nk + 31) >> 5;
  __syncwarp();

  // each entry the lane takes as j, in row order: its pair term and its
  // angular terms against every other entry the lane takes, k in row
  // order (h underflows to 0 near the cutoff: such a k adds nothing);
  // the lane writes its own gradient of the slot
  const float c2 = a.A * a.eps, c3 = a.lam * a.eps;
  float e = 0.f, fx = 0.f, fy = 0.f, fz = 0.f;
  for (int wj = 0; wj < nw; ++wj) {
    for (unsigned bj = ent.mask(wj); bj; bj &= bj - 1u) {
      const int ej = (wj << 5) + __ffs(bj) - 1;
      const float rj = ent(4, ej);
      const float hx = ent(0, ej), hy = ent(1, ej), hz = ent(2, ej),
                  hj = ent(3, ej);
      const float inv = 1.f / rj;
      const float iden = 1.f / (rj - a.rc);
      // two-body
      const float sr = a.sig * inv;
      const float sp = power(sr, a.p, a.pf), sq = power(sr, a.q, a.qf);
      const float t1 = expf(a.sig * iden);
      const float poly = a.B * sp - sq;
      e += 0.5f * c2 * poly * t1;
      float dr = 0.5f * c2 * t1 *
                 (-(a.B * a.pf * sp - a.qf * sq) * inv -
                  (t1 > 0.f ? poly * a.sig * iden * iden : 0.f));
      // three-body
      const float hpj = hj > 0.f ? -hj * gs * iden * iden : 0.f;
      float px = 0.f, py = 0.f, pz = 0.f;
      if (hj > 0.f) {
        for (int wk = 0; wk < nw; ++wk) {
          for (unsigned bk = ent.mask(wk); bk; bk &= bk - 1u) {
            const int ek = (wk << 5) + __ffs(bk) - 1;
            if (ek == ej) continue;
            const float hk = ent(3, ek);
            if (hk == 0.f) continue;
            const float kx = ent(0, ek), ky = ent(1, ek), kz = ent(2, ek);
            const float c = hx * kx + hy * ky + hz * kz;
            const float dc = c - a.cos0;
            e += 0.5f * c3 * dc * dc * hj * hk;
            // along rhat_k, and radial
            const float wk_ = 2.f * c3 * dc * hj * hk * inv;
            px += wk_ * kx;
            py += wk_ * ky;
            pz += wk_ * kz;
            dr += -wk_ * c + c3 * dc * dc * hk * hpj;
          }
        }
      }
      const float gx = dr * hx + px, gy = dr * hy + py, gz = dr * hz + pz;
      float* gk = g + 3 * (size_t)ent.slot[ej] * tp;
      gk[0] = gx;
      gk[tp] = gy;
      gk[2 * tp] = gz;
      // the centre is the slot's tail: pushed along the gradient
      fx += gx;
      fy += gy;
      fz += gz;
    }
  }
  float* ft = s.ftail + 3 * (size_t)i * tp + t;
  ft[0] = fx;
  ft[tp] = fy;
  ft[2 * tp] = fz;
  s.ecen[(size_t)i * tp + t] = e;
}

// shared memory of a staged block per warp: the rows' records, the
// lanes' kept entries and the entries' slots, per column of the table,
// and the lanes' mask words
#define SW_SMEM_PER_WARP(width)                                  \
  ((size_t)(width) * (16 + 4 * SW_KEEP * SLOT_LANES + 4) +      \
   (size_t)(((width) + 31) >> 5) * 4 * SLOT_LANES)

extern "C" int sw_force_f32(const SwArgs* args, void* stream) {
  static int smem_set = 0;
  const SwArgs& a = *args;
  const SlotArgs& s = a.s;
  if (!slot_args_ok(s) || s.scalar || a.p < -1 || a.p > 16 || a.q < -1 ||
      a.q > 16 ||
      (s.wide && s.ns && !s.scr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = s.wide ? 0 : (size_t)s.wpb * SW_SMEM_PER_WARP(s.width);
  if (smem > SLOT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = slot_transpose_launch(s, st);
  if (rc) return rc;
  dim3 grid((s.na + s.wpb - 1) / s.wpb, s.tp / SLOT_LANES);
  if (s.wide) {
    sw_centre_kernel<true><<<grid, 32 * s.wpb, 0, st>>>(a);
  } else {
    rc = slot_smem_attr((const void*)sw_centre_kernel<false>, (int)smem,
                        &smem_set);
    if (rc) return rc;
    sw_centre_kernel<false><<<grid, 32 * s.wpb, smem, st>>>(a);
  }
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return slot_gather_launch(s, st);
}
