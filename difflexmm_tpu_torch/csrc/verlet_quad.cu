// Quad-lattice velocity-Verlet trajectory kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the fused Pallas trajectory kernel of the JAX package:
// difflexmm_tpu/ops/pallas/core.py:746-833 (build_verlet_trajectory's
// pallas_forward, pallas_call at :822), bound to the quad lattice by
// difflexmm_tpu/ops/pallas/verlet_grid.py:289-331
// (build_pallas_verlet_trajectory -> quad_grid_energy_planes), with or
// without fused force loading (core.py:129-181, load_values_fn; the scatter
// verlet_grid.py:68-80 with combine="add").
//
// What it computes, for each design b of a batch (one thread block each):
// all (T-1) * n_sub velocity-Verlet substeps
//     U1 = U + dt V + dt^2/2 A
//     F  = -mask * dE/dU_eff + load(t1),   U_eff = U1 * mask + drive(t1)
//     V1 = (V + dt/2 (A + F/m)) / (1 + dt/2 c/m) * mask
//     A1 = (F - c V1) * mask / m
// with E the quad-grid ligament energy plus the angle-based contact
// barrier, writing the state at every interval boundary to the
// (B, T-1, 3, n2, n1) outputs.
//
// What bounds it on the card: at the flagship size (24 x 16 blocks) it is
// latency-bound. 1,990 substeps depend on each other, and each is a few
// hundred floating-point operations per thread on one SM, separated by two
// block-wide barriers; memory traffic is small (the constants stay in L1).
// The design answers that by keeping the whole carry (U, V, A, U_eff and
// the per-bond partials) in shared memory, looping over every interval and
// substep inside one block (no launch or host round trip per step), and
// putting independent designs on independent SMs (the batch is the grid).
// A lattice whose carry does not fit in shared memory runs the same code
// on a per-design global workspace the caller allocates.
//
// The force is written by hand (CUDA has no jax.grad). Each horizontal
// bond (j,i)-(j,i+1) and vertical bond (j,i)-(j+1,i) owns its energy term:
// the ligament term plus the contact barrier on its two void angles. That
// term depends on exactly the six DOFs of its two blocks, so it is
// evaluated once on forward-mode dual numbers seeded on those six, and its
// six partials go to a per-bond buffer. After a barrier each (DOF, block)
// thread sums its own <= 4 bonds in a fixed order: no atomics, so runs are
// deterministic. External loads enter as the drive does: the wrapper sums
// the pairs that name one slot into one load-table column per slot, and
// each (DOF, block) thread adds its slot's column, read through load_map,
// behind a branch on k_load that is uniform across the launch. The
// contact term is evaluated on duals only when one of the bond's void
// angles lies in [min_angle, cutoff): elsewhere it and its derivative are
// zero.
//
// The guarded variant (GUARD = true) replaces the same call with a substep
// guard (difflexmm_tpu/ops/pallas/core.py:330-625: make_interval_body with
// emit_risk=True, make_guarded_stepper at levels = 1, guard_travel,
// make_risk_predicate; the quad gap function of
// difflexmm_tpu/ops/pallas/verlet_grid.py:201-262). Before each substep the
// block evaluates the risk predicate on its carry (U, V, A):
//     travel = max over theta of |v| dt + dt^2/2 |a|
//              [+ the same over neighbour differences of the x and y planes
//                 along n1 and n2, / length_scale]
//     gap    = min void angle of U - cutoff   (+inf without contact)
//     risky  = (!(travel <= threshold) && gap < proximity)
//              || !(travel <= hard)
// The maxima and the minimum are block-wide reductions that propagate NaN
// as jnp.max does, and the gap is reduced only where it can change the
// answer. The decision is uniform across the block, so every thread takes
// the same branch and the barriers stay legal: a risky substep runs
// `refine` micro-steps of dt / refine with drive rows from the micro-step
// table. Each substep's decision and each interval's "any fired" flag are
// written as bytes. The guard costs two reductions a substep (three near
// the barrier) and, where it fires, refine - 1 extra steps.
//
// What does not depend on the lattice (duals, the ligament and barrier
// energies, the substep, the guard's loop, the launch) is in
// verlet_common.cuh, shared with the kagome kernel; this file holds the
// quad lattice's policy: bond indexing, gather, travel and gap.

#include "verlet_common.cuh"

namespace {

using namespace verlet;

// The quad lattice: state planes (ux, uy, th) of (n2, n1) blocks; bonds
// are the n2 * (n1 - 1) horizontal ones, (j,i)-(j,i+1), then the
// (n2 - 1) * n1 vertical ones, (j,i)-(j+1,i).
//
// Fixed leaves, in order, each with the design batch leading: cnv
// (B,4,2,n2,n1), cen (B,2,n2,n1), ref_h (B,2,n2,n1-1), ref_v (B,2,n2-1,n1),
// ks_h, ksh_h, kr_h (B,n2,n1-1), ks_v, ksh_v, kr_v (B,n2-1,n1), cmin, ccut,
// kc (B,1,1), inertia, damping, mask (B,3,n2,n1).
struct Quad {
  static constexpr int kC = 3;
  static constexpr int kLeaves = 16;
  static constexpr int kCmin = 10;
  enum { kCnv = 0, kCen, kRefH, kRefV, kKsH, kKshH, kKrH, kKsV, kKshV, kKrV };

  __host__ __device__ static int nbond(int n1, int n2) { return n2 * (n1 - 1) + (n2 - 1) * n1; }

  template <typename T>
  __device__ static Corners<T, 4> load_corners(const Params<T, kLeaves>& p, int b, int blk) {
    const int nb = p.n1 * p.n2;
    const T* cnv = p.leaf[kCnv] + (size_t)b * 8 * nb;
    const T* cen = p.leaf[kCen] + (size_t)b * 2 * nb;
    Corners<T, 4> g;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      g.cx[c] = cnv[(2 * c) * nb + blk];
      g.cy[c] = cnv[(2 * c + 1) * nb + blk];
    }
    g.px = cen[blk];
    g.py = cen[nb + blk];
    return g;
  }

  // Energy term of bond q -> its six partials in sP (SoA: sP[r * nbond + q]).
  // HORIZ is a template argument so that the corner indices are constants
  // and the corner arrays stay in registers.
  template <typename T, bool LIN, bool CONTACT, bool HORIZ>
  __device__ static void bond_dir(const Params<T, kLeaves>& p, int b, int q, const T* sUe, T* sP) {
    const int n1 = p.n1, n2 = p.n2, nb = n1 * n2;
    const int nh = n2 * (n1 - 1), nv = (n2 - 1) * n1, nbond = nh + nv;
    constexpr int c1 = HORIZ ? 0 : 1;  // corner of block a at the bond
    constexpr int c2 = HORIZ ? 2 : 3;  // corner of block b
    int blk_a, blk_b, r;
    const T *ref, *ks, *ksh, *kr;
    size_t stride;
    if (HORIZ) {
      const int j = q / (n1 - 1), i = q % (n1 - 1);
      blk_a = j * n1 + i;
      blk_b = blk_a + 1;
      r = q;
      stride = nh;
      ref = p.leaf[kRefH] + (size_t)b * 2 * nh;
      ks = p.leaf[kKsH] + (size_t)b * nh;
      ksh = p.leaf[kKshH] + (size_t)b * nh;
      kr = p.leaf[kKrH] + (size_t)b * nh;
    } else {
      r = q - nh;
      blk_a = r;  // (j, i) with r = j * n1 + i
      blk_b = r + n1;
      stride = nv;
      ref = p.leaf[kRefV] + (size_t)b * 2 * nv;
      ks = p.leaf[kKsV] + (size_t)b * nv;
      ksh = p.leaf[kKshV] + (size_t)b * nv;
      kr = p.leaf[kKrV] + (size_t)b * nv;
    }
    const T ua[3] = {sUe[blk_a], sUe[nb + blk_a], sUe[2 * nb + blk_a]};
    const T ub[3] = {sUe[blk_b], sUe[nb + blk_b], sUe[2 * nb + blk_b]};
    const Dual<T> energy = bond_energy<T, LIN, CONTACT>(
        ua, load_corners(p, b, blk_a), c1, ub, load_corners(p, b, blk_b), c2, ref[r],
        ref[stride + r], ks[r], ksh[r], kr[r], CONTACT ? p.leaf[kCmin][b] : T(0),
        CONTACT ? p.leaf[kCmin + 1][b] : T(0), CONTACT ? p.leaf[kCmin + 2][b] : T(0));
#pragma unroll
    for (int s = 0; s < kSeeds; ++s) sP[s * nbond + q] = energy.d[s];
  }

  template <typename T, bool LIN, bool CONTACT>
  __device__ static void bond_partials(const Params<T, kLeaves>& p, int b, int q, const T* sUe,
                                       T* sP) {
    if (q < p.n2 * (p.n1 - 1))
      bond_dir<T, LIN, CONTACT, true>(p, b, q, sUe, sP);
    else
      bond_dir<T, LIN, CONTACT, false>(p, b, q, sUe, sP);
  }

  // Each DOF's <= 4 bonds: left, right, below, above.
  template <typename T>
  __device__ static T gather(const Params<T, kLeaves>& p, int e, const T* sP) {
    const int n1 = p.n1, n2 = p.n2, nb = n1 * n2;
    const int nh = n2 * (n1 - 1), nbond = nh + (n2 - 1) * n1;
    const int c = e / nb, blk = e % nb, j = blk / n1, ii = blk % n1;
    T g = T(0);
    if (ii > 0) g += sP[(3 + c) * nbond + j * (n1 - 1) + ii - 1];
    if (ii < n1 - 1) g += sP[c * nbond + j * (n1 - 1) + ii];
    if (j > 0) g += sP[(3 + c) * nbond + nh + blk - n1];
    if (j < n2 - 1) g += sP[c * nbond + nh + blk];
    return g;
  }

  // Theta is channel 2; x and y count through their neighbour differences
  // along n1 and n2 (or as they are, with translation "absolute").
  template <typename T>
  __device__ static void travel(const Params<T, kLeaves>& p, int e, const T* sV, const T* sA,
                                T dt, T hdt2, T& th, T& tr) {
    const Guard<T>& g = p.guard;
    const int n1 = p.n1, n2 = p.n2, nb = n1 * n2;
    const int c = e / nb;
    if (c == 2) {
      th = max_nan(th, travel_of(sV[e], sA[e], dt, hdt2));
    } else if (g.has_length_scale) {
      if (!g.relative) {
        tr = max_nan(tr, travel_of(sV[e], sA[e], dt, hdt2));
      } else {
        const int blk = e - c * nb, j = blk / n1, ii = blk % n1;
        if (ii < n1 - 1)
          tr = max_nan(tr, travel_of(sV[e + 1] - sV[e], sA[e + 1] - sA[e], dt, hdt2));
        if (j < n2 - 1)
          tr = max_nan(tr, travel_of(sV[e + n1] - sV[e], sA[e + n1] - sA[e], dt, hdt2));
      }
    }
  }

  // The smaller of bond q's two void angles at the carry's U (corners and
  // bond order as in bond_dir; quad_min_void_gap_planes).
  template <typename T>
  __device__ static T bond_gap(const Params<T, kLeaves>& p, int b, int q, const T* sU) {
    const int n1 = p.n1, n2 = p.n2, nb = n1 * n2, nh = n2 * (n1 - 1);
    const bool horiz = q < nh;
    const int blk_a = horiz ? (q / (n1 - 1)) * n1 + q % (n1 - 1) : q - nh;
    const int blk_b = horiz ? blk_a + 1 : blk_a + n1;
    const T ua[3] = {sU[blk_a], sU[nb + blk_a], sU[2 * nb + blk_a]};
    const T ub[3] = {sU[blk_b], sU[nb + blk_b], sU[2 * nb + blk_b]};
    const Corners<T, 4> ga = load_corners(p, b, blk_a), gb = load_corners(p, b, blk_b);
    return horiz ? bond_gap_of(ua, ga, 0, ub, gb, 2) : bond_gap_of(ua, ga, 1, ub, gb, 3);
  }
};

template <typename T, bool LIN, bool CONTACT, bool GUARD>
__global__ void __launch_bounds__(kThreads) verlet_quad_kernel(const Params<T, Quad::kLeaves> p) {
  run_trajectory<Quad, T, LIN, CONTACT, GUARD>(p);
}

template <typename T>
KernelFn<T, Quad::kLeaves> pick(bool linearized, bool contact, bool guard) {
  if (linearized) {
    if (contact)
      return guard ? verlet_quad_kernel<T, true, true, true> : verlet_quad_kernel<T, true, true, false>;
    return guard ? verlet_quad_kernel<T, true, false, true> : verlet_quad_kernel<T, true, false, false>;
  }
  if (contact)
    return guard ? verlet_quad_kernel<T, false, true, true> : verlet_quad_kernel<T, false, true, false>;
  return guard ? verlet_quad_kernel<T, false, false, true> : verlet_quad_kernel<T, false, false, false>;
}

}  // namespace

// ptrs: U0, V0, A0, dts, drive, drive_map, the 16 fixed leaves above, outU,
//       outV, outA, workspace (NULL: carry in shared memory), and when
//       guarded: micro, decisions, flags (verlet::launch).
VERLET_C_INTERFACE(verlet_quad, Quad, pick)
