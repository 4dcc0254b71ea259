// The quad lattice's policy for the hand-written kernels: bond indexing,
// the per-bond energy partials, the gather of each DOF's bonds, and the
// guard's travel and gap (see verlet_common.cuh for what a policy
// provides). Shared by the trajectory kernel (verlet_quad.cu: kernels 1,
// 1g, 1L) and the force kernel (quad_force.cu: kernel 2), so that both
// evaluate the same per-bond arithmetic and sum each DOF's bonds in the
// same order.

#pragma once

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
      const int j = p.dn1m.div(q), i = q - j * (n1 - 1);
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
    const int c = p.dnb.div(e), blk = e - c * nb, j = p.dn1.div(blk), ii = blk - j * n1;
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
    const int c = p.dnb.div(e);
    if (c == 2) {
      th = max_nan(th, travel_of(sV[e], sA[e], dt, hdt2));
    } else if (g.has_length_scale) {
      if (!g.relative) {
        tr = max_nan(tr, travel_of(sV[e], sA[e], dt, hdt2));
      } else {
        const int blk = e - c * nb, j = p.dn1.div(blk), ii = blk - j * n1;
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
    const int jh = p.dn1m.div(q);  // the row of a horizontal bond
    const int blk_a = horiz ? jh * n1 + q - jh * (n1 - 1) : q - nh;
    const int blk_b = horiz ? blk_a + 1 : blk_a + n1;
    const T ua[3] = {sU[blk_a], sU[nb + blk_a], sU[2 * nb + blk_a]};
    const T ub[3] = {sU[blk_b], sU[nb + blk_b], sU[2 * nb + blk_b]};
    const Corners<T, 4> ga = load_corners(p, b, blk_a), gb = load_corners(p, b, blk_b);
    return horiz ? bond_gap_of(ua, ga, 0, ub, gb, 2) : bond_gap_of(ua, ga, 1, ub, gb, 3);
  }
};

}  // namespace
