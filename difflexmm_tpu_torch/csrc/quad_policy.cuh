// The quad lattice's policy for the hand-written kernels: bond indexing,
// the per-bond energy partials, the gather of each DOF's bonds, and the
// guard's travel and gap (see verlet_common.cuh for what a policy
// provides). Shared by the trajectory kernel (verlet_quad.cu: kernels 1,
// 1g, 1L) and the force kernel (quad_force.cu: kernel 2), so that both
// evaluate the same per-bond arithmetic and sum each DOF's bonds in the
// same order.
//
// A bond's six partials are taken in closed form. Its energy reaches the
// six DOFs of its two blocks a (seeds 0-2) and b (3-5) through four
// quantities: the relative displacement (dUx, dUy) of the two corners it
// joins and the rotations th1 = th_a, th2 = th_b. A corner's displacement
// is u + (R(th) - I) c, whose th-derivative is e = R'(th) c = (-sin th cx
// - cos th cy, cos th cx - sin th cy). With (gx, gy, g1, g2) = dE/d(dUx,
// dUy, th1, th2) (ligament_grad), the partials are
//     a: (-gx, -gy, g1 - (gx exa + gy eya))
//     b: ( gx,  gy, g2 + (gx exb + gy eyb)).
// Each void angle lies between an edge of block a and an edge of block b;
// an edge moves with its block, so a void angle is its rest value plus or
// minus (th_a - th_b), which is also how it is evaluated: void 1 (b's
// previous edge to a's next edge) is rest + th_a - th_b, with partials +1
// on th_a and -1 on th_b, void 2 (a's previous edge to b's next edge) rest
// - th_a + th_b. An engaged void adds the barrier's slope (barrier_slope)
// with those signs. That is a plain-value forward pass and a scalar
// reverse sweep, in place of seven-wide forward-mode duals.

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
  static constexpr int kRest = 0;  // the void angles at rest are taken each substep
  // The unguarded block (measured on the H100, PERF.md §6): while each
  // design has an SM of its own, a thread per bond of the flagship at
  // float32 (768 threads, a cap of 80 registers) and 512 at float64 (a cap
  // of 128; it spills at 768); beyond, two blocks an SM (float32 of 512,
  // float64 of 384).
  template <typename T>
  struct Unguarded {
    static constexpr int kFew = sizeof(T) == 8 ? 512 : 768;
    static constexpr int kMany = sizeof(T) == 8 ? 384 : 512;
    static constexpr int kManyBlocks = 2;
  };
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

  // The six partials of the bond joining corner c1 of block blk_a to corner
  // c2 of block blk_b (bond r of its family: HORIZ, horizontal bonds
  // (j,i)-(j,i+1) with corners 0 and 2; else vertical bonds (j,i)-(j+1,i)
  // with corners 1 and 3) at the driven state sUe, into out[s * stride].
  // HORIZ is a template argument so that the corner indices are constants.
  template <typename T, bool LIN, bool CONTACT, bool HORIZ>
  __device__ static void bond_term(const Params<T, kLeaves>& p, int b, int blk_a, int r,
                                   const T* sUe, T* out, int stride) {
    const int n1 = p.n1, n2 = p.n2, nb = n1 * n2;
    constexpr int c1 = HORIZ ? 0 : 1;  // corner of block a at the bond
    constexpr int c2 = HORIZ ? 2 : 3;  // corner of block b
    const int blk_b = HORIZ ? blk_a + 1 : blk_a + n1;
    const size_t nf = HORIZ ? (size_t)n2 * (n1 - 1) : (size_t)(n2 - 1) * n1;
    const size_t base = (size_t)b * nf + r;
    const T* ref = p.leaf[HORIZ ? kRefH : kRefV] + (size_t)b * 2 * nf + r;
    const T* cnv = p.leaf[kCnv] + (size_t)b * 8 * nb;
    const T uxa = sUe[blk_a], uya = sUe[nb + blk_a], tha = sUe[2 * nb + blk_a];
    const T uxb = sUe[blk_b], uyb = sUe[nb + blk_b], thb = sUe[2 * nb + blk_b];
    const T cxa = cnv[2 * c1 * nb + blk_a], cya = cnv[(2 * c1 + 1) * nb + blk_a];
    const T cxb = cnv[2 * c2 * nb + blk_b], cyb = cnv[(2 * c2 + 1) * nb + blk_b];
    const T sa = sin_(tha), ca = cos_(tha), sb = sin_(thb), cb = cos_(thb);
    const T dxa = uxa + (ca - T(1)) * cxa - sa * cya;
    const T dya = uya + sa * cxa + (ca - T(1)) * cya;
    const T dxb = uxb + (cb - T(1)) * cxb - sb * cyb;
    const T dyb = uyb + sb * cxb + (cb - T(1)) * cyb;
    T gx, gy, ta, tb;
    ligament_grad<T, LIN>(dxb - dxa, dyb - dya, tha, thb, ref[0], ref[nf],
                          p.leaf[HORIZ ? kKsH : kKsV][base], p.leaf[HORIZ ? kKshH : kKshV][base],
                          p.leaf[HORIZ ? kKrH : kKrV][base], gx, gy, ta, tb);
    ta -= gx * (-sa * cxa - ca * cya) + gy * (ca * cxa - sa * cya);
    tb += gx * (-sb * cxb - cb * cyb) + gy * (cb * cxb - sb * cyb);
    if (CONTACT) {
      // The void angles: each the angle between the two edges at rest plus
      // (th_a - th_b) or (th_b - th_a), taken into atan2's range
      // (wrap_angle). The barrier acts only on a void angle in [cmin, ccut).
      constexpr int n1c = (c1 + 1) % 4, p1c = (c1 + 3) % 4;  // a's next, previous corner
      constexpr int n2c = (c2 + 1) % 4, p2c = (c2 + 3) % 4;  // b's
      const T* ga = cnv + blk_a;
      const T* gb = cnv + blk_b;
      const T v1 = wrap_angle(angle(gb[2 * p2c * nb] - cxb, gb[(2 * p2c + 1) * nb] - cyb,
                                    ga[2 * n1c * nb] - cxa, ga[(2 * n1c + 1) * nb] - cya) +
                              (tha - thb));
      const T v2 = wrap_angle(angle(ga[2 * p1c * nb] - cxa, ga[(2 * p1c + 1) * nb] - cya,
                                    gb[2 * n2c * nb] - cxb, gb[(2 * n2c + 1) * nb] - cyb) +
                              (thb - tha));
      const T cmin = p.leaf[kCmin][b], ccut = p.leaf[kCmin + 1][b];
      if (v1 >= cmin && v1 < ccut) {
        const T d = barrier_slope(v1, cmin, ccut, p.leaf[kCmin + 2][b]);
        ta += d;
        tb -= d;
      }
      if (v2 >= cmin && v2 < ccut) {
        const T d = barrier_slope(v2, cmin, ccut, p.leaf[kCmin + 2][b]);
        ta -= d;
        tb += d;
      }
    }
    out[0] = -gx;
    out[stride] = -gy;
    out[2 * stride] = ta;
    out[3 * stride] = gx;
    out[4 * stride] = gy;
    out[5 * stride] = tb;
  }

  // Bond q's six partials in sP (SoA: sP[s * nbond + q]).
  template <typename T, bool LIN, bool CONTACT>
  __device__ static void bond_partials(const Params<T, kLeaves>& p, int b, int q, const T* sUe,
                                       T* sP) {
    const int n1 = p.n1, nh = p.n2 * (n1 - 1), nbond = nh + (p.n2 - 1) * n1;
    if (q < nh) {
      const int j = p.dn1m.div(q);
      bond_term<T, LIN, CONTACT, true>(p, b, q + j, q, sUe, sP + q, nbond);  // blk_a = j n1 + i
    } else {
      bond_term<T, LIN, CONTACT, false>(p, b, q - nh, q - nh, sUe, sP + q, nbond);
    }
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
  // bond order as in bond_partials; quad_min_void_gap_planes).
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
