// Kagome-lattice velocity-Verlet trajectory kernel for NVIDIA Hopper
// (sm_90a).
//
// Replaces the fused Pallas trajectory kernel of the JAX package bound to
// the kagome lattice: difflexmm_tpu/ops/pallas/core.py:746-833
// (build_verlet_trajectory's pallas_forward, pallas_call at :822) through
// difflexmm_tpu/ops/pallas/verlet_kagome.py:336-375
// (build_pallas_kagome_trajectory -> kagome_grid_energy_planes, :127-242),
// unguarded (GUARD = false) and guarded (GUARD = true: core.py:330-625 with
// theta in plane channels 2 and 5, and the kagome gap function
// kagome_min_void_gap_planes, verlet_kagome.py:245-308), with or without
// fused force loading (core.py:129-181; the scatter verlet_kagome.py:81-95
// with combine="add": triangle t's DOF d of a cell is channel 3 t + d). No
// design-tiled layout: on the GPU the design batch is the grid.
//
// The lattice: (n2, n1) cells, each with a "down" triangle (block 2 * cell)
// and an "up" triangle (block 2 * cell + 1). The state is six planes
// (ux_d, uy_d, th_d, ux_u, uy_u, th_u) of (n2, n1). Three bond families,
// each joining a corner of a down triangle to a corner of an up triangle:
//     internal   (n2, n1):     down corner 1 of (j, i)   - up corner 0 of (j, i)
//     boundary-1 (n2-1, n1):   down corner 0 of (j+1, i) - up corner 2 of (j, i)
//     boundary-2 (n2, n1-1):   down corner 2 of (j, i+1) - up corner 1 of (j, i)
// in that order (bond q = internal cells, then boundary-1, then boundary-2,
// each n1-fastest). Each bond's energy is the ligament on up - down (theta_1
// the down triangle's, theta_2 the up's) plus the contact barrier on its
// two void angles, whose corners are (c + 1) mod 3 and (c + 2) mod 3.
//
// What it computes and what bounds it are as for the quad kernel
// (csrc/verlet_quad.cu): all (T-1) * n_sub dependent substeps of one design
// in one thread block, the carry (U, V, A, U_eff, 6 partials and the 2
// void angles at rest per bond; 48 KB at float32 and 96 KB at float64 for
// 16 x 16 cells) in shared memory, a global workspace beyond. It is
// latency-bound: two block-wide barriers a substep separate a few hundred
// operations per thread. The force: each bond's six partials with respect
// to the DOFs of its two triangles are taken in closed form, as the quad
// policy takes them (quad_policy.cuh): a triangle's corner moves as u +
// (R(th) - I) c, and a void angle is its rest angle plus or minus (th_down
// - th_up), so a plain-value pass and a scalar reverse sweep give them. The
// void angles at rest are taken once a launch (rest_angles); the barrier's
// slope only where a void angle lies in [min_angle, cutoff). Each (DOF,
// triangle) thread then sums its <= 3 bonds, one per corner, in a fixed
// order, without atomics.
//
// The guarded kernel's predicate and its larger block are as for the quad
// kernel.
//
// The guard's travel is the max over channels 2 and 5; with length_scale,
// plus the max over neighbour differences of channels 0, 1, 3 and 4 along
// n1 and n2 and over the within-cell pairs (0, 3) and (1, 4), divided by
// length_scale (core.guard_travel). The gap corner is centroid + u + R r on
// the carry's free U, as JAX writes it (the energy's corner is centroid + r
// + d on U_eff).
//
// Everything that does not depend on the lattice is in verlet_common.cuh.

#include "verlet_common.cuh"

namespace {

using namespace verlet;

// Fixed leaves, in order, each with the design batch leading: cnv
// (B,2,3,2,n2,n1) [triangle, corner, component], cen (B,2,2,n2,n1)
// [triangle, component], ref_i (B,2,n2,n1), ref_b1 (B,2,n2-1,n1), ref_b2
// (B,2,n2,n1-1), ks_i, ksh_i, kr_i (B,n2,n1), ks_b1, ksh_b1, kr_b1
// (B,n2-1,n1), ks_b2, ksh_b2, kr_b2 (B,n2,n1-1), cmin, ccut, kc (B,1,1),
// inertia, damping, mask (B,6,n2,n1).
struct Kagome {
  static constexpr int kC = 6;
  static constexpr int kLeaves = 20;
  static constexpr int kCmin = 14;
  static constexpr int kRest = 2;
  // The unguarded block (measured on the H100, PERF.md §6): while each
  // design has an SM of its own, a thread per bond of the configuration
  // (768 threads for its 736 bonds, a cap of 80 registers; float64 spills a
  // little and still beats 512 threads); beyond, two blocks of 512 an SM,
  // at either type. A block sized to a smaller lattice's bonds (352 threads
  // for the 12 x 10 population) was slower than 768.
  template <typename T>
  struct Unguarded {
    static constexpr int kFew = 768;
    static constexpr int kMany = 512;
    static constexpr int kManyBlocks = 2;
  };
  enum { kCnv = 0, kCen, kRefI, kRefB1, kRefB2, kKsI };

  __host__ __device__ static int nbond(int n1, int n2) {
    return n1 * n2 + (n2 - 1) * n1 + n2 * (n1 - 1);
  }

  // Corner vectors and centroid of triangle tri (0 down, 1 up) of a cell.
  template <typename T>
  __device__ static Corners<T, 3> load_corners(const Params<T, kLeaves>& p, int b, int tri,
                                               int cell) {
    const int nb = p.n1 * p.n2;
    const T* cnv = p.leaf[kCnv] + (size_t)b * 12 * nb + (size_t)tri * 6 * nb;
    const T* cen = p.leaf[kCen] + (size_t)b * 4 * nb + (size_t)tri * 2 * nb;
    Corners<T, 3> g;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g.cx[c] = cnv[(2 * c) * nb + cell];
      g.cy[c] = cnv[(2 * c + 1) * nb + cell];
    }
    g.px = cen[cell];
    g.py = cen[nb + cell];
    return g;
  }

  // The corners a bond of family F (0 internal, 1 boundary-1, 2
  // boundary-2) joins: cd of the down triangle, cu of the up triangle.
  template <int F>
  struct Family {
    static constexpr int cd = F == 0 ? 1 : (F == 1 ? 0 : 2);
    static constexpr int cu = F == 0 ? 0 : (F == 1 ? 2 : 1);
  };

  // Design b's corner-vector planes of triangle tri (0 down, 1 up) at a
  // cell: component k of corner c at [(2 c + k) * n1 * n2].
  template <typename T>
  __device__ static const T* corner_planes(const Params<T, kLeaves>& p, int b, int tri,
                                           int cell) {
    const size_t nb = (size_t)p.n1 * p.n2;
    return p.leaf[kCnv] + b * 12 * nb + tri * 6 * nb + cell;
  }

  // The two void angles at rest of the bond of family F joining the down
  // triangle of cell_d to the up triangle of cell_u, into out[0] and
  // out[stride]: void 1 from the up triangle's previous edge to the down
  // triangle's next edge, void 2 from the down triangle's previous edge to
  // the up triangle's next edge (the corners (c + 1) mod 3 and (c + 2) mod 3
  // of each, as the plane energy's `voids`).
  template <typename T, int F>
  __device__ static void rest_voids(const Params<T, kLeaves>& p, int b, int cell_d, int cell_u,
                                    T* out, int stride) {
    const int nb = p.n1 * p.n2;
    constexpr int cd = Family<F>::cd, nd = (cd + 1) % 3, pd = (cd + 2) % 3;
    constexpr int cu = Family<F>::cu, nu = (cu + 1) % 3, pu = (cu + 2) % 3;
    const T* gd = corner_planes(p, b, 0, cell_d);
    const T* gu = corner_planes(p, b, 1, cell_u);
    const T cxa = gd[2 * cd * nb], cya = gd[(2 * cd + 1) * nb];
    const T cxb = gu[2 * cu * nb], cyb = gu[(2 * cu + 1) * nb];
    out[0] = angle(gu[2 * pu * nb] - cxb, gu[(2 * pu + 1) * nb] - cyb, gd[2 * nd * nb] - cxa,
                   gd[(2 * nd + 1) * nb] - cya);
    out[stride] = angle(gd[2 * pd * nb] - cxa, gd[(2 * pd + 1) * nb] - cya,
                        gu[2 * nu * nb] - cxb, gu[(2 * nu + 1) * nb] - cyb);
  }

  // The six partials of bond r of family F, joining the down triangle of
  // cell_d (seeds 0-2) to the up triangle of cell_u (seeds 3-5), at the
  // driven state sUe, into out[s * stride]; its void angles at rest in
  // rest[0] and rest[stride]. Quad::bond_term's closed form
  // (quad_policy.cuh) on triangles. F is a template argument so that the
  // corner indices are constants.
  template <typename T, bool LIN, bool CONTACT, int F>
  __device__ static void bond_term(const Params<T, kLeaves>& p, int b, int cell_d, int cell_u,
                                   int r, const T* sUe, const T* rest, T* out, int stride) {
    const int n1 = p.n1, n2 = p.n2, nb = n1 * n2;
    constexpr int cd = Family<F>::cd, cu = Family<F>::cu;
    const size_t nf =
        F == 0 ? (size_t)nb : (F == 1 ? (size_t)(n2 - 1) * n1 : (size_t)n2 * (n1 - 1));
    const size_t base = (size_t)b * nf + r;
    const T* ref = p.leaf[kRefI + F] + (size_t)b * 2 * nf + r;
    const T* gd = corner_planes(p, b, 0, cell_d);
    const T* gu = corner_planes(p, b, 1, cell_u);
    const T uxa = sUe[cell_d], uya = sUe[nb + cell_d], tha = sUe[2 * nb + cell_d];
    const T uxb = sUe[3 * nb + cell_u], uyb = sUe[4 * nb + cell_u], thb = sUe[5 * nb + cell_u];
    const T cxa = gd[2 * cd * nb], cya = gd[(2 * cd + 1) * nb];
    const T cxb = gu[2 * cu * nb], cyb = gu[(2 * cu + 1) * nb];
    const T sa = sin_(tha), ca = cos_(tha), sb = sin_(thb), cb = cos_(thb);
    const T dxa = uxa + (ca - T(1)) * cxa - sa * cya;
    const T dya = uya + sa * cxa + (ca - T(1)) * cya;
    const T dxb = uxb + (cb - T(1)) * cxb - sb * cyb;
    const T dyb = uyb + sb * cxb + (cb - T(1)) * cyb;
    T gx, gy, ta, tb;
    ligament_grad<T, LIN>(dxb - dxa, dyb - dya, tha, thb, ref[0], ref[nf],
                          p.leaf[kKsI + 3 * F][base], p.leaf[kKsI + 3 * F + 1][base],
                          p.leaf[kKsI + 3 * F + 2][base], gx, gy, ta, tb);
    ta -= gx * (-sa * cxa - ca * cya) + gy * (ca * cxa - sa * cya);
    tb += gx * (-sb * cxb - cb * cyb) + gy * (cb * cxb - sb * cyb);
    if (CONTACT) {
      // A void angle is its rest angle plus (th_d - th_u) (void 1) or
      // (th_u - th_d) (void 2), taken into atan2's range (wrap_angle). The
      // barrier acts only on a void angle in [cmin, ccut).
      const T v1 = wrap_angle(rest[0] + (tha - thb));
      const T v2 = wrap_angle(rest[stride] + (thb - tha));
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

  // Bond q's two void angles at rest into sR[q] and sR[nbond + q], once a
  // launch.
  template <typename T>
  __device__ static void rest_angles(const Params<T, kLeaves>& p, int b, int q, T* sR) {
    const int n1 = p.n1, nb = n1 * p.n2, nb1 = (p.n2 - 1) * n1;
    const int nbond = nb + nb1 + p.n2 * (n1 - 1);
    if (q < nb) {
      rest_voids<T, 0>(p, b, q, q, sR + q, nbond);
    } else if (q < nb + nb1) {
      const int r = q - nb;  // up triangle of (j, i) with r = j * n1 + i, down of (j + 1, i)
      rest_voids<T, 1>(p, b, r + n1, r, sR + q, nbond);
    } else {
      const int r = q - nb - nb1, cell_u = r + r / (n1 - 1);  // (j, i): j * n1 + i
      rest_voids<T, 2>(p, b, cell_u + 1, cell_u, sR + q, nbond);
    }
  }

  // Bond q's six partials in sP (SoA: sP[s * nbond + q]); its rest void
  // angles follow the partials (rest_angles' sR = sP + 6 nbond).
  template <typename T, bool LIN, bool CONTACT>
  __device__ static void bond_partials(const Params<T, kLeaves>& p, int b, int q, const T* sUe,
                                       T* sP) {
    const int n1 = p.n1, nb = n1 * p.n2, nb1 = (p.n2 - 1) * n1;
    const int nbond = nb + nb1 + p.n2 * (n1 - 1);
    const T* sR = sP + kSeeds * nbond + q;
    if (q < nb) {
      bond_term<T, LIN, CONTACT, 0>(p, b, q, q, q, sUe, sR, sP + q, nbond);
    } else if (q < nb + nb1) {
      const int r = q - nb;
      bond_term<T, LIN, CONTACT, 1>(p, b, r + n1, r, r, sUe, sR, sP + q, nbond);
    } else {
      const int r = q - nb - nb1, cell_u = r + r / (n1 - 1);
      bond_term<T, LIN, CONTACT, 2>(p, b, cell_u + 1, cell_u, r, sUe, sR, sP + q, nbond);
    }
  }

  // Each (DOF, triangle)'s <= 3 bonds, one per corner: internal,
  // boundary-1, boundary-2. A DOF of channel c is seed c of its bonds.
  template <typename T>
  __device__ static T gather(const Params<T, kLeaves>& p, int e, const T* sP) {
    const int n1 = p.n1, n2 = p.n2, nb = n1 * n2;
    const int nb1 = (n2 - 1) * n1, nbond = nb + nb1 + n2 * (n1 - 1);
    const int c = e / nb, cell = e % nb, j = cell / n1, ii = cell % n1;
    const T* P = sP + c * nbond;
    T g = P[cell];
    if (c < 3) {  // down triangle: b1 of (j-1, i), b2 of (j, i-1)
      if (j > 0) g += P[nb + cell - n1];
      if (ii > 0) g += P[nb + nb1 + j * (n1 - 1) + ii - 1];
    } else {  // up triangle: b1 and b2 of (j, i)
      if (j < n2 - 1) g += P[nb + cell];
      if (ii < n1 - 1) g += P[nb + nb1 + j * (n1 - 1) + ii];
    }
    return g;
  }

  // Theta is channels 2 and 5; the translations count through their
  // neighbour differences along n1 and n2 and the within-cell pairs (0, 3)
  // and (1, 4) (or as they are, with translation "absolute").
  template <typename T>
  __device__ static void travel(const Params<T, kLeaves>& p, int e, const T* sV, const T* sA,
                                T dt, T hdt2, T& th, T& tr) {
    const Guard<T>& g = p.guard;
    const int n1 = p.n1, n2 = p.n2, nb = n1 * n2;
    const int c = e / nb;
    if (c == 2 || c == 5) {
      th = max_nan(th, travel_of(sV[e], sA[e], dt, hdt2));
    } else if (g.has_length_scale) {
      if (!g.relative) {
        tr = max_nan(tr, travel_of(sV[e], sA[e], dt, hdt2));
      } else {
        const int cell = e - c * nb, j = cell / n1, ii = cell % n1;
        if (ii < n1 - 1)
          tr = max_nan(tr, travel_of(sV[e + 1] - sV[e], sA[e + 1] - sA[e], dt, hdt2));
        if (j < n2 - 1)
          tr = max_nan(tr, travel_of(sV[e + n1] - sV[e], sA[e + n1] - sA[e], dt, hdt2));
        if (c < 3) {
          const int f = e + 3 * nb;  // the same DOF of the up triangle
          tr = max_nan(tr, travel_of(sV[e] - sV[f], sA[e] - sA[f], dt, hdt2));
        }
      }
    }
  }

  // The smaller of bond q's two void angles at the carry's U.
  template <typename T>
  __device__ static T bond_gap(const Params<T, kLeaves>& p, int b, int q, const T* sU) {
    const int n1 = p.n1, n2 = p.n2, nb = n1 * n2, nb1 = (n2 - 1) * n1;
    int family, cell_u, cell_d;
    if (q < nb) {
      family = 0;
      cell_u = cell_d = q;
    } else if (q < nb + nb1) {
      family = 1;
      cell_u = q - nb;
      cell_d = cell_u + n1;
    } else {
      const int r = q - nb - nb1, j = r / (n1 - 1), i = r % (n1 - 1);
      family = 2;
      cell_u = j * n1 + i;
      cell_d = cell_u + 1;
    }
    const T ud[3] = {sU[cell_d], sU[nb + cell_d], sU[2 * nb + cell_d]};
    const T uu[3] = {sU[3 * nb + cell_u], sU[4 * nb + cell_u], sU[5 * nb + cell_u]};
    const Corners<T, 3> gd = load_corners(p, b, 0, cell_d), gu = load_corners(p, b, 1, cell_u);
    if (family == 0) return bond_gap_of(ud, gd, 1, uu, gu, 0);
    if (family == 1) return bond_gap_of(ud, gd, 0, uu, gu, 2);
    return bond_gap_of(ud, gd, 2, uu, gu, 1);
  }
};

template <typename T, bool LIN, bool CONTACT, bool GUARD, int NT>
__global__ void __launch_bounds__(NT, (min_blocks<Kagome, T, GUARD, NT>()))
    verlet_kagome_kernel(const Params<T, Kagome::kLeaves> p) {
  run_trajectory<Kagome, T, LIN, CONTACT, GUARD, NT>(p);
}

template <typename T, bool GUARD, int NT>
KernelFn<T, Kagome::kLeaves> pick_flags(bool linearized, bool contact) {
  if (linearized)
    return contact ? verlet_kagome_kernel<T, true, true, GUARD, NT>
                   : verlet_kagome_kernel<T, true, false, GUARD, NT>;
  return contact ? verlet_kagome_kernel<T, false, true, GUARD, NT>
                 : verlet_kagome_kernel<T, false, false, GUARD, NT>;
}

// Unguarded in blocks of Kagome::Unguarded<T>::kFew or ::kMany, guarded of
// GuardThreads<T>::kFew or ::kMany; NULL for any other block.
template <typename T>
KernelFn<T, Kagome::kLeaves> pick(bool linearized, bool contact, bool guard, int threads) {
  using G = GuardThreads<T>;
  using U = Kagome::Unguarded<T>;
  if (!guard) {
    if (threads == U::kFew) return pick_flags<T, false, U::kFew>(linearized, contact);
    if (threads == U::kMany) return pick_flags<T, false, U::kMany>(linearized, contact);
    return nullptr;
  }
  if (threads == G::kFew) return pick_flags<T, true, G::kFew>(linearized, contact);
  if (threads == G::kMany) return pick_flags<T, true, G::kMany>(linearized, contact);
  return nullptr;
}

}  // namespace

// ptrs: U0, V0, A0, dts, drive, drive_map, the 20 fixed leaves above, outU,
//       outV, outA, workspace (NULL: carry in shared memory), and when
//       guarded: micro, decisions, flags (verlet::launch).
VERLET_C_INTERFACE(verlet_kagome, Kagome, pick)
