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
// in one thread block, the carry (U, V, A, U_eff and 6 partials per bond;
// 43 KB at float32 and 85 KB at float64 for 16 x 16 cells) in shared
// memory, a global workspace beyond. It is latency-bound: two block-wide
// barriers a substep separate a few hundred operations per thread. The
// force: each bond's energy term is evaluated once on duals seeded on the
// six DOFs of its two triangles; each (DOF, triangle) thread then sums its
// <= 3 bonds, one per corner, in a fixed order, without atomics. The
// barrier's duals run only where a void angle lies in [min_angle, cutoff).
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
  // The unguarded block: 256 threads at any batch and type.
  template <typename T>
  struct Unguarded {
    static constexpr int kFew = 256;
    static constexpr int kMany = 256;
    static constexpr int kManyBlocks = 1;
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

  // Energy term of bond q of family F (0 internal, 1 boundary-1, 2
  // boundary-2) -> its six partials in sP (seeds 0-2: the down triangle,
  // 3-5: the up triangle). F is a template argument so that the corner
  // indices are constants and the corner arrays stay in registers.
  template <typename T, bool LIN, bool CONTACT, int F>
  __device__ static void bond_family(const Params<T, kLeaves>& p, int b, int q, const T* sUe,
                                     T* sP) {
    const int n1 = p.n1, n2 = p.n2, nb = n1 * n2;
    const int nb1 = (n2 - 1) * n1, nb2 = n2 * (n1 - 1), nbond = nb + nb1 + nb2;
    constexpr int cd = F == 0 ? 1 : (F == 1 ? 0 : 2);  // corner of the down triangle
    constexpr int cu = F == 0 ? 0 : (F == 1 ? 2 : 1);  // corner of the up triangle
    int r, cell_u, cell_d;
    size_t count;
    if (F == 0) {
      r = q;
      cell_u = cell_d = r;
      count = nb;
    } else if (F == 1) {
      r = q - nb;
      cell_u = r;  // (j, i) with r = j * n1 + i
      cell_d = r + n1;
      count = nb1;
    } else {
      r = q - nb - nb1;
      const int j = r / (n1 - 1), i = r % (n1 - 1);
      cell_u = j * n1 + i;
      cell_d = cell_u + 1;
      count = nb2;
    }
    const T* ref = p.leaf[kRefI + F] + (size_t)b * 2 * count;
    const T* ks = p.leaf[kKsI + 3 * F] + (size_t)b * count;
    const T* ksh = p.leaf[kKsI + 3 * F + 1] + (size_t)b * count;
    const T* kr = p.leaf[kKsI + 3 * F + 2] + (size_t)b * count;
    const T ud[3] = {sUe[cell_d], sUe[nb + cell_d], sUe[2 * nb + cell_d]};
    const T uu[3] = {sUe[3 * nb + cell_u], sUe[4 * nb + cell_u], sUe[5 * nb + cell_u]};
    const Dual<T> energy = bond_energy<T, LIN, CONTACT>(
        ud, load_corners(p, b, 0, cell_d), cd, uu, load_corners(p, b, 1, cell_u), cu, ref[r],
        ref[count + r], ks[r], ksh[r], kr[r], CONTACT ? p.leaf[kCmin][b] : T(0),
        CONTACT ? p.leaf[kCmin + 1][b] : T(0), CONTACT ? p.leaf[kCmin + 2][b] : T(0));
#pragma unroll
    for (int s = 0; s < kSeeds; ++s) sP[s * nbond + q] = energy.d[s];
  }

  template <typename T, bool LIN, bool CONTACT>
  __device__ static void bond_partials(const Params<T, kLeaves>& p, int b, int q, const T* sUe,
                                       T* sP) {
    const int nb = p.n1 * p.n2, nb1 = (p.n2 - 1) * p.n1;
    if (q < nb)
      bond_family<T, LIN, CONTACT, 0>(p, b, q, sUe, sP);
    else if (q < nb + nb1)
      bond_family<T, LIN, CONTACT, 1>(p, b, q, sUe, sP);
    else
      bond_family<T, LIN, CONTACT, 2>(p, b, q, sUe, sP);
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
__global__ void __launch_bounds__(NT) verlet_kagome_kernel(const Params<T, Kagome::kLeaves> p) {
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

// Unguarded in blocks of Kagome::Unguarded<T>::kFew, guarded of
// GuardThreads<T>::kFew or ::kMany; NULL for any other block.
template <typename T>
KernelFn<T, Kagome::kLeaves> pick(bool linearized, bool contact, bool guard, int threads) {
  using G = GuardThreads<T>;
  using U = Kagome::Unguarded<T>;
  if (!guard)
    return threads == U::kFew ? pick_flags<T, false, U::kFew>(linearized, contact) : nullptr;
  if (threads == G::kFew) return pick_flags<T, true, G::kFew>(linearized, contact);
  if (threads == G::kMany) return pick_flags<T, true, G::kMany>(linearized, contact);
  return nullptr;
}

}  // namespace

// ptrs: U0, V0, A0, dts, drive, drive_map, the 20 fixed leaves above, outU,
//       outV, outA, workspace (NULL: carry in shared memory), and when
//       guarded: micro, decisions, flags (verlet::launch).
VERLET_C_INTERFACE(verlet_kagome, Kagome, pick)
