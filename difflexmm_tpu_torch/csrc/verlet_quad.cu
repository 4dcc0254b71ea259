// Quad-lattice velocity-Verlet trajectory kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the fused Pallas trajectory kernel of the JAX package:
// difflexmm_tpu/ops/pallas/core.py:746-833 (build_verlet_trajectory's
// pallas_forward, pallas_call at :822), bound to the quad lattice by
// difflexmm_tpu/ops/pallas/verlet_grid.py:289-331
// (build_pallas_verlet_trajectory -> quad_grid_energy_planes), in its plain
// form: no substep guard, no fused force loading.
//
// What it computes, for each design b of a batch (one thread block each):
// all (T-1) * n_sub velocity-Verlet substeps
//     U1 = U + dt V + dt^2/2 A
//     F  = -mask * dE/dU_eff,   U_eff = U1 * mask + drive(t1)
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
// deterministic. The contact term is evaluated on duals only when one of
// the bond's void angles lies in [min_angle, cutoff): elsewhere it and its
// derivative are zero.
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

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeeds = 6;

template <typename T>
struct Dual {
  T v;
  T d[kSeeds];
};

template <typename T>
__device__ __forceinline__ Dual<T> dconst(T x) {
  Dual<T> r;
  r.v = x;
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = T(0);
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> seeded(T x, int seed) {
  Dual<T> r = dconst(x);
  r.d[seed] = T(1);
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = a.d[q] + b.d[q];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = a.d[q] - b.d[q];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = a.d[q] * b.v + a.v * b.d[q];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = (a.d[q] - r.v * b.d[q]) / b.v;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, T b) {
  Dual<T> r = a;
  r.v = a.v + b;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, const Dual<T>& b) {
  Dual<T> r = b;
  r.v = a + b.v;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, T b) {
  Dual<T> r = a;
  r.v = a.v - b;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, T b) {
  Dual<T> r;
  r.v = a.v * b;
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = a.d[q] * b;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a * b.v;
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = a * b.d[q];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, T b) {
  Dual<T> r;
  r.v = a.v / b;
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = a.d[q] / b;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator/(T a, const Dual<T>& b) {
  return dconst(a) / b;
}

// Elementary functions, overloaded for plain values and duals so that the
// physics below is written once for both.
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }

template <typename T>
__device__ __forceinline__ Dual<T> cos_(const Dual<T>& a) {
  Dual<T> r;
  r.v = cos_(a.v);
  const T ds = -sin_(a.v);
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = ds * a.d[q];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> sin_(const Dual<T>& a) {
  Dual<T> r;
  r.v = sin_(a.v);
  const T dc = cos_(a.v);
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = dc * a.d[q];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> sqrt_(const Dual<T>& a) {
  Dual<T> r;
  r.v = sqrt_(a.v);
  const T h = T(0.5) / r.v;
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = h * a.d[q];
  return r;
}

// d atan2(y, x) = (x dy - y dx) / (x^2 + y^2)
template <typename T>
__device__ __forceinline__ Dual<T> atan2_(const Dual<T>& y, const Dual<T>& x) {
  Dual<T> r;
  r.v = atan2_(y.v, x.v);
  const T inv = T(1) / (x.v * x.v + y.v * y.v);
#pragma unroll
  for (int q = 0; q < kSeeds; ++q) r.d[q] = (x.v * y.d[q] - y.v * x.d[q]) * inv;
  return r;
}

__device__ __forceinline__ float eps_of(float) { return FLT_EPSILON; }
__device__ __forceinline__ double eps_of(double) { return DBL_EPSILON; }

// Rigid-block kinematics of one block: translation and (cos th - 1, sin th).
template <typename N>
struct Block {
  N ux, uy, th, cm1, s;
};

// Block kinematics on duals seeded on its three DOFs (seeds s0, s0+1, s0+2).
template <typename T>
__device__ __forceinline__ Block<Dual<T>> make_block(T ux, T uy, T th, int s0) {
  const Dual<T> t = seeded(th, s0 + 2);
  return Block<Dual<T>>{seeded(ux, s0), seeded(uy, s0 + 1), t, cos_(t) - T(1), sin_(t)};
}

// Corner displacement: u + (R(th) - I) r, as quad_grid_energy_planes writes it.
template <typename N, typename T>
__device__ __forceinline__ void corner_disp(const Block<N>& k, T cx, T cy, N& dx, N& dy) {
  dx = k.ux + k.cm1 * cx - k.s * cy;
  dy = k.uy + k.s * cx + k.cm1 * cy;
}

// Constant geometry of one block: corner vectors and centroid.
template <typename T>
struct Corners {
  T cx[4], cy[4], px, py;
};

// Absolute position of corner c.
template <typename N, typename T>
__device__ __forceinline__ void corner_pos(const Block<N>& k, const Corners<T>& g, int c,
                                           N& x, N& y) {
  N dx, dy;
  corner_disp(k, g.cx[c], g.cy[c], dx, dy);
  x = (g.px + g.cx[c]) + dx;
  y = (g.py + g.cy[c]) + dy;
}

// Signed angle from a to b (verlet_grid._angle).
template <typename N>
__device__ __forceinline__ N angle(const N& ax, const N& ay, const N& bx, const N& by) {
  return atan2_(ax * by - ay * bx, ax * bx + ay * by);
}

// The two void angles at a bond joining corner c1 of block a to corner c2
// of block b (quad_grid_energy_planes.voids).
template <typename N, typename T>
__device__ __forceinline__ void void_angles(const Block<N>& ka, const Corners<T>& ga, int c1,
                                            const Block<N>& kb, const Corners<T>& gb, int c2,
                                            N& void1, N& void2) {
  N a0x, a0y, anx, any, apx, apy, b0x, b0y, bnx, bny, bpx, bpy;
  corner_pos(ka, ga, c1, a0x, a0y);
  corner_pos(ka, ga, (c1 + 1) & 3, anx, any);
  corner_pos(ka, ga, (c1 + 3) & 3, apx, apy);
  corner_pos(kb, gb, c2, b0x, b0y);
  corner_pos(kb, gb, (c2 + 1) & 3, bnx, bny);
  corner_pos(kb, gb, (c2 + 3) & 3, bpx, bpy);
  const N n1x = anx - a0x, n1y = any - a0y;
  const N p1x = apx - a0x, p1y = apy - a0y;
  const N n2x = bnx - b0x, n2y = bny - b0y;
  const N p2x = bpx - b0x, p2y = bpy - b0y;
  void1 = angle(p2x, p2y, n1x, n1y);
  void2 = angle(p1x, p1y, n2x, n2y);
}

// Contact barrier (ops/contact.contact_energy) on one void angle already
// known to lie in [min_angle, cutoff). x is clamped to [-1 + 64 eps, 0]
// before the reciprocals; where the clamp binds, the derivative is zero.
template <typename T>
__device__ __forceinline__ Dual<T> contact_term(const Dual<T>& phi, T cmin, T ccut, T kc) {
  const T span = ccut - cmin;
  const Dual<T> x = (phi - ccut) / span;
  const T lo = T(-1) + T(64) * eps_of(T(0));
  Dual<T> xs = x;
  if (!(x.v > lo && x.v < T(0))) xs = dconst(x.v < lo ? lo : (x.v > T(0) ? T(0) : x.v));
  const T scale = kc / T(4) * (span * span);
  return scale * ((T(1) / (xs + T(1)) - T(1) / (xs - T(1))) - T(2));
}

// Ligament energy of one bond (verlet_grid._ligament_planes).
template <typename T, bool LIN>
__device__ __forceinline__ Dual<T> ligament(const Dual<T>& dUx, const Dual<T>& dUy,
                                            const Dual<T>& th1, const Dual<T>& th2, T refx,
                                            T refy, T ks, T ksh, T kr) {
  const T l0sq = refx * refx + refy * refy;
  const Dual<T> dRot = th2 - th1;
  Dual<T> axial, shear;
  if (LIN) {
    axial = (dUx * refx + dUy * refy) / l0sq;
    shear = (refx * dUy - refy * dUx) / l0sq - (th1 + th2) / T(2);
  } else {
    const Dual<T> rx = dUx + refx;
    const Dual<T> ry = dUy + refy;
    axial = sqrt_((rx * rx + ry * ry) / l0sq) - T(1);
    const Dual<T> mean = (th1 + th2) / T(2);
    const Dual<T> c = cos_(mean), s = sin_(mean);
    const Dual<T> px = c * refx - s * refy;
    const Dual<T> py = s * refx + c * refy;
    shear = atan2_(px * ry - py * rx, px * rx + py * ry);
  }
  return (ks * (axial * axial) * l0sq + ksh * (shear * shear) * l0sq + kr * (dRot * dRot)) /
         T(2);
}

// The resolved guard (core.resolve_guard), thresholds in the working type
// as torch compares them.
template <typename T>
struct Guard {
  T threshold, proximity, hard, length_scale;
  bool has_proximity, has_hard, has_length_scale, relative;
  int refine;
};

template <typename T>
struct Params {
  int B, n1, n2, n_int, n_sub, k_drive;
  const T* U0;
  const T* V0;
  const T* A0;
  const T* dts;
  const T* drive;
  const int* drive_map;
  const T* cnv;
  const T* cen;
  const T* ref_h;
  const T* ref_v;
  const T* ks_h;
  const T* ksh_h;
  const T* kr_h;
  const T* ks_v;
  const T* ksh_v;
  const T* kr_v;
  const T* cmin;
  const T* ccut;
  const T* kc;
  const T* inertia;
  const T* damping;
  const T* mask;
  T* outU;
  T* outV;
  T* outA;
  T* workspace;
  // Guarded only: the micro-step drive table (B, n_int * n_sub * refine,
  // k_drive), the per-substep decisions (B, n_int * n_sub) and the
  // per-interval flags (B, n_int).
  const T* micro;
  unsigned char* decisions;
  unsigned char* flags;
  Guard<T> guard;
};

__host__ __device__ inline size_t scratch_elems(int n1, int n2) {
  const size_t nb = (size_t)n1 * n2;
  const size_t nbond = (size_t)n2 * (n1 - 1) + (size_t)(n2 - 1) * n1;
  return 4 * 3 * nb + kSeeds * nbond;  // U, V, A, U_eff planes + bond partials
}

template <typename T>
__device__ __forceinline__ Corners<T> load_corners(const Params<T>& p, int b, int blk) {
  const int nb = p.n1 * p.n2;
  const T* cnv = p.cnv + (size_t)b * 8 * nb;
  const T* cen = p.cen + (size_t)b * 2 * nb;
  Corners<T> g;
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
__device__ __forceinline__ void bond_partials(const Params<T>& p, int b, int q, const T* sUe,
                                              T* sP) {
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
    ref = p.ref_h + (size_t)b * 2 * nh;
    ks = p.ks_h + (size_t)b * nh;
    ksh = p.ksh_h + (size_t)b * nh;
    kr = p.kr_h + (size_t)b * nh;
  } else {
    r = q - nh;
    blk_a = r;  // (j, i) with r = j * n1 + i
    blk_b = r + n1;
    stride = nv;
    ref = p.ref_v + (size_t)b * 2 * nv;
    ks = p.ks_v + (size_t)b * nv;
    ksh = p.ksh_v + (size_t)b * nv;
    kr = p.kr_v + (size_t)b * nv;
  }
  const Corners<T> ga = load_corners(p, b, blk_a);
  const Corners<T> gb = load_corners(p, b, blk_b);
  const Block<Dual<T>> ka = make_block(sUe[blk_a], sUe[nb + blk_a], sUe[2 * nb + blk_a], 0);
  const Block<Dual<T>> kb = make_block(sUe[blk_b], sUe[nb + blk_b], sUe[2 * nb + blk_b], 3);

  Dual<T> dxa, dya, dxb, dyb;
  corner_disp(ka, ga.cx[c1], ga.cy[c1], dxa, dya);
  corner_disp(kb, gb.cx[c2], gb.cy[c2], dxb, dyb);
  Dual<T> energy = ligament<T, LIN>(dxb - dxa, dyb - dya, ka.th, kb.th, ref[r],
                                    ref[stride + r], ks[r], ksh[r], kr[r]);

  if (CONTACT) {
    const T cmin = p.cmin[b], ccut = p.ccut[b], kc = p.kc[b];
    const Block<T> pa{ka.ux.v, ka.uy.v, ka.th.v, ka.cm1.v, ka.s.v};
    const Block<T> pb{kb.ux.v, kb.uy.v, kb.th.v, kb.cm1.v, kb.s.v};
    T v1, v2;
    void_angles(pa, ga, c1, pb, gb, c2, v1, v2);
    const bool on1 = v1 >= cmin && v1 < ccut;
    const bool on2 = v2 >= cmin && v2 < ccut;
    if (on1 || on2) {
      Dual<T> d1, d2;
      void_angles(ka, ga, c1, kb, gb, c2, d1, d2);
      if (on1) energy = energy + contact_term(d1, cmin, ccut, kc);
      if (on2) energy = energy + contact_term(d2, cmin, ccut, kc);
    }
  }
#pragma unroll
  for (int s = 0; s < kSeeds; ++s) sP[s * nbond + q] = energy.d[s];
}

// One velocity-Verlet (micro-)step of size dt (hdt = dt / 2, hdt2 = dt^2 / 2)
// on the carry S with the drive row drow. With `last`, the new state is also
// written to the interval's outputs at obase.
template <typename T, bool LIN, bool CONTACT>
__device__ __forceinline__ void verlet_step(const Params<T>& p, int b, T dt, T hdt, T hdt2,
                                            const T* drow, T* S, bool last, size_t obase) {
  const int n1 = p.n1, n2 = p.n2, nb = n1 * n2, ne = 3 * nb;
  const int nh = n2 * (n1 - 1), nbond = nh + (n2 - 1) * n1;
  T* sU = S;
  T* sV = S + ne;
  T* sA = S + 2 * ne;
  T* sUe = S + 3 * ne;
  T* sP = S + 4 * ne;
  const size_t off = (size_t)b * ne;
  const T* mask = p.mask + off;
  const T* inertia = p.inertia + off;
  const T* damping = p.damping + off;
  // Position update and the driven, masked state the force sees.
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const T u1 = sU[e] + dt * sV[e] + hdt2 * sA[e];
    sU[e] = u1;
    const int col = p.drive_map[e];
    sUe[e] = u1 * mask[e] + (col >= 0 ? drow[col] : T(0));
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nbond; q += blockDim.x) {
    if (q < nh)
      bond_partials<T, LIN, CONTACT, true>(p, b, q, sUe, sP);
    else
      bond_partials<T, LIN, CONTACT, false>(p, b, q, sUe, sP);
  }
  __syncthreads();
  // Gather each DOF's bonds in a fixed order, then the velocity update.
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const int c = e / nb, blk = e % nb, j = blk / n1, ii = blk % n1;
    T g = T(0);
    if (ii > 0) g += sP[(3 + c) * nbond + j * (n1 - 1) + ii - 1];
    if (ii < n1 - 1) g += sP[c * nbond + j * (n1 - 1) + ii];
    if (j > 0) g += sP[(3 + c) * nbond + nh + blk - n1];
    if (j < n2 - 1) g += sP[c * nbond + nh + blk];
    const T m = mask[e], inert = inertia[e], damp = damping[e];
    const T f = -(m * g);
    const T inv_m = m / inert;
    const T v_hat = sV[e] + hdt * (sA[e] + f * inv_m);
    const T v1 = v_hat / (T(1) + hdt * damp / inert) * m;
    const T a1 = (f - damp * v1) * inv_m;
    sV[e] = v1;
    sA[e] = a1;
    if (last) {
      const size_t o = obase + e;
      p.outU[o] = sU[e];
      p.outV[o] = v1;
      p.outA[o] = a1;
    }
  }
  // No barrier here: the next position update touches only this thread's
  // own elements and sUe, which no thread reads any more.
}

// ---------------------------------------------------------------------------
// The substep guard
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;

// max and min that return NaN when either argument is NaN (jnp.maximum,
// jnp.minimum); fmax and fmin would drop it.
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a < b || a != a) ? a : b;
}

// Block-wide max (MIN = false) or min of every thread's v, NaN when any v
// is NaN. Every thread returns the same value. red holds kWarps values; the
// caller puts a barrier between two uses of the same red.
template <typename T, bool MIN>
__device__ __forceinline__ T block_reduce(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MIN ? min_nan(v, w) : max_nan(v, w);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = MIN ? min_nan(r, red[w]) : max_nan(r, red[w]);
  return r;
}

__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

// |v| dt + dt^2/2 |a| (guard_travel's travel, same order).
template <typename T>
__device__ __forceinline__ T travel_of(T v, T a, T dt, T hdt2) {
  return abs_(v) * dt + hdt2 * abs_(a);
}

// Corner c of a block at the carry's U, as quad_min_void_gap_planes writes
// it: centroid + u + R(th) r.
template <typename T>
__device__ __forceinline__ void gap_corner(T ux, T uy, T cth, T sth, const Corners<T>& g, int c,
                                           T& x, T& y) {
  x = g.px + ux + cth * g.cx[c] - sth * g.cy[c];
  y = g.py + uy + sth * g.cx[c] + cth * g.cy[c];
}

// The smaller of bond q's two void angles at the carry's U (corners and
// bond order as in bond_partials).
template <typename T, bool HORIZ>
__device__ __forceinline__ T bond_gap(const Params<T>& p, int b, int q, const T* sU) {
  const int n1 = p.n1, n2 = p.n2, nb = n1 * n2, nh = n2 * (n1 - 1);
  const int blk_a = HORIZ ? (q / (n1 - 1)) * n1 + q % (n1 - 1) : q - nh;
  const int blk_b = HORIZ ? blk_a + 1 : blk_a + n1;
  constexpr int c1 = HORIZ ? 0 : 1, c2 = HORIZ ? 2 : 3;
  const Corners<T> ga = load_corners(p, b, blk_a);
  const Corners<T> gb = load_corners(p, b, blk_b);
  const T tha = sU[2 * nb + blk_a], thb = sU[2 * nb + blk_b];
  const T ca = cos_(tha), sa = sin_(tha), cb = cos_(thb), sb = sin_(thb);
  const T uxa = sU[blk_a], uya = sU[nb + blk_a], uxb = sU[blk_b], uyb = sU[nb + blk_b];
  T a0x, a0y, anx, any, apx, apy, b0x, b0y, bnx, bny, bpx, bpy;
  gap_corner(uxa, uya, ca, sa, ga, c1, a0x, a0y);
  gap_corner(uxa, uya, ca, sa, ga, (c1 + 1) & 3, anx, any);
  gap_corner(uxa, uya, ca, sa, ga, (c1 + 3) & 3, apx, apy);
  gap_corner(uxb, uyb, cb, sb, gb, c2, b0x, b0y);
  gap_corner(uxb, uyb, cb, sb, gb, (c2 + 1) & 3, bnx, bny);
  gap_corner(uxb, uyb, cb, sb, gb, (c2 + 3) & 3, bpx, bpy);
  const T n1x = anx - a0x, n1y = any - a0y, p1x = apx - a0x, p1y = apy - a0y;
  const T n2x = bnx - b0x, n2y = bny - b0y, p2x = bpx - b0x, p2y = bpy - b0y;
  return min_nan(angle(p2x, p2y, n1x, n1y), angle(p1x, p1y, n2x, n2y));
}

// The guard's risk predicate on the carry for a substep of dt
// (make_risk_predicate). Uniform across the block. red: 3 * kWarps values.
template <typename T, bool CONTACT>
__device__ __forceinline__ bool guard_risky(const Params<T>& p, int b, T dt, T hdt2, const T* S,
                                            T* red) {
  const Guard<T>& g = p.guard;
  const int n1 = p.n1, n2 = p.n2, nb = n1 * n2, ne = 3 * nb;
  const T* sU = S;
  const T* sV = S + ne;
  const T* sA = S + 2 * ne;
  // Travel is >= 0 or NaN, so 0 is the identity of both maxima (and the
  // translational term of a one-block lattice, as in guard_travel).
  T th = T(0), tr = T(0);
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
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
  th = block_reduce<T, false>(th, red);
  T travel = th;
  if (g.has_length_scale) travel = travel + block_reduce<T, false>(tr, red + kWarps) / g.length_scale;
  const bool fast = !(travel <= g.threshold);
  const bool hard = g.has_hard && !(travel <= g.hard);
  if (!g.has_proximity || hard || !fast) return fast || hard;
  // Only here can the gap change the answer.
  T gap = T(INFINITY);
  if (CONTACT && p.kc[b] > T(0)) {
    const int nbond = n2 * (n1 - 1) + (n2 - 1) * n1;
    T m = T(INFINITY);
    const int nh = n2 * (n1 - 1);
    for (int q = threadIdx.x; q < nbond; q += blockDim.x)
      m = min_nan(m, q < nh ? bond_gap<T, true>(p, b, q, sU) : bond_gap<T, false>(p, b, q, sU));
    gap = block_reduce<T, true>(m, red + 2 * kWarps) - p.ccut[b];
  }
  return gap < g.proximity;
}

// The guarded trajectory of design b on the carry S (levels = 1).
template <typename T, bool LIN, bool CONTACT>
__device__ __forceinline__ void guarded_trajectory(const Params<T>& p, int b, T* S) {
  __shared__ T red[3 * kWarps];
  const int ne = 3 * p.n1 * p.n2;
  const int n_steps = p.n_int * p.n_sub;
  const int refine = p.guard.refine;
  for (int k = 0; k < p.n_int; ++k) {
    const T dt = p.dts[k];
    const T hdt = T(0.5) * dt;
    const T hdt2 = T(0.5) * dt * dt;
    const T ddt = dt / T(refine);
    const T mhdt = T(0.5) * ddt;
    const T mhdt2 = T(0.5) * ddt * ddt;
    const size_t obase = ((size_t)b * p.n_int + k) * ne;
    bool fired = false;
    for (int i = 0; i < p.n_sub; ++i) {
      const size_t step = (size_t)b * n_steps + (size_t)k * p.n_sub + i;
      const bool last = i == p.n_sub - 1;
      __syncthreads();  // the predicate reads other threads' carry
      const bool risky = guard_risky<T, CONTACT>(p, b, dt, hdt2, S, red);
      if (!risky) {
        verlet_step<T, LIN, CONTACT>(p, b, dt, hdt, hdt2, p.drive + step * p.k_drive, S, last,
                                     obase);
      } else {
        for (int j = 0; j < refine; ++j)
          verlet_step<T, LIN, CONTACT>(p, b, ddt, mhdt, mhdt2,
                                       p.micro + (step * refine + j) * p.k_drive, S,
                                       last && j == refine - 1, obase);
      }
      if (threadIdx.x == 0) p.decisions[step] = risky;
      fired = fired || risky;
    }
    if (threadIdx.x == 0) p.flags[(size_t)b * p.n_int + k] = fired;
  }
}

template <typename T, bool LIN, bool CONTACT, bool GUARD>
__global__ void __launch_bounds__(kThreads) verlet_quad_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int ne = 3 * p.n1 * p.n2;
  T* S = p.workspace ? p.workspace + (size_t)b * scratch_elems(p.n1, p.n2)
                     : reinterpret_cast<T*>(smem_raw);
  const size_t off = (size_t)b * ne;
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    S[e] = p.U0[off + e];
    S[ne + e] = p.V0[off + e];
    S[2 * ne + e] = p.A0[off + e];
  }

  if constexpr (GUARD) {
    guarded_trajectory<T, LIN, CONTACT>(p, b, S);
  } else {
    const int n_steps = p.n_int * p.n_sub;
    for (int k = 0; k < p.n_int; ++k) {
      const T dt = p.dts[k];
      const T hdt = T(0.5) * dt;
      const T hdt2 = T(0.5) * dt * dt;
      const size_t obase = ((size_t)b * p.n_int + k) * ne;
      for (int i = 0; i < p.n_sub; ++i)
        verlet_step<T, LIN, CONTACT>(
            p, b, dt, hdt, hdt2,
            p.drive + ((size_t)b * n_steps + (size_t)k * p.n_sub + i) * p.k_drive, S,
            i == p.n_sub - 1, obase);
    }
  }
}

template <typename T, bool LIN, bool CONTACT, bool GUARD>
cudaError_t launch_typed(const Params<T>& p, cudaStream_t stream) {
  size_t smem = 0;
  if (!p.workspace) {
    smem = scratch_elems(p.n1, p.n2) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(verlet_quad_kernel<T, LIN, CONTACT, GUARD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  verlet_quad_kernel<T, LIN, CONTACT, GUARD><<<p.B, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool LIN, bool CONTACT>
cudaError_t launch_guarded(const Params<T>& p, bool guard, cudaStream_t stream) {
  return guard ? launch_typed<T, LIN, CONTACT, true>(p, stream)
               : launch_typed<T, LIN, CONTACT, false>(p, stream);
}

template <typename T>
cudaError_t launch(const void* const* ptrs, const int* dims, int linearized, int use_contact,
                   const double* guard, cudaStream_t stream) {
  Params<T> p;
  p.B = dims[0];
  p.n1 = dims[1];
  p.n2 = dims[2];
  p.n_int = dims[3];
  p.n_sub = dims[4];
  p.k_drive = dims[5];
  const T* const* f = reinterpret_cast<const T* const*>(ptrs);
  p.U0 = f[0];
  p.V0 = f[1];
  p.A0 = f[2];
  p.dts = f[3];
  p.drive = f[4];
  p.drive_map = reinterpret_cast<const int*>(ptrs[5]);
  p.cnv = f[6];
  p.cen = f[7];
  p.ref_h = f[8];
  p.ref_v = f[9];
  p.ks_h = f[10];
  p.ksh_h = f[11];
  p.kr_h = f[12];
  p.ks_v = f[13];
  p.ksh_v = f[14];
  p.kr_v = f[15];
  p.cmin = f[16];
  p.ccut = f[17];
  p.kc = f[18];
  p.inertia = f[19];
  p.damping = f[20];
  p.mask = f[21];
  p.outU = const_cast<T*>(f[22]);
  p.outV = const_cast<T*>(f[23]);
  p.outA = const_cast<T*>(f[24]);
  p.workspace = const_cast<T*>(f[25]);
  p.micro = nullptr;
  p.decisions = nullptr;
  p.flags = nullptr;
  p.guard = Guard<T>{};
  if (p.B <= 0 || p.n1 <= 0 || p.n2 <= 0 || p.n_int <= 0 || p.n_sub <= 0 || p.k_drive <= 0)
    return cudaErrorInvalidValue;
  if (guard) {
    p.micro = f[26];
    p.decisions = reinterpret_cast<unsigned char*>(const_cast<void*>(ptrs[27]));
    p.flags = reinterpret_cast<unsigned char*>(const_cast<void*>(ptrs[28]));
    Guard<T>& g = p.guard;
    g.threshold = T(guard[0]);
    g.has_proximity = guard[1] != 0.0;
    g.proximity = T(guard[2]);
    g.has_hard = guard[3] != 0.0;
    g.hard = T(guard[4]);
    g.has_length_scale = guard[5] != 0.0;
    g.length_scale = T(guard[6]);
    g.refine = (int)guard[7];
    g.relative = guard[8] != 0.0;
    if (!p.micro || !p.decisions || !p.flags || g.refine < 2) return cudaErrorInvalidValue;
  }
  const bool guarded = guard != nullptr;
  if (linearized) {
    return use_contact ? launch_guarded<T, true, true>(p, guarded, stream)
                       : launch_guarded<T, true, false>(p, guarded, stream);
  }
  return use_contact ? launch_guarded<T, false, true>(p, guarded, stream)
                     : launch_guarded<T, false, false>(p, guarded, stream);
}

}  // namespace

extern "C" {

// Bytes of carry one design needs (shared memory, or workspace when it
// does not fit).
long long verlet_quad_scratch_bytes(int n1, int n2, int dtype_bytes) {
  return (long long)(scratch_elems(n1, n2) * (size_t)dtype_bytes);
}

// Largest dynamic shared memory one block of the current device may use
// beside the guarded kernel's static reduction buffer, or -1 on error.
long long verlet_quad_max_smem(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes - 3 * kWarps * (long long)sizeof(double);
}

// ptrs: U0, V0, A0, dts, drive, drive_map, cnv, cen, ref_h, ref_v, ks_h,
//       ksh_h, kr_h, ks_v, ksh_v, kr_v, cmin, ccut, kc, inertia, damping,
//       mask, outU, outV, outA, workspace (NULL: carry in shared memory),
//       and when guarded: micro, decisions, flags.
// dims: B, n1, n2, n_int, n_sub, k_drive.
// guard: NULL (unguarded) or threshold, has_proximity, proximity, has_hard,
//        hard, has_length_scale, length_scale, refine, relative.
// Returns the launch's cudaError_t (0 on success).
int verlet_quad_launch(const void* const* ptrs, const int* dims, int dtype_bytes,
                       int linearized, int use_contact, const double* guard, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4)
    return (int)launch<float>(ptrs, dims, linearized, use_contact, guard, s);
  if (dtype_bytes == 8)
    return (int)launch<double>(ptrs, dims, linearized, use_contact, guard, s);
  return (int)cudaErrorInvalidValue;
}

const char* verlet_quad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
