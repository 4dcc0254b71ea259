// Lattice-independent parts of the hand-written Verlet trajectory kernels
// (csrc/verlet_quad.cu, csrc/verlet_kagome.cu): forward-mode duals and the
// elementary functions on them, the ligament and contact-barrier energies,
// the NaN-propagating block reductions, the velocity-Verlet substep with
// its external loads, the substep guard's predicate and the guarded loop,
// and the launch.
//
// A lattice plugs in with a policy struct L that provides:
//   kC                 channels of the state planes (C, n2, n1)
//   kLeaves            number of per-design fixed leaves; the last three are
//                      the inertia, damping and mask planes (C, n2, n1)
//   kCmin              leaf index of the contact scalars (cmin, ccut, kc)
//   nbond(n1, n2)      number of bonds
//   bond_partials<T, LIN, CONTACT>(p, b, q, sUe, sP)
//                      bond q's energy term, differentiated by forward-mode
//                      duals seeded on the six DOFs of its two blocks, into
//                      sP[s * nbond + q] (seeds 0-2: first block, 3-5:
//                      second)
//   gather(p, e, sP)   dE/dU_eff of state element e: the sum, in a fixed
//                      order, of the partials of the bonds that touch it
//   travel(p, e, sV, sA, dt, hdt2, th, tr)
//                      element e's contribution to the guard's rotational
//                      (th) and translational (tr) travel maxima
//   bond_gap(p, b, q, sU)
//                      the smaller of bond q's two void angles at U
// Every function of a policy is written out for its lattice; what is here
// is the same for all of them.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

namespace verlet {

constexpr int kThreads = 256;
constexpr int kSeeds = 6;
constexpr int kWarps = kThreads / 32;

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
// physics is written once for both.
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
// a + b rounded on its own, never contracted with a product into an FMA
// (the plain body adds the loads to a force it has already rounded).
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

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

// ---------------------------------------------------------------------------
// Rigid-block kinematics and the bond energy
// ---------------------------------------------------------------------------

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

// Corner displacement: u + (R(th) - I) r, as the plane energies write it.
template <typename N, typename T>
__device__ __forceinline__ void corner_disp(const Block<N>& k, T cx, T cy, N& dx, N& dy) {
  dx = k.ux + k.cm1 * cx - k.s * cy;
  dy = k.uy + k.s * cx + k.cm1 * cy;
}

// Constant geometry of one NC-gon block: corner vectors and centroid.
template <typename T, int NC>
struct Corners {
  T cx[NC], cy[NC], px, py;
};

// Absolute position of corner c.
template <typename N, typename T, int NC>
__device__ __forceinline__ void corner_pos(const Block<N>& k, const Corners<T, NC>& g, int c,
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
// of block b: (angle from b's previous edge to a's next edge, angle from
// a's previous edge to b's next edge), as the plane energies' `voids`.
template <typename N, typename T, int NC>
__device__ __forceinline__ void void_angles(const Block<N>& ka, const Corners<T, NC>& ga, int c1,
                                            const Block<N>& kb, const Corners<T, NC>& gb, int c2,
                                            N& void1, N& void2) {
  N a0x, a0y, anx, any, apx, apy, b0x, b0y, bnx, bny, bpx, bpy;
  corner_pos(ka, ga, c1, a0x, a0y);
  corner_pos(ka, ga, (c1 + 1) % NC, anx, any);
  corner_pos(ka, ga, (c1 + NC - 1) % NC, apx, apy);
  corner_pos(kb, gb, c2, b0x, b0y);
  corner_pos(kb, gb, (c2 + 1) % NC, bnx, bny);
  corner_pos(kb, gb, (c2 + NC - 1) % NC, bpx, bpy);
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

// The energy term of one bond joining corner ca of block a (DOF seeds 0-2)
// to corner cb of block b (seeds 3-5): the ligament on the corners'
// relative displacement (b - a, th1 = th_a, th2 = th_b) plus, with
// CONTACT, the barrier on each of its two void angles that lies in
// [cmin, ccut). The barrier's duals run only there. ua/ub: the blocks'
// (ux, uy, th).
template <typename T, bool LIN, bool CONTACT, int NC>
__device__ __forceinline__ Dual<T> bond_energy(const T (&ua)[3], const Corners<T, NC>& ga, int ca,
                                               const T (&ub)[3], const Corners<T, NC>& gb, int cb,
                                               T refx, T refy, T ks, T ksh, T kr, T cmin, T ccut,
                                               T kc) {
  const Block<Dual<T>> ka = make_block(ua[0], ua[1], ua[2], 0);
  const Block<Dual<T>> kb = make_block(ub[0], ub[1], ub[2], 3);
  Dual<T> dxa, dya, dxb, dyb;
  corner_disp(ka, ga.cx[ca], ga.cy[ca], dxa, dya);
  corner_disp(kb, gb.cx[cb], gb.cy[cb], dxb, dyb);
  Dual<T> energy = ligament<T, LIN>(dxb - dxa, dyb - dya, ka.th, kb.th, refx, refy, ks, ksh, kr);
  if (CONTACT) {
    const Block<T> pa{ka.ux.v, ka.uy.v, ka.th.v, ka.cm1.v, ka.s.v};
    const Block<T> pb{kb.ux.v, kb.uy.v, kb.th.v, kb.cm1.v, kb.s.v};
    T v1, v2;
    void_angles(pa, ga, ca, pb, gb, cb, v1, v2);
    const bool on1 = v1 >= cmin && v1 < ccut;
    const bool on2 = v2 >= cmin && v2 < ccut;
    if (on1 || on2) {
      Dual<T> d1, d2;
      void_angles(ka, ga, ca, kb, gb, cb, d1, d2);
      if (on1) energy = energy + contact_term(d1, cmin, ccut, kc);
      if (on2) energy = energy + contact_term(d2, cmin, ccut, kc);
    }
  }
  return energy;
}

// Corner c of a block at the carry's U, as the gap functions write it:
// centroid + u + R(th) r.
template <typename T, int NC>
__device__ __forceinline__ void gap_corner(T ux, T uy, T cth, T sth, const Corners<T, NC>& g,
                                           int c, T& x, T& y) {
  x = g.px + ux + cth * g.cx[c] - sth * g.cy[c];
  y = g.py + uy + sth * g.cx[c] + cth * g.cy[c];
}

// ---------------------------------------------------------------------------
// The substep guard
// ---------------------------------------------------------------------------

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

// The smaller of the two void angles at a bond joining corner ca of block
// a to corner cb of block b, at the carry's U (ua/ub: ux, uy, th).
template <typename T, int NC>
__device__ __forceinline__ T bond_gap_of(const T (&ua)[3], const Corners<T, NC>& ga, int ca,
                                         const T (&ub)[3], const Corners<T, NC>& gb, int cb) {
  const T cos_a = cos_(ua[2]), sin_a = sin_(ua[2]), cos_b = cos_(ub[2]), sin_b = sin_(ub[2]);
  T a0x, a0y, anx, any, apx, apy, b0x, b0y, bnx, bny, bpx, bpy;
  gap_corner(ua[0], ua[1], cos_a, sin_a, ga, ca, a0x, a0y);
  gap_corner(ua[0], ua[1], cos_a, sin_a, ga, (ca + 1) % NC, anx, any);
  gap_corner(ua[0], ua[1], cos_a, sin_a, ga, (ca + NC - 1) % NC, apx, apy);
  gap_corner(ub[0], ub[1], cos_b, sin_b, gb, cb, b0x, b0y);
  gap_corner(ub[0], ub[1], cos_b, sin_b, gb, (cb + 1) % NC, bnx, bny);
  gap_corner(ub[0], ub[1], cos_b, sin_b, gb, (cb + NC - 1) % NC, bpx, bpy);
  const T n1x = anx - a0x, n1y = any - a0y, p1x = apx - a0x, p1y = apy - a0y;
  const T n2x = bnx - b0x, n2y = bny - b0y, p2x = bpx - b0x, p2y = bpy - b0y;
  return min_nan(angle(p2x, p2y, n1x, n1y), angle(p1x, p1y, n2x, n2y));
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

// |v| dt + dt^2/2 |a| (guard_travel's travel, same order).
template <typename T>
__device__ __forceinline__ T travel_of(T v, T a, T dt, T hdt2) {
  return abs_(v) * dt + hdt2 * abs_(a);
}

// The resolved guard (core.resolve_guard), thresholds in the working type
// as torch compares them.
template <typename T>
struct Guard {
  T threshold, proximity, hard, length_scale;
  bool has_proximity, has_hard, has_length_scale, relative;
  int refine;
};

// ---------------------------------------------------------------------------
// The trajectory
// ---------------------------------------------------------------------------

// One launch: the batch of B designs, each with N fixed leaves (per-design
// tensors in the wrapper's order, the design batch leading).
template <typename T, int N>
struct Params {
  int B, n1, n2, n_int, n_sub, k_drive, k_load;
  const T* U0;
  const T* V0;
  const T* A0;
  const T* dts;
  const T* drive;
  const int* drive_map;
  const T* leaf[N];
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
  // External loads (k_load > 0 only): the load table (B, n_int * n_sub,
  // k_load) with one column per loaded slot (the wrapper sums the pairs
  // that name one slot), guarded also its micro-step table (B, n_int *
  // n_sub * refine, k_load), and load_map (C, n2, n1): each state element's
  // column, -1 where nothing is loaded.
  const T* load;
  const T* load_micro;
  const int* load_map;
};

// Carry of one design: U, V, A, U_eff planes and the bond partials.
template <typename L>
__host__ __device__ inline size_t scratch_elems(int n1, int n2) {
  return 4 * (size_t)L::kC * n1 * n2 + kSeeds * (size_t)L::nbond(n1, n2);
}

// One velocity-Verlet (micro-)step of size dt (hdt = dt / 2, hdt2 = dt^2 / 2)
// on the carry S with the drive row drow and the load row lrow (read only
// when p.k_load > 0). With `last`, the new state is also written to the
// interval's outputs at obase.
template <typename L, typename T, bool LIN, bool CONTACT>
__device__ __forceinline__ void verlet_step(const Params<T, L::kLeaves>& p, int b, T dt, T hdt,
                                            T hdt2, const T* drow, const T* lrow, T* S, bool last,
                                            size_t obase) {
  const int ne = L::kC * p.n1 * p.n2;
  const int nbond = L::nbond(p.n1, p.n2);
  T* sU = S;
  T* sV = S + ne;
  T* sA = S + 2 * ne;
  T* sUe = S + 3 * ne;
  T* sP = S + 4 * ne;
  const size_t off = (size_t)b * ne;
  const T* mask = p.leaf[L::kLeaves - 1] + off;
  const T* inertia = p.leaf[L::kLeaves - 3] + off;
  const T* damping = p.leaf[L::kLeaves - 2] + off;
  // Position update and the driven, masked state the force sees.
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const T u1 = sU[e] + dt * sV[e] + hdt2 * sA[e];
    sU[e] = u1;
    const int col = p.drive_map[e];
    sUe[e] = u1 * mask[e] + (col >= 0 ? drow[col] : T(0));
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nbond; q += blockDim.x)
    L::template bond_partials<T, LIN, CONTACT>(p, b, q, sUe, sP);
  __syncthreads();
  // Gather each DOF's bonds in a fixed order, add its slot's load (the
  // branch on k_load is the same for the whole launch), then the velocity
  // update. The acceleration's mask makes a load on a constrained DOF inert.
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const T g = L::gather(p, e, sP);
    const T m = mask[e], inert = inertia[e], damp = damping[e];
    T f = -(m * g);
    if (p.k_load > 0) {
      const int col = p.load_map[e];
      if (col >= 0) f = add_rn(f, lrow[col]);
    }
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

// The guard's risk predicate on the carry for a substep of dt
// (make_risk_predicate):
//     risky = (!(travel <= threshold) && gap < proximity) || !(travel <= hard)
// Uniform across the block. red: 3 * kWarps values.
template <typename L, typename T, bool CONTACT>
__device__ __forceinline__ bool guard_risky(const Params<T, L::kLeaves>& p, int b, T dt, T hdt2,
                                            const T* S, T* red) {
  const Guard<T>& g = p.guard;
  const int ne = L::kC * p.n1 * p.n2;
  const T* sU = S;
  const T* sV = S + ne;
  const T* sA = S + 2 * ne;
  // Travel is >= 0 or NaN, so 0 is the identity of both maxima (and the
  // translational term of a lattice with nothing to move against, as in
  // guard_travel).
  T th = T(0), tr = T(0);
  for (int e = threadIdx.x; e < ne; e += blockDim.x) L::travel(p, e, sV, sA, dt, hdt2, th, tr);
  th = block_reduce<T, false>(th, red);
  T travel = th;
  if (g.has_length_scale) travel = travel + block_reduce<T, false>(tr, red + kWarps) / g.length_scale;
  const bool fast = !(travel <= g.threshold);
  const bool hard = g.has_hard && !(travel <= g.hard);
  if (!g.has_proximity || hard || !fast) return fast || hard;
  // Only here can the gap change the answer.
  T gap = T(INFINITY);
  if (CONTACT && p.leaf[L::kCmin + 2][b] > T(0)) {
    const int nbond = L::nbond(p.n1, p.n2);
    T m = T(INFINITY);
    for (int q = threadIdx.x; q < nbond; q += blockDim.x) m = min_nan(m, L::bond_gap(p, b, q, sU));
    gap = block_reduce<T, true>(m, red + 2 * kWarps) - p.leaf[L::kCmin + 1][b];
  }
  return gap < g.proximity;
}

// The guarded trajectory of design b on the carry S (levels = 1).
template <typename L, typename T, bool LIN, bool CONTACT>
__device__ __forceinline__ void guarded_trajectory(const Params<T, L::kLeaves>& p, int b, T* S) {
  __shared__ T red[3 * kWarps];
  const int ne = L::kC * p.n1 * p.n2;
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
      const bool risky = guard_risky<L, T, CONTACT>(p, b, dt, hdt2, S, red);
      if (!risky) {
        verlet_step<L, T, LIN, CONTACT>(p, b, dt, hdt, hdt2, p.drive + step * p.k_drive,
                                        p.load + step * p.k_load, S, last, obase);
      } else {
        for (int j = 0; j < refine; ++j) {
          const size_t micro = step * refine + j;
          verlet_step<L, T, LIN, CONTACT>(p, b, ddt, mhdt, mhdt2, p.micro + micro * p.k_drive,
                                          p.load_micro + micro * p.k_load, S,
                                          last && j == refine - 1, obase);
        }
      }
      if (threadIdx.x == 0) p.decisions[step] = risky;
      fired = fired || risky;
    }
    if (threadIdx.x == 0) p.flags[(size_t)b * p.n_int + k] = fired;
  }
}

// The whole trajectory of design blockIdx.x: the body of each lattice's
// __global__ kernel.
template <typename L, typename T, bool LIN, bool CONTACT, bool GUARD>
__device__ __forceinline__ void run_trajectory(const Params<T, L::kLeaves>& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int ne = L::kC * p.n1 * p.n2;
  T* S = p.workspace ? p.workspace + (size_t)b * scratch_elems<L>(p.n1, p.n2)
                     : reinterpret_cast<T*>(smem_raw);
  const size_t off = (size_t)b * ne;
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    S[e] = p.U0[off + e];
    S[ne + e] = p.V0[off + e];
    S[2 * ne + e] = p.A0[off + e];
  }

  if constexpr (GUARD) {
    guarded_trajectory<L, T, LIN, CONTACT>(p, b, S);
  } else {
    const int n_steps = p.n_int * p.n_sub;
    for (int k = 0; k < p.n_int; ++k) {
      const T dt = p.dts[k];
      const T hdt = T(0.5) * dt;
      const T hdt2 = T(0.5) * dt * dt;
      const size_t obase = ((size_t)b * p.n_int + k) * ne;
      for (int i = 0; i < p.n_sub; ++i) {
        const size_t step = (size_t)b * n_steps + (size_t)k * p.n_sub + i;
        verlet_step<L, T, LIN, CONTACT>(p, b, dt, hdt, hdt2, p.drive + step * p.k_drive,
                                        p.load + step * p.k_load, S, i == p.n_sub - 1, obase);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int N>
using KernelFn = void (*)(const Params<T, N>);

// Launch one instantiation with its carry in dynamic shared memory (or on
// the workspace when the caller gave one).
template <typename L, typename T>
cudaError_t launch_kernel(KernelFn<T, L::kLeaves> kernel, const Params<T, L::kLeaves>& p,
                          cudaStream_t stream) {
  size_t smem = 0;
  if (!p.workspace) {
    smem = scratch_elems<L>(p.n1, p.n2) * sizeof(T);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<p.B, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Unpack the C interface's arguments and launch the instantiation that
// pick(linearized, contact, guarded) returns.
//   ptrs: U0, V0, A0, dts, drive, drive_map, the N fixed leaves, outU, outV,
//         outA, workspace (NULL: carry in shared memory), micro, decisions,
//         flags (guarded; else NULL), load, load_micro (guarded; else NULL),
//         load_map (k_load > 0; else NULL).
//   dims: B, n1, n2, n_int, n_sub, k_drive, k_load.
//   guard: NULL (unguarded) or threshold, has_proximity, proximity,
//          has_hard, hard, has_length_scale, length_scale, refine, relative.
template <typename L, typename T>
cudaError_t launch(const void* const* ptrs, const int* dims, int linearized, int use_contact,
                   const double* guard, cudaStream_t stream,
                   KernelFn<T, L::kLeaves> (*pick)(bool, bool, bool)) {
  constexpr int N = L::kLeaves;
  Params<T, N> p;
  p.B = dims[0];
  p.n1 = dims[1];
  p.n2 = dims[2];
  p.n_int = dims[3];
  p.n_sub = dims[4];
  p.k_drive = dims[5];
  p.k_load = dims[6];
  const T* const* f = reinterpret_cast<const T* const*>(ptrs);
  p.U0 = f[0];
  p.V0 = f[1];
  p.A0 = f[2];
  p.dts = f[3];
  p.drive = f[4];
  p.drive_map = reinterpret_cast<const int*>(ptrs[5]);
  for (int i = 0; i < N; ++i) p.leaf[i] = f[6 + i];
  p.outU = const_cast<T*>(f[N + 6]);
  p.outV = const_cast<T*>(f[N + 7]);
  p.outA = const_cast<T*>(f[N + 8]);
  p.workspace = const_cast<T*>(f[N + 9]);
  p.micro = nullptr;
  p.decisions = nullptr;
  p.flags = nullptr;
  p.guard = Guard<T>{};
  p.load = nullptr;
  p.load_micro = nullptr;
  p.load_map = nullptr;
  if (p.B <= 0 || p.n1 <= 0 || p.n2 <= 0 || p.n_int <= 0 || p.n_sub <= 0 || p.k_drive <= 0 ||
      p.k_load < 0)
    return cudaErrorInvalidValue;
  if (p.k_load > 0) {
    p.load = f[N + 13];
    p.load_micro = f[N + 14];
    p.load_map = reinterpret_cast<const int*>(ptrs[N + 15]);
    if (!p.load || !p.load_map || (guard && !p.load_micro))
      return cudaErrorInvalidValue;
  }
  if (guard) {
    p.micro = f[N + 10];
    p.decisions = reinterpret_cast<unsigned char*>(const_cast<void*>(ptrs[N + 11]));
    p.flags = reinterpret_cast<unsigned char*>(const_cast<void*>(ptrs[N + 12]));
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
  return launch_kernel<L, T>(pick(linearized != 0, use_contact != 0, guard != nullptr), p, stream);
}

// Largest dynamic shared memory one block of the current device may use
// beside the guarded kernel's static reduction buffer, or -1 on error.
inline long long max_dynamic_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes - 3 * kWarps * (long long)sizeof(double);
}

}  // namespace verlet

// The C interface of a lattice's library: PREFIX_scratch_bytes,
// PREFIX_max_smem, PREFIX_launch and PREFIX_error_string. PICK is the
// lattice's template `pick<T>(linearized, contact, guarded)`.
#define VERLET_C_INTERFACE(PREFIX, LATTICE, PICK)                                            \
  extern "C" {                                                                               \
  /* Bytes of carry one design needs (shared memory, or workspace when it */                 \
  /* does not fit). */                                                                       \
  long long PREFIX##_scratch_bytes(int n1, int n2, int dtype_bytes) {                        \
    return (long long)(verlet::scratch_elems<LATTICE>(n1, n2) * (size_t)dtype_bytes);        \
  }                                                                                          \
  long long PREFIX##_max_smem(void) { return verlet::max_dynamic_smem(); }                   \
  /* Returns the launch's cudaError_t (0 on success). */                                     \
  int PREFIX##_launch(const void* const* ptrs, const int* dims, int dtype_bytes,             \
                      int linearized, int use_contact, const double* guard, void* stream) {  \
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);                                 \
    if (dtype_bytes == 4)                                                                    \
      return (int)verlet::launch<LATTICE, float>(ptrs, dims, linearized, use_contact, guard, \
                                                 s, PICK<float>);                            \
    if (dtype_bytes == 8)                                                                    \
      return (int)verlet::launch<LATTICE, double>(ptrs, dims, linearized, use_contact,       \
                                                  guard, s, PICK<double>);                   \
    return (int)cudaErrorInvalidValue;                                                       \
  }                                                                                          \
  const char* PREFIX##_error_string(int err) {                                               \
    return cudaGetErrorString((cudaError_t)err);                                             \
  }                                                                                          \
  }
