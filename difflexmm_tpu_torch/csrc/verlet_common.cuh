// Lattice-independent parts of the hand-written Verlet trajectory kernels
// (csrc/verlet_quad.cu, csrc/verlet_kagome.cu): the elementary functions,
// the closed-form gradients of the ligament and contact-barrier energies
// (each lattice's bond_partials chains them to its blocks' DOFs), the
// NaN-propagating block reductions, the velocity-Verlet substep with its
// external loads, the substep guard's predicate and the guarded loop, and
// the launch.
//
// A lattice plugs in with a policy struct L that provides:
//   kC                 channels of the state planes (C, n2, n1)
//   kLeaves            number of per-design fixed leaves; the last three are
//                      the inertia, damping and mask planes (C, n2, n1)
//   kCmin              leaf index of the contact scalars (cmin, ccut, kc)
//   Unguarded<T>       the unguarded kernel's block (block_threads): kFew
//                      threads while the designs do not outnumber the SMs,
//                      kMany beyond, with kManyBlocks blocks an SM
//                      (min_blocks)
//   kRest              values a bond keeps from the start of a launch (its
//                      void angles at rest), after the partials: 0 or more
//   nbond(n1, n2)      number of bonds
//   rest_angles<T>(p, b, q, sR)
//                      (kRest > 0) bond q's kRest values into
//                      sR[k * nbond + q], once a launch
//   bond_partials<T, LIN, CONTACT>(p, b, q, sUe, sP)
//                      the six partials of bond q's energy term with
//                      respect to the DOFs of its two blocks, into
//                      sP[s * nbond + q] (seeds 0-2: first block, 3-5:
//                      second); it may read its kRest values at
//                      sP[(kSeeds + k) * nbond + q]
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

// Threads of a block, one design per block either way (measured on the
// H100, PERF.md §6): the guarded kernel's by type while the designs do not
// outnumber the SMs (kFew) and beyond (kMany) (float32 one block of 512
// threads an SM at 128 registers, or two of 256; float64 one of 384; both
// lattices); the unguarded kernel's from the lattice's policy
// (L::Unguarded<T>).
template <typename T>
struct GuardThreads {
  static constexpr int kFew = sizeof(T) == 8 ? 384 : 512;
  static constexpr int kMany = sizeof(T) == 8 ? 384 : 256;
};

// The least number of blocks an SM must hold, for __launch_bounds__: the
// unguarded kernel in its block for many designs, else 1.
template <typename L, typename T, bool GUARD, int NT>
constexpr int min_blocks() {
  using U = typename L::template Unguarded<T>;
  return (!GUARD && NT == U::kMany) ? U::kManyBlocks : 1;
}

// The block of a launch of B designs of lattice L on a device of n_sm SMs.
template <typename L, typename T>
inline int block_threads(bool guarded, int B, int n_sm) {
  using U = typename L::template Unguarded<T>;
  if (guarded) return B <= n_sm ? GuardThreads<T>::kFew : GuardThreads<T>::kMany;
  return B <= n_sm ? U::kFew : U::kMany;
}

// Partials of a bond's energy term: the three DOFs of each of its blocks.
constexpr int kSeeds = 6;

// Elementary functions, overloaded by type.
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

__device__ __forceinline__ float eps_of(float) { return FLT_EPSILON; }
__device__ __forceinline__ double eps_of(double) { return DBL_EPSILON; }

// ---------------------------------------------------------------------------
// Block geometry
// ---------------------------------------------------------------------------

// Constant geometry of one NC-gon block: corner vectors and centroid.
template <typename T, int NC>
struct Corners {
  T cx[NC], cy[NC], px, py;
};

// Signed angle from a to b (verlet_grid._angle).
template <typename T>
__device__ __forceinline__ T angle(T ax, T ay, T bx, T by) {
  return atan2_(ax * by - ay * bx, ax * bx + ay * by);
}

// ---------------------------------------------------------------------------
// Closed-form bond gradients
// ---------------------------------------------------------------------------

// The gradient (gx, gy, g1, g2) = dE/d(dUx, dUy, th1, th2) of one bond's
// ligament energy (verlet_grid._ligament_planes)
//     E = (ks axial^2 l0^2 + ksh shear^2 l0^2 + kr (th2 - th1)^2) / 2,
// by a reverse sweep of its plain-value forward pass:
//   linearized  gx = ks axial refx - ksh shear refy,
//               gy = ks axial refy + ksh shear refx;
//   nonlinear   r = (dUx + refx, dUy + refy),
//               gx = ks axial rx / (axial + 1) - ksh shear l0^2 ry / |r|^2,
//               gy = ks axial ry / (axial + 1) + ksh shear l0^2 rx / |r|^2;
//   both        g1 = -ksh shear l0^2 / 2 - kr dRot,
//               g2 = -ksh shear l0^2 / 2 + kr dRot.
template <typename T, bool LIN>
__device__ __forceinline__ void ligament_grad(T dUx, T dUy, T th1, T th2, T refx, T refy, T ks,
                                              T ksh, T kr, T& gx, T& gy, T& g1, T& g2) {
  const T l0sq = refx * refx + refy * refy;
  T shear;
  if (LIN) {
    const T axial = (dUx * refx + dUy * refy) / l0sq;
    shear = (refx * dUy - refy * dUx) / l0sq - (th1 + th2) / T(2);
    gx = ks * axial * refx - ksh * shear * refy;
    gy = ks * axial * refy + ksh * shear * refx;
  } else {
    const T rx = dUx + refx;
    const T ry = dUy + refy;
    const T rr = rx * rx + ry * ry;
    const T stretch = sqrt_(rr / l0sq);  // axial + 1
    const T mean = (th1 + th2) / T(2);
    const T c = cos_(mean), s = sin_(mean);
    const T px = c * refx - s * refy;
    const T py = s * refx + c * refy;
    shear = atan2_(px * ry - py * rx, px * rx + py * ry);
    const T ka = ks * (stretch - T(1)) / stretch;
    const T kt = ksh * shear * l0sq / rr;
    gx = ka * rx - kt * ry;
    gy = ka * ry + kt * rx;
  }
  const T hs = T(0.5) * ksh * shear * l0sq;
  const T rot = kr * (th2 - th1);
  g1 = -hs - rot;
  g2 = -hs + rot;
}

// An angle taken into [-pi, pi] (atan2's range, but for its end -pi): an
// angle within it is returned unchanged, bit for bit.
__device__ __forceinline__ float wrap_angle(float a) {
  return a - 6.28318530717958647692f * rintf(a * 0.159154943091895335769f);
}
__device__ __forceinline__ double wrap_angle(double a) {
  return a - 6.28318530717958647692 * rint(a * 0.159154943091895335769);
}

// The slope dB/dphi of the contact barrier (ops/contact.contact_energy)
//     B = scale (1/(x + 1) - 1/(x - 1) - 2),  x = (phi - ccut) / span,
//     scale = kc span^2 / 4,  span = ccut - cmin,
// at a void angle phi already known to lie in [cmin, ccut):
// scale (1/(x - 1)^2 - 1/(x + 1)^2) / span = kc span x / ((x - 1)(x + 1))^2.
// x is clamped to [-1 + 64 eps, 0] before the reciprocals; where the clamp
// binds, the slope is 0.
template <typename T>
__device__ __forceinline__ T barrier_slope(T phi, T cmin, T ccut, T kc) {
  const T span = ccut - cmin;
  const T x = (phi - ccut) / span;
  const T lo = T(-1) + T(64) * eps_of(T(0));
  if (!(x > lo && x < T(0))) return T(0);
  const T d = (x - T(1)) * (x + T(1));
  return kc * span * x / (d * d);
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

// Max (MIN = false) or min of v over the 32 lanes of a warp, NaN when any
// v is NaN; max_nan and min_nan give the same value in any order.
template <typename T, bool MIN>
__device__ __forceinline__ T warp_reduce(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MIN ? min_nan(v, w) : max_nan(v, w);
  }
  return v;
}

// The block-wide maxima of th and tr and minimum of gap behind one
// barrier: each warp reduces its lanes into red, and after the barrier
// every thread reads the NT / 32 warps' values (up to 8) or every warp
// reduces them on its lanes. red holds 3 * 32 values; the caller puts a
// barrier between two uses of one red.
template <typename T, int NT>
__device__ __forceinline__ void block_reduce3(T& th, T& tr, T& gap, T* red) {
  constexpr int kW = NT / 32;
  static_assert(NT % 32 == 0 && kW <= 32, "block of whole warps, at most 32");
  th = warp_reduce<T, false>(th);
  tr = warp_reduce<T, false>(tr);
  gap = warp_reduce<T, true>(gap);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = th;
    red[32 + warp] = tr;
    red[64 + warp] = gap;
  }
  __syncthreads();
  if constexpr (kW <= 8) {
    th = red[0];
    tr = red[32];
    gap = red[64];
#pragma unroll
    for (int w = 1; w < kW; ++w) {
      th = max_nan(th, red[w]);
      tr = max_nan(tr, red[32 + w]);
      gap = min_nan(gap, red[64 + w]);
    }
  } else {
    // 0 is the identity of the travel maxima (travel is >= 0 or NaN), +inf
    // of the gap's minimum.
    th = warp_reduce<T, false>(lane < kW ? red[lane] : T(0));
    tr = warp_reduce<T, false>(lane < kW ? red[32 + lane] : T(0));
    gap = warp_reduce<T, true>(lane < kW ? red[64 + lane] : T(INFINITY));
  }
}

// |v| dt + dt^2/2 |a| (guard_travel's travel, same order).
template <typename T>
__device__ __forceinline__ T travel_of(T v, T a, T dt, T hdt2) {
  return abs_(v) * dt + hdt2 * abs_(a);
}

// Division by a divisor d >= 1 fixed for a launch, in place of the long
// sequence of a division by a run-time int: n / d = (umulhi(n, m) + n) >> s
// with s = ceil(log2 d) and m = floor(2^32 (2^s - d) / d) + 1, exact for
// 0 <= n < 2^31 (the round-up method of Granlund and Montgomery). The quad
// policy's index arithmetic uses it; the kagome policy keeps `/`, with
// which its unguarded float64 kernel ran 5.5% faster at B = 528 (PERF.md
// §6).
struct FastDiv {
  unsigned m;
  int s;
  static FastDiv of(int d) {
    if (d < 1) d = 1;  // a divisor no index uses (a lattice one block wide)
    int s = 0;
    while ((1ll << s) < d) ++s;
    const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
    return FastDiv{(unsigned)m, s};
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((unsigned)n, m) + (unsigned)n) >> s);
  }
};

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
  FastDiv dn1, dn1m, dnb;  // by n1, n1 - 1 and n1 * n2 (set_divisors; quad only)
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

// The divisors of a launch's index arithmetic, from its n1 and n2.
template <typename P>
inline void set_divisors(P& p) {
  p.dn1 = FastDiv::of(p.n1);
  p.dn1m = FastDiv::of(p.n1 - 1);
  p.dnb = FastDiv::of(p.n1 * p.n2);
}

// Carry of one design: U, V, A, U_eff planes, the bond partials and the
// bonds' values kept from the start of the launch.
template <typename L>
__host__ __device__ inline size_t scratch_elems(int n1, int n2) {
  return 4 * (size_t)L::kC * n1 * n2 + (kSeeds + L::kRest) * (size_t)L::nbond(n1, n2);
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

// The smallest void angle of this thread's bonds at U (+inf for none).
template <typename L, typename T, int NT>
__device__ __forceinline__ T bond_gaps(const Params<T, L::kLeaves>& p, int b, const T* sU) {
  const int nbond = L::nbond(p.n1, p.n2);
  T m = T(INFINITY);
  for (int q = threadIdx.x; q < nbond; q += NT) m = min_nan(m, L::bond_gap(p, b, q, sU));
  return m;
}

// The guard's risk predicate on the carry for a substep of dt
// (make_risk_predicate):
//     risky = (!(travel <= threshold) && gap < proximity) || !(travel <= hard)
// Uniform across the block; called after a barrier. One pass over the
// thread's elements takes their travel terms and, when `with_gap` (the
// previous substep needed the gap), the gap of its bonds; one reduction
// behind one barrier takes all three. Where the gap is needed and was not
// taken, a second pass and reduction take it (red2). `with_gap` becomes
// whether this substep needed the gap. The maxima and the minimum are the
// same in any order, so the decision is the plain guarded body's.
template <typename L, typename T, bool CONTACT, int NT>
__device__ __forceinline__ bool guard_risky(const Params<T, L::kLeaves>& p, int b, T dt, T hdt2,
                                            const T* S, T* red, T* red2, bool& with_gap) {
  const Guard<T>& g = p.guard;
  const int ne = L::kC * p.n1 * p.n2;
  const T* sU = S;
  const T* sV = S + ne;
  const T* sA = S + 2 * ne;
  // Only a lattice with contact and a barrier has a gap (+inf otherwise).
  const bool has_gap = CONTACT && g.has_proximity && p.leaf[L::kCmin + 2][b] > T(0);
  const bool speculate = has_gap && with_gap;
  // Travel is >= 0 or NaN, so 0 is the identity of both maxima (and the
  // translational term of a lattice with nothing to move against, as in
  // guard_travel).
  T th = T(0), tr = T(0), m = T(INFINITY);
  for (int e = threadIdx.x; e < ne; e += NT) L::travel(p, e, sV, sA, dt, hdt2, th, tr);
  if (speculate) m = bond_gaps<L, T, NT>(p, b, sU);
  block_reduce3<T, NT>(th, tr, m, red);
  T travel = th;
  if (g.has_length_scale) travel = travel + tr / g.length_scale;
  const bool fast = !(travel <= g.threshold);
  const bool hard = g.has_hard && !(travel <= g.hard);
  with_gap = g.has_proximity && !hard && fast;
  if (!with_gap) return fast || hard;
  // Only here can the gap change the answer.
  T gap = T(INFINITY);
  if (has_gap) {
    if (!speculate) {
      m = bond_gaps<L, T, NT>(p, b, sU);
      T th2 = T(0), tr2 = T(0);
      block_reduce3<T, NT>(th2, tr2, m, red2);
    }
    gap = m - p.leaf[L::kCmin + 1][b];
  }
  return gap < g.proximity;
}

// The guarded trajectory of design b on the carry S (levels = 1) in a
// block of NT threads.
template <typename L, typename T, bool LIN, bool CONTACT, int NT>
__device__ __forceinline__ void guarded_trajectory(const Params<T, L::kLeaves>& p, int b, T* S) {
  __shared__ T red[2][3 * 32];
  const int ne = L::kC * p.n1 * p.n2;
  const int n_steps = p.n_int * p.n_sub;
  const int refine = p.guard.refine;
  bool with_gap = false;
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
      const bool risky =
          guard_risky<L, T, CONTACT, NT>(p, b, dt, hdt2, S, red[0], red[1], with_gap);
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

// The whole trajectory of design blockIdx.x in a block of NT threads: the
// body of each lattice's __global__ kernel.
template <typename L, typename T, bool LIN, bool CONTACT, bool GUARD, int NT>
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
  if constexpr (L::kRest > 0) {
    // Read after the first substep's first barrier.
    const int nbond = L::nbond(p.n1, p.n2);
    T* sR = S + 4 * ne + (size_t)kSeeds * nbond;
    for (int q = threadIdx.x; q < nbond; q += blockDim.x) L::rest_angles(p, b, q, sR);
  }

  if constexpr (GUARD) {
    guarded_trajectory<L, T, LIN, CONTACT, NT>(p, b, S);
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

// Launch one instantiation in blocks of `threads` with its carry in dynamic
// shared memory (or on the workspace when the caller gave one).
template <typename L, typename T>
cudaError_t launch_kernel(KernelFn<T, L::kLeaves> kernel, int threads,
                          const Params<T, L::kLeaves>& p, cudaStream_t stream) {
  if (!kernel) return cudaErrorInvalidValue;
  size_t smem = 0;
  if (!p.workspace) {
    smem = scratch_elems<L>(p.n1, p.n2) * sizeof(T);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<p.B, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Number of SMs of the current device, or -1 on error.
inline int device_sms() {
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return n_sm;
}

// Unpack the C interface's arguments and launch the instantiation that
// pick(linearized, contact, guarded, threads) returns (NULL: none) in
// blocks of block_threads<L, T>.
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
                   KernelFn<T, L::kLeaves> (*pick)(bool, bool, bool, int)) {
  constexpr int N = L::kLeaves;
  Params<T, N> p;
  p.B = dims[0];
  p.n1 = dims[1];
  p.n2 = dims[2];
  p.n_int = dims[3];
  p.n_sub = dims[4];
  p.k_drive = dims[5];
  p.k_load = dims[6];
  set_divisors(p);
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
  const int n_sm = device_sms();
  if (n_sm < 1) return cudaErrorInvalidDevice;
  const int threads = block_threads<L, T>(guard != nullptr, p.B, n_sm);
  return launch_kernel<L, T>(pick(linearized != 0, use_contact != 0, guard != nullptr, threads),
                            threads, p, stream);
}

// Largest dynamic shared memory one block of the current device may use
// beside the guarded kernel's static reduction buffers, or -1 on error.
inline long long max_dynamic_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes - 2 * 3 * 32 * (long long)sizeof(double);
}

}  // namespace verlet

// The C interface of a lattice's library: PREFIX_scratch_bytes,
// PREFIX_max_smem, PREFIX_block_threads, PREFIX_launch and
// PREFIX_error_string. PICK is the lattice's template `pick<T>(linearized,
// contact, guarded, threads)`. PREFIX_launch calls PREFIX_launch_f32 or
// PREFIX_launch_f64 by type. Built with -DVERLET_TYPE=4 a source holds
// the float32 kernels and the common functions, with -DVERLET_TYPE=8 the
// float64 kernels, so that the two types compile in parallel and link into
// one library (ops/kernels/build.py); without it, everything.
#define VERLET_C_TYPED(PREFIX, LATTICE, PICK, T, SUFFIX)                                     \
  extern "C" int PREFIX##_launch_##SUFFIX(const void* const* ptrs, const int* dims,          \
                                          int linearized, int use_contact,                   \
                                          const double* guard, void* stream) {               \
    return (int)verlet::launch<LATTICE, T>(ptrs, dims, linearized, use_contact, guard,       \
                                           reinterpret_cast<cudaStream_t>(stream), PICK<T>); \
  }

#define VERLET_C_COMMON(PREFIX, LATTICE)                                                     \
  extern "C" {                                                                               \
  /* Bytes of carry one design needs (shared memory, or workspace when it */                 \
  /* does not fit). */                                                                       \
  long long PREFIX##_scratch_bytes(int n1, int n2, int dtype_bytes) {                        \
    return (long long)(verlet::scratch_elems<LATTICE>(n1, n2) * (size_t)dtype_bytes);        \
  }                                                                                          \
  long long PREFIX##_max_smem(void) { return verlet::max_dynamic_smem(); }                   \
  /* Threads of a block of a launch of B designs on the current device, */                   \
  /* -1 on error. */                                                                         \
  int PREFIX##_block_threads(int B, int dtype_bytes, int guarded) {                          \
    const int n_sm = verlet::device_sms();                                                   \
    if (n_sm < 1 || (dtype_bytes != 4 && dtype_bytes != 8)) return -1;                      \
    return dtype_bytes == 4 ? verlet::block_threads<LATTICE, float>(guarded != 0, B, n_sm)   \
                            : verlet::block_threads<LATTICE, double>(guarded != 0, B, n_sm); \
  }                                                                                          \
  int PREFIX##_launch_f32(const void* const*, const int*, int, int, const double*, void*);   \
  int PREFIX##_launch_f64(const void* const*, const int*, int, int, const double*, void*);   \
  /* Returns the launch's cudaError_t (0 on success). */                                     \
  int PREFIX##_launch(const void* const* ptrs, const int* dims, int dtype_bytes,             \
                      int linearized, int use_contact, const double* guard, void* stream) {  \
    if (dtype_bytes == 4)                                                                    \
      return PREFIX##_launch_f32(ptrs, dims, linearized, use_contact, guard, stream);        \
    if (dtype_bytes == 8)                                                                    \
      return PREFIX##_launch_f64(ptrs, dims, linearized, use_contact, guard, stream);        \
    return (int)cudaErrorInvalidValue;                                                       \
  }                                                                                          \
  const char* PREFIX##_error_string(int err) {                                               \
    return cudaGetErrorString((cudaError_t)err);                                             \
  }                                                                                          \
  }

#if !defined(VERLET_TYPE)
#define VERLET_C_INTERFACE(PREFIX, LATTICE, PICK) \
  VERLET_C_COMMON(PREFIX, LATTICE)                \
  VERLET_C_TYPED(PREFIX, LATTICE, PICK, float, f32) VERLET_C_TYPED(PREFIX, LATTICE, PICK, double, f64)
#elif VERLET_TYPE == 4
#define VERLET_C_INTERFACE(PREFIX, LATTICE, PICK) \
  VERLET_C_COMMON(PREFIX, LATTICE) VERLET_C_TYPED(PREFIX, LATTICE, PICK, float, f32)
#elif VERLET_TYPE == 8
#define VERLET_C_INTERFACE(PREFIX, LATTICE, PICK) VERLET_C_TYPED(PREFIX, LATTICE, PICK, double, f64)
#else
#error "VERLET_TYPE must be 4 (float32) or 8 (float64)"
#endif
