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
// term depends on exactly the six DOFs of its two blocks, and its six
// partials are taken in closed form (quad_policy.cuh: a plain-value pass
// and a scalar reverse sweep, about a quarter of the operations of the
// forward-mode duals the kernel used before, and a few live scalars in
// place of seven-wide duals) into a per-bond buffer. After a barrier each
// (DOF, block) thread sums its own <= 4 bonds in a fixed order: no
// atomics, so runs are deterministic. External loads enter as the drive
// does: the wrapper sums the pairs that name one slot into one load-table
// column per slot, and each (DOF, block) thread adds its slot's column,
// read through load_map, behind a branch on k_load that is uniform across
// the launch. The contact barrier's slope is evaluated only where one of
// the bond's void angles lies in [min_angle, cutoff): elsewhere it is zero.
//
// The unguarded block is sized to the bonds while the designs do not
// outnumber the SMs (Quad::Unguarded<T>::kFew in quad_policy.cuh: at float32
// 768 threads, a thread per bond of the flagship's 728, the element passes
// spread over the same threads; 512 at float64, whose registers do not fit
// 768), and beyond that to the batch's throughput (::kMany, two blocks an
// SM). One design per block either way, no atomics and a fixed summation
// order: a design's outputs do not depend on the block or the batch.
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
// as jnp.max does, taken together behind one barrier; the gap counts only
// where it can change the answer, and is evaluated in the travel pass
// where the substep before needed it too (in a pass of its own elsewhere).
// The decision is uniform across the block, so every thread takes the same
// branch and the barriers stay legal: a risky substep runs `refine`
// micro-steps of dt / refine with drive rows from the micro-step table.
// Each substep's decision and each interval's "any fired" flag are written
// as bytes. The guard costs a pass and a reduction a substep and, where it
// fires, refine - 1 extra steps. Its block while the designs do not
// outnumber the SMs is 512 threads at float32 (256 beyond) and 384 at
// float64 at any batch (GuardThreads in verlet_common.cuh), so that more
// warps hide the latency of a step.
//
// What does not depend on the lattice (the closed-form gradients of the
// ligament and barrier energies, the substep, the guard's loop,
// the launch) is in verlet_common.cuh, shared with the kagome kernel; the
// quad lattice's policy (bond indexing, the bond partials, gather, travel
// and gap) is in quad_policy.cuh, shared with the force kernel of
// quad_force.cu.

#include "quad_policy.cuh"

namespace {

using namespace verlet;

template <typename T, bool LIN, bool CONTACT, bool GUARD, int NT>
__global__ void __launch_bounds__(NT, (min_blocks<Quad, T, GUARD, NT>()))
    verlet_quad_kernel(const Params<T, Quad::kLeaves> p) {
  run_trajectory<Quad, T, LIN, CONTACT, GUARD, NT>(p);
}

template <typename T, bool GUARD, int NT>
KernelFn<T, Quad::kLeaves> pick_flags(bool linearized, bool contact) {
  if (linearized)
    return contact ? verlet_quad_kernel<T, true, true, GUARD, NT>
                   : verlet_quad_kernel<T, true, false, GUARD, NT>;
  return contact ? verlet_quad_kernel<T, false, true, GUARD, NT>
                 : verlet_quad_kernel<T, false, false, GUARD, NT>;
}

// Unguarded in blocks of Quad::Unguarded<T>::kFew or ::kMany, guarded of
// GuardThreads<T>::kFew or ::kMany; NULL for any other block.
template <typename T>
KernelFn<T, Quad::kLeaves> pick(bool linearized, bool contact, bool guard, int threads) {
  using G = GuardThreads<T>;
  using U = Quad::Unguarded<T>;
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

// ptrs: U0, V0, A0, dts, drive, drive_map, the 16 fixed leaves (Quad), outU,
//       outV, outA, workspace (NULL: carry in shared memory), and when
//       guarded: micro, decisions, flags (verlet::launch).
VERLET_C_INTERFACE(verlet_quad, Quad, pick)
