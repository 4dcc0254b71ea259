// Batched quad-lattice energy gradient (kernel 2) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of tools/microbench_lanes_batch.py:136-149
// (main.<kernel>, pallas_call at :143): vmap(grad_split) over B designs,
// the gradient with respect to U of the quad plane energy
// difflexmm_tpu/ops/pallas/verlet_grid.py quad_grid_energy_planes (strain
// plus contact). That kernel was the TPU candidate for the one energy
// gradient of each substep of the JAX solver's stepped forward
// (method="verlet_ckpt"); here it is that forward's force on CUDA tensors.
//
// What it computes, for each design b of a batch:
//     out[b] = dE/dU_eff (U_eff[b]),   (3, n2, n1) planes (ux, uy, theta)
// with E the ligament energy of every horizontal and vertical bond plus,
// with CONTACT, the angle-based contact barrier on its two void angles,
// LIN selecting the linearized ligament strains.
//
// What bounds it on the card: at the flagship's 24 x 16 blocks a design is
// 728 bonds of about 630 floating-point operations each and about 39 KB
// of inputs, so a batch of 128 designs is bound by memory (about 5 MB, 1.5
// us at 3.35 TB/s) and a single design by launch latency. The design does
// not carry the TPU's lane layout over. Two passes, each a plain grid:
//   1. one thread per (bond, design), grid (ceil(nbond / 128), B): the
//      bond's energy term depends on the six DOFs of its two blocks only,
//      so it is evaluated once on forward-mode duals seeded on those six
//      (Quad::bond_partials, the very code of the trajectory kernel) and
//      its six partials go to a (B, 6, nbond) global workspace;
//   2. one thread per (state element, design), grid (ceil(3 n1 n2 / 256),
//      B): each element sums the partials of its <= 4 bonds in a fixed
//      order (Quad::gather).
// No atomics, so a run is deterministic, and the summation order is the
// trajectory kernel's. Many thread blocks cover one design, so a lattice
// of 96 x 64 blocks (12,128 bonds) spreads over the card at B = 1. The
// workspace stays in L2 between the passes (4.5 MB at B = 128 in float64).
// A design reads only its own inputs: a NaN or inf reaches only its own
// output.

#include "quad_policy.cuh"

namespace {

using namespace verlet;

constexpr int kBondThreads = 128;  // dual arithmetic: registers are the limit
constexpr int kGatherThreads = 256;

// The energy leaves (Quad's first 13) of one launch; the inertia, damping
// and mask leaves are not read.
template <typename T>
using ForceParams = Params<T, Quad::kLeaves>;

template <typename T, bool LIN, bool CONTACT>
__global__ void __launch_bounds__(kBondThreads)
    quad_bond_kernel(const ForceParams<T> p, const T* __restrict__ Ue, T* __restrict__ P) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int nbond = Quad::nbond(p.n1, p.n2);
  if (q >= nbond) return;
  const size_t ne = (size_t)Quad::kC * p.n1 * p.n2;
  Quad::bond_partials<T, LIN, CONTACT>(p, b, q, Ue + b * ne, P + (size_t)b * kSeeds * nbond);
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
    quad_gather_kernel(const ForceParams<T> p, const T* __restrict__ P, T* __restrict__ out) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int ne = Quad::kC * p.n1 * p.n2;
  if (e >= ne) return;
  const size_t nbond = Quad::nbond(p.n1, p.n2);
  out[(size_t)b * ne + e] = Quad::gather(p, e, P + (size_t)b * kSeeds * nbond);
}

template <typename T>
using BondKernel = void (*)(const ForceParams<T>, const T*, T*);

template <typename T>
BondKernel<T> pick(bool linearized, bool contact) {
  if (linearized)
    return contact ? quad_bond_kernel<T, true, true> : quad_bond_kernel<T, true, false>;
  return contact ? quad_bond_kernel<T, false, true> : quad_bond_kernel<T, false, false>;
}

// ptrs: U_eff (B,3,n2,n1), the 13 energy leaves of Quad (cnv ... kc), the
// workspace (B, 6, nbond) and out (B,3,n2,n1). dims: B, n1, n2.
template <typename T>
cudaError_t launch_force(const void* const* ptrs, const int* dims, int linearized,
                         int use_contact, cudaStream_t stream) {
  ForceParams<T> p = {};
  p.B = dims[0];
  p.n1 = dims[1];
  p.n2 = dims[2];
  // gridDim.y holds the batch (at most 65,535); a lattice needs a bond.
  if (p.B <= 0 || p.B > 65535 || p.n1 <= 0 || p.n2 <= 0 || Quad::nbond(p.n1, p.n2) <= 0)
    return cudaErrorInvalidValue;
  set_divisors(p);
  const T* const* f = reinterpret_cast<const T* const*>(ptrs);
  for (int i = 0; i < Quad::kCmin + 3; ++i) p.leaf[i] = f[1 + i];
  const T* Ue = f[0];
  T* P = const_cast<T*>(f[Quad::kCmin + 4]);
  T* out = const_cast<T*>(f[Quad::kCmin + 5]);
  if (!Ue || !P || !out) return cudaErrorInvalidValue;
  const int nbond = Quad::nbond(p.n1, p.n2);
  const int ne = Quad::kC * p.n1 * p.n2;
  const dim3 bond_grid((nbond + kBondThreads - 1) / kBondThreads, p.B);
  pick<T>(linearized != 0, use_contact != 0)<<<bond_grid, kBondThreads, 0, stream>>>(p, Ue, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gather_grid((ne + kGatherThreads - 1) / kGatherThreads, p.B);
  quad_gather_kernel<T><<<gather_grid, kGatherThreads, 0, stream>>>(p, P, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {
// Returns the launches' cudaError_t (0 on success).
int quad_force_launch(const void* const* ptrs, const int* dims, int dtype_bytes, int linearized,
                      int use_contact, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4) return (int)launch_force<float>(ptrs, dims, linearized, use_contact, s);
  if (dtype_bytes == 8) return (int)launch_force<double>(ptrs, dims, linearized, use_contact, s);
  return (int)cudaErrorInvalidValue;
}

const char* quad_force_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
