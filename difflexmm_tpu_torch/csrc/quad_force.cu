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
// 728 bonds of about 120 floating-point operations each in closed form
// (Quad::bond_term, the very code of the trajectory kernel) and about 39
// KB of inputs, so a batch of 128 designs is bound by memory (about 5 MB,
// 1.5 us at 3.35 TB/s) and a single design by the latency of one launch
// and of one bond's dependent loads and arithmetic. The design keeps the
// bond partials out of device memory and pays one launch a call: one
// kernel on a grid of (lattice tile, design). Each block
//   1. takes the closed-form partials of every bond that touches its tile
//      of blocks (the tile's own bonds and those that join it to the
//      blocks beside it) into shared memory, a thread per bond;
//   2. after a barrier, sums each of its tile's state elements' <= 4 bonds
//      in Quad::gather's order, a thread per element.
// A bond on a tile's edge is computed by both tiles it touches, from the
// same inputs by the same code, so both get the same bits: no atomics, no
// second pass and no workspace, and the summation order is the trajectory
// kernel's. The tile is picked by the launch (pick_tile): small tiles
// while a batch leaves SMs idle, so that one design (the flagship at
// B = 1, or a 96 x 64 lattice) spreads over many SMs; larger ones beyond,
// where fewer bonds are computed twice. A design reads only its own
// inputs: a NaN or inf reaches only its own output. Measured on the H100
// (PERF.md §6), a call at (3, 16, 24) x 128 takes about 7 us at float32,
// half the two launches it replaces and still 4-5 times the bytes' bound:
// each block runs two or three bonds a thread back to back, so the
// latency of a bond's dependent loads, sines and quotients sets it.

#include "quad_policy.cuh"

namespace {

using namespace verlet;

// The energy leaves (Quad's first 13) of one launch; the inertia, damping
// and mask leaves are not read.
template <typename T>
using ForceParams = Params<T, Quad::kLeaves>;

// A tile of TX x TY blocks and its bond slots: horizontal bonds (j, i)-(j,
// i+1) of the tile's rows j0 <= j < j0 + TY with i0 - 1 <= i < i0 + TX,
// then vertical bonds (j, i)-(j+1, i) with j0 - 1 <= j < j0 + TY and the
// tile's columns i0 <= i < i0 + TX; slots outside the lattice stay empty.
template <int TX, int TY>
struct Tile {
  static constexpr int kH = TY * (TX + 1);
  static constexpr int kSlots = kH + (TY + 1) * TX;
};

template <typename T, bool LIN, bool CONTACT, int TX, int TY, int NT>
__global__ void __launch_bounds__(NT)
    quad_force_kernel(const ForceParams<T> p, const T* __restrict__ Ue, T* __restrict__ out) {
  using Tl = Tile<TX, TY>;
  __shared__ T sP[kSeeds * Tl::kSlots];
  const int n1 = p.n1, n2 = p.n2, nb = n1 * n2;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY, b = blockIdx.z;
  const T* U = Ue + (size_t)b * Quad::kC * nb;
  for (int s = threadIdx.x; s < Tl::kSlots; s += NT) {
    if (s < Tl::kH) {
      const int jj = s / (TX + 1), j = j0 + jj, i = i0 - 1 + s - jj * (TX + 1);
      if (j < n2 && i >= 0 && i < n1 - 1)
        Quad::bond_term<T, LIN, CONTACT, true>(p, b, j * n1 + i, j * (n1 - 1) + i, U, sP + s,
                                               Tl::kSlots);
    } else {
      const int jj = (s - Tl::kH) / TX, j = j0 - 1 + jj, i = i0 + s - Tl::kH - jj * TX;
      if (j >= 0 && j < n2 - 1 && i < n1)
        Quad::bond_term<T, LIN, CONTACT, false>(p, b, j * n1 + i, j * n1 + i, U, sP + s,
                                                Tl::kSlots);
    }
  }
  __syncthreads();
  // Quad::gather's order: left, right, below, above.
  for (int e = threadIdx.x; e < Quad::kC * TX * TY; e += NT) {
    const int c = e / (TX * TY), jj = (e - c * TX * TY) / TX, ii = e - c * TX * TY - jj * TX;
    const int i = i0 + ii, j = j0 + jj;
    if (i >= n1 || j >= n2) continue;
    const T* h = sP + jj * (TX + 1) + ii;  // slot of the horizontal bond (j, i - 1)
    const T* v = sP + Tl::kH + jj * TX + ii;  // slot of the vertical bond (j - 1, i)
    T g = T(0);
    if (i > 0) g += h[(3 + c) * Tl::kSlots];
    if (i < n1 - 1) g += h[c * Tl::kSlots + 1];
    if (j > 0) g += v[(3 + c) * Tl::kSlots];
    if (j < n2 - 1) g += v[c * Tl::kSlots + TX];
    out[((size_t)b * Quad::kC + c) * nb + j * n1 + i] = g;
  }
}

template <typename T>
using ForceKernel = void (*)(const ForceParams<T>, const T*, T*);

template <typename T, int TX, int TY, int NT>
ForceKernel<T> pick_flags(bool linearized, bool contact) {
  if (linearized)
    return contact ? quad_force_kernel<T, true, true, TX, TY, NT>
                   : quad_force_kernel<T, true, false, TX, TY, NT>;
  return contact ? quad_force_kernel<T, false, true, TX, TY, NT>
                 : quad_force_kernel<T, false, false, TX, TY, NT>;
}

// The launch's tile (TX, TY) and threads: 8 x 8 blocks in 128 threads while
// the grid of such tiles would not give every SM two blocks, 32 x 8 in 256
// beyond (measured on the H100 among ten shapes from 8 x 4 to 32 x 8,
// PERF.md §6: a flagship design at B = 1 and the 96 x 64 lattice run
// fastest on small tiles spread over many SMs, a batch of 128 flagship
// designs on tiles as wide as the lattice, whose rows a warp reads whole).
struct TileShape {
  int tx, ty, threads;
};

inline TileShape pick_tile(int n1, int n2, int B, int n_sm) {
  const long long small = (long long)((n1 + 7) / 8) * ((n2 + 7) / 8) * B;
  return small < 2LL * n_sm ? TileShape{8, 8, 128} : TileShape{32, 8, 256};
}

template <typename T>
ForceKernel<T> pick(const TileShape& t, bool linearized, bool contact) {
  if (t.tx == 8) return pick_flags<T, 8, 8, 128>(linearized, contact);
  return pick_flags<T, 32, 8, 256>(linearized, contact);
}

// ptrs: U_eff (B,3,n2,n1), the 13 energy leaves of Quad (cnv ... kc) and
// out (B,3,n2,n1). dims: B, n1, n2.
template <typename T>
cudaError_t launch_force(const void* const* ptrs, const int* dims, int linearized,
                         int use_contact, cudaStream_t stream) {
  ForceParams<T> p = {};
  p.B = dims[0];
  p.n1 = dims[1];
  p.n2 = dims[2];
  // gridDim.z holds the batch (at most 65,535); a lattice needs a bond.
  if (p.B <= 0 || p.B > 65535 || p.n1 <= 0 || p.n2 <= 0 || Quad::nbond(p.n1, p.n2) <= 0)
    return cudaErrorInvalidValue;
  const T* const* f = reinterpret_cast<const T* const*>(ptrs);
  for (int i = 0; i < Quad::kCmin + 3; ++i) p.leaf[i] = f[1 + i];
  const T* Ue = f[0];
  T* out = const_cast<T*>(f[Quad::kCmin + 4]);
  if (!Ue || !out) return cudaErrorInvalidValue;
  const int n_sm = device_sms();
  if (n_sm < 1) return cudaErrorInvalidDevice;
  const TileShape t = pick_tile(p.n1, p.n2, p.B, n_sm);
  const dim3 grid((p.n1 + t.tx - 1) / t.tx, (p.n2 + t.ty - 1) / t.ty, p.B);
  pick<T>(t, linearized != 0, use_contact != 0)<<<grid, t.threads, 0, stream>>>(p, Ue, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {
// Returns the launch's cudaError_t (0 on success).
int quad_force_launch(const void* const* ptrs, const int* dims, int dtype_bytes, int linearized,
                      int use_contact, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4) return (int)launch_force<float>(ptrs, dims, linearized, use_contact, s);
  if (dtype_bytes == 8) return (int)launch_force<double>(ptrs, dims, linearized, use_contact, s);
  return (int)cudaErrorInvalidValue;
}

// The tile of a launch of B designs of n1 x n2 blocks on the current
// device: shape[0..2] = (blocks along n1, along n2, threads). Returns 0, or
// -1 on error.
int quad_force_tile(int n1, int n2, int B, int* shape) {
  const int n_sm = device_sms();
  if (n_sm < 1 || !shape) return -1;
  const TileShape t = pick_tile(n1, n2, B, n_sm);
  shape[0] = t.tx;
  shape[1] = t.ty;
  shape[2] = t.threads;
  return 0;
}

const char* quad_force_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
