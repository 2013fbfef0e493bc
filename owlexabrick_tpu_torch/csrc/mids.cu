// K6 for Hopper: the x-tent resample of one level's z-lerped lattice
// blocks to screen columns (the x stage of the megakernel lane's camera
// products).
//
// Replaces the TPU kernel owlexabrick_tpu/render/pallas_mids.py
// _make_kernel (:47, pallas_call :121 in xresample_mids).  Its
// plain-torch twin is render/mids.py::xresample_mids_reference.
//
//   per component c (channel mids, then the mask mid), slab s, lattice
//   row y and screen column j:
//     out[c, s, y, j] = w0 * zv[c, s, y, k0] + w1 * zv[c, s, y, k0 + 1]
//   with k0 = floor(qx[s, j]) and the tent weights max(0, 1 - |qx - k|)
//   for k in [0, nx), zero outside (the same two entries the JAX
//   package's dense tent matrix holds per column).
//
// The TPU kernel built an (nx, tc) tent per (slab, column tile) and
// contracted each (ny, nx) block against it on the MXU, with rows padded
// to 8, columns padded at -2 to the tile multiple and a bf16 hi/lo split
// option.  None of that is needed here: a column's tent has two nonzero
// entries, so each thread takes one (slab, column), computes both taps
// and their weights once, and loops over lattice rows and components,
// reading two floats and writing one per row.  The output is the port's
// own mids layout (C+1, S, ny, W), unpadded, float32 only.
//
// What bounds it on this card: bytes.  It writes 4 (C+1) S ny W bytes
// and reads the (C+1) S ny nx blocks at least once, against 3 flops per
// output value.  Neighbouring threads take neighbouring columns, so the
// writes are coalesced and the two reads of a row fall in the same few
// cache lines; rows are split over the grid's z dimension so that
// enough blocks are in flight (one level's S x W columns alone are ~180
// blocks at 1080p).
//
// Built with -fmad=false so each multiply and add rounds like the plain
// torch version's separate ops; the kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // lattice rows per thread

struct MidsParams {
  int n_comp, S, ny, nx, W;
};

// grid (ceil(W / kThreads), S, ceil(ny / kRows)); zvs (C+1, S, ny, nx),
// qx (S, W), out (C+1, S, ny, W)
__global__ void __launch_bounds__(kThreads)
xresample_mids_kernel(const float* __restrict__ zvs,
                      const float* __restrict__ qx,
                      float* __restrict__ out, MidsParams p) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= p.W) return;
  const int s = blockIdx.y;
  const int y0 = blockIdx.z * kRows;
  const int y1 = min(y0 + kRows, p.ny);
  const float q = qx[(size_t)s * p.W + j];
  const float kf = floorf(q);
  const int k0 = (int)kf;
  const int k1 = k0 + 1;
  const float w0 = (k0 >= 0 && k0 < p.nx) ? fmaxf(1.f - fabsf(q - kf), 0.f)
                                          : 0.f;
  const float w1 = (k1 >= 0 && k1 < p.nx)
                       ? fmaxf(1.f - fabsf(q - (kf + 1.f)), 0.f)
                       : 0.f;
  const int i0 = min(max(k0, 0), p.nx - 1);
  const int i1 = min(max(k1, 0), p.nx - 1);
  for (int c = 0; c < p.n_comp; ++c) {
    const size_t plane = (size_t)c * p.S + s;
    const float* src = zvs + plane * p.ny * p.nx;
    float* dst = out + plane * p.ny * p.W + j;
    for (int y = y0; y < y1; ++y) {
      const float* row = src + (size_t)y * p.nx;
      dst[(size_t)y * p.W] = w0 * __ldg(row + i0) + w1 * __ldg(row + i1);
    }
  }
}

}  // namespace

// K6: zvs (n_comp, S, ny, nx), qx (S, W), out (n_comp, S, ny, W), all
// float32 contiguous.  Returns the launch's cudaError_t (0 = launched).
extern "C" int owx_xresample_mids(const void* zvs, const void* qx,
                                  void* out, int n_comp, int S, int ny,
                                  int nx, int W, void* stream) {
  if (!zvs || !qx || !out || n_comp < 1 || S < 1 || S > 65535 || ny < 1 ||
      nx < 1 || W < 1 || (ny + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const MidsParams p = {n_comp, S, ny, nx, W};
  const dim3 grid((W + kThreads - 1) / kThreads, S, (ny + kRows - 1) / kRows);
  xresample_mids_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)zvs, (const float*)qx, (float*)out, p);
  return (int)cudaGetLastError();
}
