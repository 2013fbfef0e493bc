// K6 for Hopper: the x-tent resample of the z-lerped lattice blocks of
// every level of a chunk to screen columns (the x stage of the megakernel
// lane's camera products).
//
// Replaces the TPU kernel owlexabrick_tpu/render/pallas_mids.py
// _make_kernel (:47, pallas_call :121 in xresample_mids).  Its
// plain-torch twin is render/mids.py::xresample_mids_reference, per
// level.
//
//   per level, component c (channel mids, then the mask mid), slab s,
//   lattice row y and screen column j:
//     out[c, s, y, j] = w0 * zv[c, s, y, k0] + w1 * zv[c, s, y, k0 + 1]
//   with k0 = floor(qx[s, j]) and the tent weights max(0, 1 - |qx - k|)
//   for k in [0, nx), zero outside (the same two entries the JAX
//   package's dense tent matrix holds per column).
//
// The TPU kernel built an (nx, tc) tent per (slab, column tile) and
// contracted each (ny, nx) block against it on the MXU, with rows padded
// to 8, columns padded at -2 to the tile multiple and a bf16 hi/lo split
// option.  None of that is needed here: a column's tent has two nonzero
// entries.  The output is the port's own mids layout (C+1, S, ny, W),
// unpadded, float32 only.
//
// What bounds it on this card: bytes.  Per level it writes 4 (C+1) S ny W
// bytes and reads the (C+1) S ny nx blocks, with nx several times below
// W, against 3 flops per output value; the writes are nearly all of it.
// The design (xresample_levels_kernel):
//
// * One launch per chunk for every level.  The levels' pointers and
//   sizes travel by value (__grid_constant__) in a table of up to
//   kMaxLevels entries, with the first block of each level in one
//   flattened grid; a block finds its level from the prefix offsets.  A
//   chunk's levels are small (the 64^3 headline's ny = 64, 32, 16 and 8
//   at S = 12), and one launch per level left most SMs idle on all but
//   the largest and paid a launch each.
// * One thread per screen column, kRows lattice rows per block: the
//   thread's two taps and weights are computed once, in registers, and
//   its rows' tap pairs are loaded kUnroll rows at a time, before any of
//   them is stored, over restrict pointers, so that each warp has
//   2 kUnroll loads in flight instead of one row's two.  A warp's 32
//   columns reach ~4 lattice columns, so the loads hit L1 after a
//   block's first touch; a warp's 4-byte stores fill whole 128-byte
//   lines of a row.
// * Block counts per chunk (kThreads columns x kRows rows, 256 threads,
//   56 registers: 4 blocks per SM, 528 at once on 132 SMs): 8 column
//   tiles x S x sum over levels of ceil(ny / 16); the 64^3 headline
//   (S = 12; ny 64, 32, 16, 8): 8 x 12 x 8 = 768 blocks, 1.5 waves; the
//   256^3 blobs scene (S = 24; ny 240, 128, 64, 32): 8 x 24 x 29 = 5,568
//   blocks, 10.5 waves.
//
// On the H100 (PERF.md section 6) torch's fill_ of the same outputs runs
// at about the bytes bound; what separates this kernel from it is the
// rows' loads, and starting them kUnroll rows at a time is what moved
// it; tiles staged in shared memory with cp.async and float4 stores ran
// slower on every shape timed there.  The kernel computes w0 * a +
// w1 * b in that order, built with -fmad=false, so it gives the same
// bits as the plain twin.  Nothing is allocated here; every launch is
// on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kRows = 16;   // rows per block
constexpr int kUnroll = 8;  // rows whose loads are started together

struct Tap {
  int i0, i1;
  float w0, w1;
};

// the tent's two lattice points at q on an axis of n points: clamped
// indices and weights (zero outside [0, n)), as mids.py::tent_taps
__device__ __forceinline__ Tap tent(float q, int n) {
  const float kf = floorf(q);
  const int k0 = (int)kf;
  const int k1 = k0 + 1;
  Tap t;
  t.w0 = (k0 >= 0 && k0 < n) ? fmaxf(1.f - fabsf(q - kf), 0.f) : 0.f;
  t.w1 = (k1 >= 0 && k1 < n) ? fmaxf(1.f - fabsf(q - (kf + 1.f)), 0.f)
                             : 0.f;
  t.i0 = min(max(k0, 0), n - 1);
  t.i1 = min(max(k1, 0), n - 1);
  return t;
}

struct LevelEntry {
  const float* zvs;  // (C+1, S, ny, nx)
  const float* qx;   // (S, W)
  float* out;        // (C+1, S, ny, W)
  int ny, nx, row_tiles, block0;
};

struct LevelTable {
  LevelEntry lv[kMaxLevels];
  int n_levels, n_comp, S, W, col_tiles;
};

struct TileId {
  int level, s, ct, rt;
};

// a flattened block's level (the last whose first block it has reached)
// and its (slab, row tile, column tile), column tiles fastest
__device__ __forceinline__ TileId tile_of(const LevelTable& t, int b) {
  TileId id;
  id.level = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < t.n_levels && b >= t.lv[i].block0) id.level = i;
  int local = b - t.lv[id.level].block0;
  id.ct = local % t.col_tiles;
  local /= t.col_tiles;
  id.rt = local % t.lv[id.level].row_tiles;
  id.s = local / t.lv[id.level].row_tiles;
  return id;
}

// one thread per column with its rows' tap pairs loaded kUnroll rows at
// a time over restrict pointers.  The minimum of 1 block per SM in the
// launch bounds matters: without it the same loop built to 40 registers
// and ran slower on the H100 than with its rows' loads one at a time
__global__ void __launch_bounds__(kThreads, 1)
xresample_levels_kernel(const __grid_constant__ LevelTable t) {
  const TileId id = tile_of(t, blockIdx.x);
  const LevelEntry& L = t.lv[id.level];
  const int j = id.ct * kThreads + threadIdx.x;
  if (j >= t.W) return;
  const int nx = L.nx, ny = L.ny, W = t.W;
  const int y0 = id.rt * kRows;
  const int y1 = min(y0 + kRows, ny);
  const Tap tp = tent(__ldg(L.qx + (size_t)id.s * W + j), nx);
  for (int c = 0; c < t.n_comp; ++c) {
    const size_t plane = (size_t)c * t.S + id.s;
    const float* __restrict__ src = L.zvs + plane * ny * nx + tp.i0;
    float* __restrict__ dst = L.out + plane * ny * W + j;
    const int d = tp.i1 - tp.i0;
#pragma unroll kUnroll
    for (int y = y0; y < y1; ++y) {
      const float* row = src + y * nx;
      dst[(size_t)y * W] = tp.w0 * __ldg(row) + tp.w1 * __ldg(row + d);
    }
  }
}

}  // namespace

// K6, one launch for n_levels <= kMaxLevels levels of one chunk: per
// level l, zvs[l] (n_comp, S, ny[l], nx[l]), qx[l] (S, W) and out[l]
// (n_comp, S, ny[l], W), all float32 contiguous.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int owx_xresample_levels(const void* const* zvs,
                                    const void* const* qx,
                                    void* const* out, const int* ny,
                                    const int* nx, int n_levels, int n_comp,
                                    int S, int W, void* stream) {
  if (!zvs || !qx || !out || !ny || !nx || n_levels < 1 ||
      n_levels > kMaxLevels || n_comp < 1 || S < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  LevelTable t = {};
  t.n_levels = n_levels;
  t.n_comp = n_comp;
  t.S = S;
  t.W = W;
  t.col_tiles = (W + kThreads - 1) / kThreads;
  long long blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (!zvs[l] || !qx[l] || !out[l] || ny[l] < 1 || nx[l] < 1)
      return (int)cudaErrorInvalidValue;
    LevelEntry& e = t.lv[l];
    e.zvs = (const float*)zvs[l];
    e.qx = (const float*)qx[l];
    e.out = (float*)out[l];
    e.ny = ny[l];
    e.nx = nx[l];
    e.row_tiles = (ny[l] + kRows - 1) / kRows;
    e.block0 = (int)blocks;
    blocks += (long long)t.col_tiles * S * e.row_tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  xresample_levels_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
