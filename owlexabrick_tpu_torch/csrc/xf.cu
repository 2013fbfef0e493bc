// K3, K4 and K5 for Hopper: transfer-function classification for the
// einsum lane, and the stand-alone LUT lookup.
//
// Replaces the TPU kernels owlexabrick_tpu/render/pallas_xf.py
// _composite_chunk_kernel (:178, pallas_call :293, K3),
// _classify_field_kernel (:46, pallas_call :155, K4) and _xf_kernel
// (:24, pallas_call :329 in xf_classify, K5).  Their plain-torch twins
// are render/classify.py::composite_mids_reference,
// classify_field_reference and xf_classify_reference.
//
//   K3: the one-channel clip route's chunk from each level's mids: per
//       pixel and live slab, the y lerp of every level's mids summed in
//       level order (sw, swv), the clip interval's masks on sw, then
//       K4's classification and the front-to-back composite over the
//       slabs; out premultiplied r, g, b and the transmittance T, each
//       (H, W).  The TPU kernel (and this port until it) read sw, swv
//       (S, H, W) fields that the y stage had written to memory.
//   K4: per (slab, pixel): value = swv/sw (invalid where sw <= 1e-20),
//       texel coordinate, LUT rgba, a = 1-(1-a)^(dz*sec), a = 0 where
//       invalid; out r, g, b, a planes, each (S, H, W).
//   K5: per element of u (R, C), clamped texel coordinates in [0, N-1]:
//       the LUT's r, g, b, a at u; out four (R, C) planes.  The iso
//       path's colormap recolor (render_slabs_iso, colormap_channel != 0)
//       calls it once per frame on the hit image.
//
// The TPU kernels walked the knots between each (8 x tc) tile's least and
// greatest texel coordinate, with the LUT differences in SMEM.  For one
// pixel that walk telescopes to lut[k] + (u-k) (lut[k+1]-lut[k]) with
// k = min(floor(u), N-2), so each thread lerps the LUT held in shared
// memory (128 x float4, 2 KB) and the tiles, their remainder masks and
// the walk are gone.  K4 classifies every sample, invalid ones at
// value = swv/1, and zeroes only alpha, so no inf or NaN enters.
//
// What bounds them on this card: by bytes, all three.  K4 reads sw and
// swv and writes four planes, ~24 bytes per (slab, pixel) against ~30
// flops; K5 reads 4 bytes and writes 16 per element.  One thread per
// (slab, pixel) for K4 and per element for K5, neighbouring threads on
// neighbouring pixels, so every read and write is coalesced.  K3 reads
// each level's mids, ~2 x 4 bytes per (slab, lattice row, column), and
// writes 16 bytes per pixel; on the H100 it runs far above that bound
// (PERF.md section 6): its time goes to the 4 loads per level and sample
// from L1 and to the classification (three IEEE divisions and a powf
// per valid sample), which the design below keeps as few and as short
// as it can.
//
// Built with -fmad=false so each multiply and add rounds like the plain
// torch version's separate ops; the kernels allocate nothing and launch
// on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxTexels = 128;  // NUM_XF_VALUES
constexpr int kMaxSlabs = 256;
constexpr int kThreads = 256;

struct XfParams {
  long long hw;  // pixels per slab plane
  int S, n;      // slabs, LUT texels
  float lo, hi, dz;
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// xf_texel_coord (owlexabrick_tpu/render/slabs.py:341-347) in the same
// float32 operation order; classify.py::texel_coord is its torch twin
__device__ __forceinline__ float texel_coord(float value, float lo,
                                             float hi, int n) {
  const float nm1 = (float)(n - 1);
  float s = nm1 * (value - lo) / ((hi - lo) + 1e-20f);
  s = clip(s + 0.5f, 0.0f, nm1) / nm1;
  return clip(s * (float)n - 0.5f, 0.0f, nm1);
}

// rgba of one sample: the LUT lerped at its texel coordinate
__device__ __forceinline__ float4 classify(const float4* lut, int n,
                                           float value, float lo,
                                           float hi) {
  const float u = texel_coord(value, lo, hi, n);
  const int k = min((int)floorf(u), n - 2);
  const float f = u - (float)k;
  const float4 a = lut[k];
  const float4 b = lut[k + 1];
  return make_float4(a.x + f * (b.x - a.x), a.y + f * (b.y - a.y),
                     a.z + f * (b.z - a.z), a.w + f * (b.w - a.w));
}

// 1-(1-a)^e with the base clamped at 0 (pallas_xf.py:106, :242); powf,
// not __powf: e = dz*sec grows large at grazing rays
__device__ __forceinline__ float opacity(float a, float e) {
  return 1.0f - powf(fmaxf(1.0f - a, 0.0f), e);
}

__device__ __forceinline__ void load_lut(const float* lut, int n,
                                         float4* s_lut) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s_lut[i] = make_float4(lut[4 * i], lut[4 * i + 1], lut[4 * i + 2],
                           lut[4 * i + 3]);
}

// K4: grid (ceil(H*W / kThreads), S); out (4, S, H, W)
__global__ void __launch_bounds__(kThreads)
classify_field_kernel(const float* __restrict__ sw,
                      const float* __restrict__ swv,
                      const float* __restrict__ sec,
                      const float* __restrict__ lut,
                      float* __restrict__ out, XfParams p) {
  __shared__ float4 s_lut[kMaxTexels];
  load_lut(lut, p.n, s_lut);
  __syncthreads();
  const long long px = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (px >= p.hw) return;
  const long long plane = p.hw * p.S;
  const long long i = (long long)blockIdx.y * p.hw + px;
  const float w = sw[i];
  const bool ok = w > 1e-20f;
  const float value = swv[i] / (ok ? w : 1.0f);
  const float4 c = classify(s_lut, p.n, value, p.lo, p.hi);
  const float a = opacity(c.w, p.dz * sec[px]);
  out[i] = c.x;
  out[plane + i] = c.y;
  out[2 * plane + i] = c.z;
  out[3 * plane + i] = ok ? a : 0.0f;
}

// ---------------------------------------------------------------------------
// K3 from the mids: the y stage, the clip masks and the composite of a
// chunk in one pass.
//
// Per occupied level l (at most kMaxLevels, in level order): mids (2, S,
// ny_l, W), the value channel then the mask, z- and x-lerped (K6), and
// taps (S, H) float4 (w0, w1, r0, r1): the y tent's weights and rows at
// every slab and screen row (mids.py::tent_taps, rows stored as floats).
// The S slabs are the chunk's live ones.  Per pixel (y, x) and slab s:
//   swv = sum_l (w0 * mid_l[0, s, r0, x] + w1 * mid_l[0, s, r1, x])
//   sw  = the same over mid_l[1]
//   sw  = 0 unless scale[s] < t_stop[y, x], then unless >= t_start[y, x]
// then K4's classification and opacity and the front-to-back composite.

// Levels per launch (kernels.MAX_LEVELS): the by-value table holds every
// level a scene can have (cell widths are 1 << level over int32 corners,
// so at most 31 levels).  Up to kUnrolled levels are unrolled at compile
// time; more run in groups of kUnrolled, in level order.
constexpr int kMaxLevels = 32;
constexpr int kUnrolled = 8;
constexpr int kGrouped = kUnrolled + 1;  // the template argument for > 8
constexpr int kCols = 2;    // adjacent columns per thread (a float2)
constexpr int kBlockX = 32;  // columns per block
constexpr int kBlockRows = kThreads * kCols / kBlockX;  // 16

struct MidsLevel {
  const float* mids;   // (2, S, ny, W)
  const float4* taps;  // (S, H): w0, w1, r0, r1
  int ny;
};

struct MidsParams {
  MidsLevel lv[kMaxLevels];
  const float* scale;    // (S,)
  const float* t_start;  // (H, W) or null
  const float* t_stop;   // (H, W) or null
  const float* sec;      // (H, W)
  const float* lut;      // (n, 4)
  float* out;            // (4, H, W)
  int n_levels, S, H, W, n;
  float lo, hi, dz;
};

struct Pixel {
  float e, t_start, t_stop;
  float r, g, b, t;
};

__device__ __forceinline__ Pixel pixel_start(const MidsParams& p,
                                             size_t px) {
  Pixel q;
  q.e = p.dz * p.sec[px];
  q.t_start = p.t_start ? p.t_start[px] : 0.0f;
  q.t_stop = p.t_stop ? p.t_stop[px] : 0.0f;
  q.r = q.g = q.b = 0.0f;
  q.t = 1.0f;
  return q;
}

__device__ __forceinline__ void pixel_store(const MidsParams& p, size_t px,
                                            const Pixel& q) {
  const size_t hw = (size_t)p.H * p.W;
  p.out[px] = q.r;
  p.out[hw + px] = q.g;
  p.out[2 * hw + px] = q.b;
  p.out[3 * hw + px] = q.t;
}

// an invalid sample (sw <= 1e-20 after the masks) has a = 0, so it adds
// exactly nothing (r + 0 * c = r, T * 1 = T for the LUT's finite c): its
// classification is skipped
__device__ __forceinline__ void composite_valid(const MidsParams& p,
                                                const float4* s_lut,
                                                float scale, float sw,
                                                float swv, Pixel& q) {
  if (p.t_stop && !(scale < q.t_stop)) sw = 0.0f;
  if (p.t_start && !(scale >= q.t_start)) sw = 0.0f;
  if (!(sw > 1e-20f)) return;
  const float value = swv / sw;
  const float4 c = classify(s_lut, p.n, value, p.lo, p.hi);
  const float a = opacity(c.w, q.e);
  const float contrib = q.t * a;
  q.r = q.r + contrib * c.x;
  q.g = q.g + contrib * c.y;
  q.b = q.b + contrib * c.z;
  q.t = q.t * (1.0f - a);
}

// a thread's two adjacent columns of a mid row: one float2 load where
// the row's columns are aligned (W even), else one load per column, a
// column past W clamped to the last one
__device__ __forceinline__ float2 load_cols(const float* __restrict__ src,
                                            bool vec, int n_ok) {
  if (vec) return __ldg(reinterpret_cast<const float2*>(src));
  return make_float2(__ldg(src), __ldg(src + min(1, n_ok - 1)));
}

// Level l's share of one slab's sums at the thread's two columns: its
// taps and its 4 float2 mid loads started before any lerp, added to sw
// and swv in level order.  The grouped path's body only: the unrolled
// path keeps its own copy of this loop body, because calling this
// function there ran slower on the card for the same bits (PERF.md,
// section 6).
__device__ __forceinline__ void add_level(const MidsParams& p, int l, int s,
                                          int y, int x0, bool vec, int n_ok,
                                          float (&sw)[kCols],
                                          float (&swv)[kCols]) {
  const int W = p.W;
  const float* __restrict__ mids = p.lv[l].mids;
  const int plane = p.lv[l].ny * W;  // one slab's (ny, W)
  const int comp = plane * p.S;      // one component's (S, ny, W)
  const float4 tp = __ldg(p.lv[l].taps + s * p.H + y);
  const int o0 = s * plane + (int)tp.z * W + x0;
  const int o1 = s * plane + (int)tp.w * W + x0;
  const float2 v0 = load_cols(mids + o0, vec, n_ok);
  const float2 v1 = load_cols(mids + o1, vec, n_ok);
  const float2 m0 = load_cols(mids + comp + o0, vec, n_ok);
  const float2 m1 = load_cols(mids + comp + o1, vec, n_ok);
  swv[0] = swv[0] + (tp.x * v0.x + tp.y * v1.x);
  swv[1] = swv[1] + (tp.x * v0.y + tp.y * v1.y);
  sw[0] = sw[0] + (tp.x * m0.x + tp.y * m1.x);
  sw[1] = sw[1] + (tp.x * m0.y + tp.y * m1.y);
}

// K3: kCols adjacent columns per thread, 16 threads across a block's 32
// columns and 16 rows; one slab at a time.  L <= kUnrolled: the L levels
// unrolled at compile time (the level table's entries read as
// constants).  L == kGrouped: any count, in groups of kUnrolled levels,
// each group unrolled and its tail guarded, so the sums run over the
// levels in the same order and the whole sum is classified once.  The
// taps are shared by the thread's two pixels and, within a warp (2
// rows), by its 16 threads; a block's rows share a coarse level's mid
// rows through L1.  Grid (ceil(W / 32), ceil(H / 16)).
template <int L>
__global__ void __launch_bounds__(kThreads)
composite_mids_kernel(const __grid_constant__ MidsParams p) {
  __shared__ float4 s_lut[kMaxTexels];
  __shared__ float s_scale[kMaxSlabs];
  load_lut(p.lut, p.n, s_lut);
  for (int i = threadIdx.x; i < p.S; i += kThreads) s_scale[i] = p.scale[i];
  __syncthreads();
  constexpr int kTx = kBlockX / kCols;
  const int W = p.W, H = p.H, S = p.S;
  const int x0 = blockIdx.x * kBlockX + (threadIdx.x % kTx) * kCols;
  const int y = blockIdx.y * kBlockRows + threadIdx.x / kTx;
  if (x0 >= W || y >= H) return;
  const int n_ok = min(kCols, W - x0);
  const bool vec = W % kCols == 0 && n_ok == kCols;
  Pixel q[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    q[c] = pixel_start(p, (size_t)y * W + x0 + min(c, n_ok - 1));
  for (int s = 0; s < S; ++s) {
    float sw[kCols] = {}, swv[kCols] = {};
    if constexpr (L <= kUnrolled) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float* __restrict__ mids = p.lv[l].mids;
        const int plane = p.lv[l].ny * W;  // one slab's (ny, W)
        const int comp = plane * S;        // one component's (S, ny, W)
        const float4 tp = __ldg(p.lv[l].taps + s * H + y);
        const int o0 = s * plane + (int)tp.z * W + x0;
        const int o1 = s * plane + (int)tp.w * W + x0;
        const float2 v0 = load_cols(mids + o0, vec, n_ok);
        const float2 v1 = load_cols(mids + o1, vec, n_ok);
        const float2 m0 = load_cols(mids + comp + o0, vec, n_ok);
        const float2 m1 = load_cols(mids + comp + o1, vec, n_ok);
        swv[0] = swv[0] + (tp.x * v0.x + tp.y * v1.x);
        swv[1] = swv[1] + (tp.x * v0.y + tp.y * v1.y);
        sw[0] = sw[0] + (tp.x * m0.x + tp.y * m1.x);
        sw[1] = sw[1] + (tp.x * m0.y + tp.y * m1.y);
      }
    } else {
      for (int g = 0; g < p.n_levels; g += kUnrolled) {
#pragma unroll
        for (int i = 0; i < kUnrolled; ++i)
          if (g + i < p.n_levels)
            add_level(p, g + i, s, y, x0, vec, n_ok, sw, swv);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      composite_valid(p, s_lut, s_scale[s], sw[c], swv[c], q[c]);
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c < n_ok) pixel_store(p, (size_t)y * W + x0 + c, q[c]);
}

// K5: grid ceil(count / kThreads); out (4, count): r, g, b, a planes
__global__ void __launch_bounds__(kThreads)
xf_classify_kernel(const float* __restrict__ u,
                   const float* __restrict__ lut, float* __restrict__ out,
                   long long count, int n) {
  __shared__ float4 s_lut[kMaxTexels];
  load_lut(lut, n, s_lut);
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  const float x = u[i];
  // u lies in [0, n-1]; the clamp keeps a stray value inside the LUT
  const int k = max(min((int)floorf(x), n - 2), 0);
  const float f = x - (float)k;
  const float4 a = s_lut[k];
  const float4 b = s_lut[k + 1];
  out[i] = a.x + f * (b.x - a.x);
  out[count + i] = a.y + f * (b.y - a.y);
  out[2 * count + i] = a.z + f * (b.z - a.z);
  out[3 * count + i] = a.w + f * (b.w - a.w);
}

bool make_params(int S, int H, int W, int n, float lo, float hi, float dz,
                 XfParams* p) {
  if (S < 1 || H < 1 || W < 1 || n < 2 || n > kMaxTexels) return false;
  p->hw = (long long)H * W;
  p->S = S;
  p->n = n;
  p->lo = lo;
  p->hi = hi;
  p->dz = dz;
  return true;
}

}  // namespace

// K4: sw, swv (S, H, W), sec (H, W), lut (n, 4), out (4, S, H, W), all
// float32 contiguous.  Returns the launch's cudaError_t (0 = launched).
extern "C" int owx_classify_field(const void* sw, const void* swv,
                                  const void* sec, const void* lut,
                                  void* out, int S, int H, int W, int n,
                                  float lo, float hi, float dz,
                                  void* stream) {
  XfParams p;
  if (!sw || !swv || !sec || !lut || !out || S > 65535 ||
      !make_params(S, H, W, n, lo, hi, dz, &p))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((p.hw + kThreads - 1) / kThreads), S);
  classify_field_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)sw, (const float*)swv, (const float*)sec,
      (const float*)lut, (float*)out, p);
  return (int)cudaGetLastError();
}

// K5: u (count,) clamped texel coordinates in [0, n-1], lut (n, 4), out
// (4, count), all float32 contiguous.  Returns the launch's cudaError_t.
extern "C" int owx_xf_classify(const void* u, const void* lut, void* out,
                               long long count, int n, void* stream) {
  if (!u || !lut || !out || count < 1 || n < 2 || n > kMaxTexels ||
      (count + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((count + kThreads - 1) / kThreads);
  xf_classify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)lut, (float*)out, count, n);
  return (int)cudaGetLastError();
}

// K3 from the mids, one launch for a chunk's n_levels <= kMaxLevels occupied
// levels (0 gives a transparent chunk): per level l, mids[l] (2, S,
// ny[l], W) and taps[l] (S, H, 4); scale (S,), t_start / t_stop (H, W)
// or null, sec (H, W), lut (n, 4), out (4, H, W): r, g, b, T, all
// float32 contiguous.  Returns the launch's cudaError_t (0 = launched).
extern "C" int owx_composite_mids(const void* const* mids,
                                  const void* const* taps, const int* ny,
                                  int n_levels, const void* scale,
                                  const void* t_start, const void* t_stop,
                                  const void* sec, const void* lut,
                                  void* out, int S, int H, int W, int n,
                                  float lo, float hi, float dz,
                                  void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels || (n_levels && (!mids || !taps ||
      !ny)) || !scale || !sec || !lut || !out || S < 1 || S > kMaxSlabs ||
      H < 1 || W < 1 || n < 2 || n > kMaxTexels ||
      (long long)S * H > 0x7fffffffLL ||
      (H + kBlockRows - 1) / kBlockRows > 65535)
    return (int)cudaErrorInvalidValue;
  MidsParams p = {};
  for (int l = 0; l < n_levels; ++l) {
    // 32-bit element offsets within a level's mids
    if (!mids[l] || !taps[l] || ny[l] < 1 ||
        2LL * S * ny[l] * W > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    p.lv[l].mids = (const float*)mids[l];
    p.lv[l].taps = (const float4*)taps[l];
    p.lv[l].ny = ny[l];
  }
  p.scale = (const float*)scale;
  p.t_start = (const float*)t_start;
  p.t_stop = (const float*)t_stop;
  p.sec = (const float*)sec;
  p.lut = (const float*)lut;
  p.out = (float*)out;
  p.n_levels = n_levels;
  p.S = S;
  p.H = H;
  p.W = W;
  p.n = n;
  p.lo = lo;
  p.hi = hi;
  p.dz = dz;
  const dim3 grid((unsigned)((W + kBlockX - 1) / kBlockX),
                  (unsigned)((H + kBlockRows - 1) / kBlockRows));
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_levels) {
#define OWX_K3_CASE(L) \
  case L: \
    composite_mids_kernel<L><<<grid, kThreads, 0, st>>>(p); \
    break;
    OWX_K3_CASE(0) OWX_K3_CASE(1) OWX_K3_CASE(2) OWX_K3_CASE(3)
    OWX_K3_CASE(4) OWX_K3_CASE(5) OWX_K3_CASE(6) OWX_K3_CASE(7)
    OWX_K3_CASE(8)
#undef OWX_K3_CASE
    default:
      composite_mids_kernel<kGrouped><<<grid, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
