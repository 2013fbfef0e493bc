// K3, K4 and K5 for Hopper: transfer-function classification of the
// einsum lane's reconstructed slab fields, and the stand-alone LUT lookup.
//
// Replaces the TPU kernels owlexabrick_tpu/render/pallas_xf.py
// _composite_chunk_kernel (:178, pallas_call :293, K3),
// _classify_field_kernel (:46, pallas_call :155, K4) and _xf_kernel
// (:24, pallas_call :329 in xf_classify, K5).  Their plain-torch twins
// are render/classify.py::composite_chunk_reference,
// classify_field_reference and xf_classify_reference.
//
//   K4: per (slab, pixel): value = swv/sw (invalid where sw <= 1e-20),
//       texel coordinate, LUT rgba, a = 1-(1-a)^(dz*sec), a = 0 where
//       invalid; out r, g, b, a planes, each (S, H, W).
//   K3: the same classification per slab, the live[s] gate, and the
//       front-to-back composite over the chunk's S slabs; out
//       premultiplied r, g, b and the transmittance T, each (H, W).
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
// the walk are gone.  Every sample is classified, invalid ones at
// value = swv/1, and only alpha is zeroed, so no inf or NaN enters.
//
// What bounds them on this card: bytes.  K4 reads sw and swv and writes
// four planes, ~24 bytes per (slab, pixel) against ~30 flops; K3 reads
// 8 bytes per (slab, pixel) and writes 16 per pixel.  Both are far below
// the ridge of 67 TFLOP/s fp32 over 3.35 TB/s.  The design is one thread
// per (slab, pixel) for K4 and one per pixel for K3, which loops over
// the slabs with its r, g, b, T in registers and live[] in shared
// memory; neighbouring threads take neighbouring pixels, so every read
// and write is coalesced.  K3 skips a dead slab's reads: a = 0 there,
// which adds exactly nothing.  K5 (the TPU kernel summed 127 clamp ramps
// per element) reads 4 bytes and writes 16 per element: its bound is
// 20 B per element over 3.35 TB/s.  One thread per element lerps the
// 2 KB LUT in shared memory, as K3/K4 do, with coalesced reads of u and
// writes of the four planes.
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

// K3: grid ceil(H*W / kThreads); out (4, H, W): r, g, b, T
__global__ void __launch_bounds__(kThreads)
composite_chunk_kernel(const float* __restrict__ sw,
                       const float* __restrict__ swv,
                       const float* __restrict__ sec,
                       const float* __restrict__ live,
                       const float* __restrict__ lut,
                       float* __restrict__ out, XfParams p) {
  __shared__ float4 s_lut[kMaxTexels];
  __shared__ float s_live[kMaxSlabs];
  load_lut(lut, p.n, s_lut);
  for (int i = threadIdx.x; i < p.S; i += blockDim.x) s_live[i] = live[i];
  __syncthreads();
  const long long px = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (px >= p.hw) return;
  const float e = p.dz * sec[px];
  float r = 0.0f, g = 0.0f, b = 0.0f, t = 1.0f;
  for (int s = 0; s < p.S; ++s) {
    if (!(s_live[s] > 0.0f)) continue;
    const long long i = (long long)s * p.hw + px;
    const float w = sw[i];
    const bool ok = w > 1e-20f;
    const float value = swv[i] / (ok ? w : 1.0f);
    const float4 c = classify(s_lut, p.n, value, p.lo, p.hi);
    const float a = ok ? opacity(c.w, e) : 0.0f;
    const float contrib = t * a;
    r = r + contrib * c.x;
    g = g + contrib * c.y;
    b = b + contrib * c.z;
    t = t * (1.0f - a);
  }
  out[px] = r;
  out[p.hw + px] = g;
  out[2 * p.hw + px] = b;
  out[3 * p.hw + px] = t;
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

// K3: sw, swv (S, H, W), sec (H, W), live (S,) 0/1, lut (n, 4), out
// (4, H, W), all float32 contiguous.  Returns the launch's cudaError_t.
extern "C" int owx_composite_chunk(const void* sw, const void* swv,
                                   const void* sec, const void* live,
                                   const void* lut, void* out, int S,
                                   int H, int W, int n, float lo, float hi,
                                   float dz, void* stream) {
  XfParams p;
  if (!sw || !swv || !sec || !live || !lut || !out || S > kMaxSlabs ||
      !make_params(S, H, W, n, lo, hi, dz, &p))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((p.hw + kThreads - 1) / kThreads);
  composite_chunk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)sw, (const float*)swv, (const float*)sec,
      (const float*)live, (const float*)lut, (float*)out, p);
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
