// K2a and K2b for Hopper: the two-pass homography warp of shear-warp.
//
// Replaces the TPU kernels owlexabrick_tpu/render/pallas_warp.py
// _make_pass1 (:71, pallas_call :271) and _make_pass2 (:120, pallas_call
// :308), launched by _warp_pallas_impl.  Their plain-torch twins are
// render/warp.py::warp_pass1_reference / warp_pass2_reference.
//
//   K2a: V[c, v, a] = Catmull-Rom along lattice column a at row j(v, a),
//        the closed-form inverse of the screen->lattice homography's
//        i-equation, over (h_pad, iw).
//   K2b: out[v*W + u, c] = Catmull-Rom along row v of V at column i(u, v);
//        rgb clamped at >= 0, channel 3 to [0, 1], over (H, W).
//
// The reference's window clamps stay, because they change the image:
// each (8, 128) tile read a window of b lattice rows (columns) starting
// at wj0 (wi0)[tile], and clipped its coordinate to [1, b - 2] inside it.
// The wrapper computes the per-tile starts exactly as the reference does
// (float32, from the tile corners) and passes them in; each thread looks
// up its tile's start.  The reference summed Catmull-Rom weights over the
// whole window; the kernel takes the four taps floor(x)-1 .. floor(x)+2,
// which is the same sum (the kernel vanishes at distance >= 2), and gives
// weight 0 to the one tap that can fall past the window's end.
//
// What bounds it on this card: at 1080p each pass reads and writes a few
// tens of MB (the 2944x1624 lattice image, the (C, 1080, 2944) V planes,
// the 1920x1080 screen) and does ~30 flops per output value, so both
// passes are memory-bound and small.  The design is one thread per output
// element; neighbouring threads take neighbouring columns, so the taps of
// a warp fall on a few neighbouring rows and coalesce.  The channel count
// is a template argument so the per-channel sums stay in registers.  No
// shared memory, TMA or tensor cores are needed at this size.
//
// Built with -fmad=false so each multiply and add rounds like the plain
// torch version's separate ops; the kernels allocate nothing and launch
// on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTR = 8;    // reference tile rows
constexpr int kTC = 128;  // reference tile columns
constexpr int kBX = 128;  // block: 128 columns x 4 rows
constexpr int kBY = 4;

struct WarpParams {
  float h[16];  // hom (2, 2, 3), jx, jy, shift_i, shift_j
  float half_w, half_h;  // width / 2, height / 2 (exact in float)
  float x_hi;   // global clip of the pass's coordinate: n_src - 2 - 1e-4
  int b;        // window length (bj for K2a, bi for K2b)
  int iw, ih, width, height, h_pad, n_tc;  // n_tc: tiles per row of starts
  long long sp, sc;  // K2a input strides (pixel, channel), in floats
};

__device__ __forceinline__ float catmull_rom(float d) {
  const float d2 = d * d;
  const float d3 = d2 * d;
  const float near = 1.5f * d3 - 2.5f * d2 + 1.0f;
  const float far = -0.5f * d3 + 2.5f * d2 - 4.0f * d + 2.0f;
  return d <= 1.0f ? near : (d < 2.0f ? far : 0.0f);
}

__device__ __forceinline__ float safe_div(float n, float d) {
  const float mag = fmaxf(fabsf(d), 1e-20f);
  return n / (d < 0.0f ? -mag : mag);
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

template <int C>
__global__ void __launch_bounds__(kBX * kBY)
warp_pass1_kernel(const float* __restrict__ img, const int* __restrict__ wj0,
                  float* __restrict__ out, WarpParams p) {
  const int a = blockIdx.x * kBX + threadIdx.x;  // lattice column
  const int v = blockIdx.y * kBY + threadIdx.y;  // screen row (padded)
  if (a >= p.iw || v >= p.h_pad) return;
  const float* h = p.h;
  const float vc = (float)v + (h[13] - p.half_h);
  const float af = (float)a + h[14];
  const float uc = safe_div(af * (h[4] * vc + h[5]) - h[1] * vc - h[2],
                            h[0] - af * h[3]);
  float j = safe_div(h[6] * uc + h[7] * vc + h[8],
                     h[9] * uc + h[10] * vc + h[11]) - h[15];
  const int j0w = wj0[(v / kTR) * p.n_tc + a / kTC];
  j = clip(j, 1.0f, p.x_hi) - (float)j0w;
  j = clip(j, 1.0f, (float)(p.b - 2));
  const float k0 = floorf(j);
  float acc[C];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float k = k0 + (float)(t - 1);
    const float w = k <= (float)(p.b - 1) ? catmull_rom(fabsf(j - k)) : 0.0f;
    const int row = min(max(j0w + (int)k, 0), p.ih - 1);
    const float* src = img + ((long long)row * p.iw + a) * p.sp;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float term = w * src[c * p.sc];
      acc[c] = t == 0 ? term : acc[c] + term;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    out[((long long)c * p.h_pad + v) * p.iw + a] = acc[c];
}

template <int C>
__global__ void __launch_bounds__(kBX * kBY)
warp_pass2_kernel(const float* __restrict__ vimg, const int* __restrict__ wi0,
                  float* __restrict__ out, WarpParams p) {
  const int u = blockIdx.x * kBX + threadIdx.x;  // screen column
  const int v = blockIdx.y * kBY + threadIdx.y;  // screen row
  if (u >= p.width || v >= p.height) return;
  const float* h = p.h;
  const float uf = (float)u + (h[12] - p.half_w);
  const float vf = (float)v + (h[13] - p.half_h);
  float i = safe_div(h[0] * uf + h[1] * vf + h[2],
                     h[3] * uf + h[4] * vf + h[5]) - h[14];
  const int i0w = wi0[(v / kTR) * p.n_tc + u / kTC];
  i = clip(i, 1.0f, p.x_hi) - (float)i0w;
  i = clip(i, 1.0f, (float)(p.b - 2));
  const float k0 = floorf(i);
  float acc[C];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float k = k0 + (float)(t - 1);
    const float w = k <= (float)(p.b - 1) ? catmull_rom(fabsf(i - k)) : 0.0f;
    const int col = min(max(i0w + (int)k, 0), p.iw - 1);
    const float* src = vimg + (long long)v * p.iw + col;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float term = w * src[(long long)c * p.h_pad * p.iw];
      acc[c] = t == 0 ? term : acc[c] + term;
    }
  }
  float* dst = out + ((long long)v * p.width + u) * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    dst[c] = c == 3 ? clip(acc[c], 0.0f, 1.0f) : fmaxf(acc[c], 0.0f);
}

WarpParams make_params(const float* hp, int iw, int ih, int width,
                       int height, int b) {
  WarpParams p;
  for (int k = 0; k < 16; ++k) p.h[k] = hp[k];
  p.half_w = (float)(width * 0.5);
  p.half_h = (float)(height * 0.5);
  p.b = b;
  p.iw = iw;
  p.ih = ih;
  p.width = width;
  p.height = height;
  p.h_pad = (height + kTR - 1) / kTR * kTR;
  return p;
}

}  // namespace

// K2a: img (ih*iw, C) with strides (sp, sc) in floats; wj0 (n_vt, iw/128)
// int32; out (C, h_pad, iw) float32.  hp: 16 host floats.
extern "C" int owx_warp_pass1(const void* img, long long sp, long long sc,
                              const void* wj0, void* out, const float* hp,
                              int n_ch, int iw, int ih, int height, int bj,
                              void* stream) {
  if (!img || !wj0 || !out || !hp || n_ch < 1 || n_ch > 4 || iw < kTC ||
      iw % kTC || height < 1 || bj < 4 || bj > ih)
    return (int)cudaErrorInvalidValue;
  WarpParams p = make_params(hp, iw, ih, 0, height, bj);
  p.x_hi = (float)((double)ih - 2.0 - 1e-4);
  p.n_tc = iw / kTC;
  p.sp = sp;
  p.sc = sc;
  const dim3 block(kBX, kBY);
  const dim3 grid(iw / kBX, (p.h_pad + kBY - 1) / kBY);
  const float* in = (const float*)img;
  const int* w0 = (const int*)wj0;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_ch) {
    case 1: warp_pass1_kernel<1><<<grid, block, 0, st>>>(in, w0, o, p); break;
    case 2: warp_pass1_kernel<2><<<grid, block, 0, st>>>(in, w0, o, p); break;
    case 3: warp_pass1_kernel<3><<<grid, block, 0, st>>>(in, w0, o, p); break;
    default: warp_pass1_kernel<4><<<grid, block, 0, st>>>(in, w0, o, p); break;
  }
  return (int)cudaGetLastError();
}

// K2b: vimg (C, h_pad, iw) float32 contiguous; wi0 (n_vt, ceil(W/128))
// int32; out (height*width, C) float32.  hp: 16 host floats.
extern "C" int owx_warp_pass2(const void* vimg, const void* wi0, void* out,
                              const float* hp, int n_ch, int iw, int width,
                              int height, int bi, void* stream) {
  if (!vimg || !wi0 || !out || !hp || n_ch < 1 || n_ch > 4 || iw < kTC ||
      iw % kTC || width < 1 || height < 1 || bi < 4 || bi > iw)
    return (int)cudaErrorInvalidValue;
  WarpParams p = make_params(hp, iw, 0, width, height, bi);
  p.sp = p.sc = 0;  // K2b reads V (C, h_pad, iw) contiguous
  p.x_hi = (float)((double)iw - 2.0 - 1e-4);
  p.n_tc = (width + kTC - 1) / kTC;
  const dim3 block(kBX, kBY);
  const dim3 grid((width + kBX - 1) / kBX, (height + kBY - 1) / kBY);
  const float* in = (const float*)vimg;
  const int* w0 = (const int*)wi0;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_ch) {
    case 1: warp_pass2_kernel<1><<<grid, block, 0, st>>>(in, w0, o, p); break;
    case 2: warp_pass2_kernel<2><<<grid, block, 0, st>>>(in, w0, o, p); break;
    case 3: warp_pass2_kernel<3><<<grid, block, 0, st>>>(in, w0, o, p); break;
    default: warp_pass2_kernel<4><<<grid, block, 0, st>>>(in, w0, o, p); break;
  }
  return (int)cudaGetLastError();
}
