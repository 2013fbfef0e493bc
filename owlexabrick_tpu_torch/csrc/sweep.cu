// K1 for Hopper: the slab-sweep megakernel of one chunk.
//
// Replaces the TPU kernel owlexabrick_tpu/render/pallas_sweep.py
// (_make_kernel, body :152-885, launched by run_chunk's pallas_call at
// :1859).  Per (tr x tc) image tile and per slab of the chunk it
// computes the y-tent interpolation of every level's x-resampled mids
// (sw, swv), value = swv/sw, the transfer-function classification
// (compressed relu-PWL knots over the tile's two-sided knot window, or
// the dense range-limited 128-texel loop), the opacity correction
// (1-exp(-tau*e) for optical-depth channels, else 1-(1-a)^e with
// e = dz*w_s*sec), the channel merge, and the front-to-back composite
// with an absolute-transmittance carry.  With a surface stop (has_stop,
// the TPU kernel's t_slab/t_stop refs, pallas_sweep.py:247-249, tested at
// :510-511, :618-619, :660-663) a sample counts only where the slab's
// sweep parameter t_slab[s] lies strictly before the pixel's t_stop: the
// iso or geometry hit caps the volume interval (integrateVolume's
// t1 = min(t1, surface t)).  Its plain-torch twin is
// render/sweep.py::sweep_chunk_reference.
//
// What bounds it on this card: every active (slab, pixel) reads two
// lattice rows of each level's mids per component, about
// 2 * L * (C+1) * S * H * W * 4 bytes per chunk (~100-400 MB at 1080p),
// against ~40 flops of classification per sample.  That is far below
// the tensor-core ridge, so the kernel is memory- and issue-bound; the
// TPU's MXU contraction has no counterpart here.
//
// What this simple design does about it: one thread block per tile, so
// the reference's per-tile decisions stay exact (the act_f stride
// weight, the act_all_f dense branch, the block-wide max T > 0.005 test
// each slab, the skip of tiles earlier chunks saturated).  At 1080p that
// is 75 blocks of 1024 threads on 132 SMs.  Neighbouring threads take
// neighbouring columns, so each mid row read is coalesced; the channel
// count is a template argument, so the per-channel sums and knot windows
// stay in registers.
// The two taps are read straight from global memory (no window copy),
// and slab work is skipped wherever the reference skips it.  The r, g,
// b, T carry lives in the output images and the per-slab texel
// coordinates in a wrapper-allocated scratch image; both stay L2-resident
// (the whole 1080p frame is ~33 MB).  The kernel allocates nothing and
// launches on the caller's stream.
//
// Built with -fmad=false so each multiply and add rounds like the plain
// torch version's separate ops.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxCh = 4;
// 1024 threads (32 warps) per tile: with only one block per SM, more
// warps hide more load latency (measured against 512 in PERF.md)
constexpr int kThreads = 1024;

struct Params {
  const float* mids[kMaxLevels];  // (C+1, S, ny, W): channels, then mask
  int ny[kMaxLevels];
  float cw[kMaxLevels];
  float orgy_half[kMaxLevels];  // lattice y origin + 0.5 (exact)
  int n_levels, n_ch, S, H, W, tr, tc, n_rt, n_ct;
  int compressed, n_texels, m_knots, tau_mask, has_pt, has_stop;
  float dz;
  const float* ypos;     // (S, H)
  const float* sec;      // (H, W)
  const float* live;     // (S,)
  const float* act;      // (S, R, Ct)
  const float* act_all;  // (R, Ct)
  const float* prev_t;   // (H, W) or null
  const float* t_slab;   // (S,) or null: each slab's sweep parameter
  const float* t_stop;   // (H, W) or null: per-pixel stop parameter
  const float* dom;      // (C, 2)
  const float* kpos;     // (C, M)
  const float* ksd;      // (C, M, 4)
  const float* kbase;    // (C, 4)
  const float* kcum;     // (C, M+1, 8)
  const float* lut;      // (C, N, 4)
  const float* dlut;     // (C, N, 4)
  float* scratch_u;      // (C, H, W)
  float* out_r;
  float* out_g;
  float* out_b;
  float* out_t;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions: every thread calls, every thread gets the result.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // the previous reduction's readers are done with red
  if (lane == 0) red[wid] = v;
  __syncthreads();
  v = (lane < (int)(blockDim.x >> 5)) ? red[lane] : -INFINITY;
  return warp_max(v);
}

__device__ float block_min(float v, float* red) {
  v = warp_min(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  v = (lane < (int)(blockDim.x >> 5)) ? red[lane] : INFINITY;
  return warp_min(v);
}

template <int NCH>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const Params p) {
  __shared__ float red[32];
  const int ct = blockIdx.x, rt = blockIdx.y;
  const int npx = p.tr * p.tc;
  const int row0 = rt * p.tr, col0 = ct * p.tc;
  const size_t hw = (size_t)p.H * p.W;
  // out-of-bounds tile positions never classify; their transmittance
  // (0 with a carried image, else 1) only enters the tile max
  const float t_oob = p.has_pt ? 0.f : 1.f;

  float tmax = 0.f;
  for (int q = threadIdx.x; q < npx; q += blockDim.x) {
    const int i = row0 + q / p.tc, j = col0 + q % p.tc;
    float t = t_oob;
    if (i < p.H && j < p.W) {
      const size_t idx = (size_t)i * p.W + j;
      t = p.has_pt ? p.prev_t[idx] : 1.f;
      p.out_r[idx] = 0.f;
      p.out_g[idx] = 0.f;
      p.out_b[idx] = 0.f;
      p.out_t[idx] = t;
    }
    tmax = fmaxf(tmax, t);
  }
  tmax = block_max(tmax, red);
  // tiles every earlier chunk saturated do nothing at all
  if (!(tmax > 0.005f)) return;

  const bool all_act = p.act_all[rt * p.n_ct + ct] > 0.5f;
  const float n = (float)p.n_texels;
  const int nk = p.n_texels;
  const int m = p.m_knots;

  for (int s = 0; s < p.S; ++s) {
    // per-(slab, tile) step weight: 0 = no cell reaches the tile, k > 1 =
    // this slab stands in for k coarse-only slabs (adaptive stride)
    const float w_s =
        all_act ? 1.f : p.act[((size_t)s * p.n_rt + rt) * p.n_ct + ct];
    if (!(w_s > 0.f) || !(tmax > 0.005f) || !(p.live[s] > 0.f)) continue;

    // phase A: interpolate, store texel coordinates, reduce the window
    float umin[NCH], umax[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      umin[c] = n - 1.f;
      umax[c] = 0.f;
    }
    float any_ok = 0.f;
    for (int q = threadIdx.x; q < npx; q += blockDim.x) {
      const int i = row0 + q / p.tc, j = col0 + q % p.tc;
      if (i >= p.H || j >= p.W) continue;
      const size_t idx = (size_t)i * p.W + j;
      const float yp = p.ypos[(size_t)s * p.H + i];
      float sw = 0.f;
      float swv[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) swv[c] = 0.f;
      for (int l = 0; l < p.n_levels; ++l) {
        const int ny = p.ny[l];
        const float t = yp / p.cw[l];
        const float base = p.orgy_half[l];
        const float k0f = floorf(t - base);
        const int k0 = (int)k0f;
        const size_t cstride = (size_t)p.S * ny * p.W;
        const float* m0 = p.mids[l] + (size_t)s * ny * p.W + j;
#pragma unroll
        for (int tap = 0; tap < 2; ++tap) {
          const int k = k0 + tap;
          if (k < 0 || k >= ny) continue;
          const float qk = t - (base + (k0f + (float)tap));
          const float wk = fmaxf(1.f - fabsf(qk), 0.f);
          const float* r = m0 + (size_t)k * p.W;
          sw = sw + wk * __ldg(r + NCH * cstride);
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            swv[c] = swv[c] + wk * __ldg(r + c * cstride);
        }
      }
      // the stop is strict: a slab exactly at the surface does not count
      const bool ok = sw > 1e-20f &&
                      (!p.has_stop || p.t_slab[s] < p.t_stop[idx]);
      const float denom = ok ? sw : 1.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float lo = p.dom[2 * c], hi = p.dom[2 * c + 1];
        const float value = swv[c] / denom;
        float sc = (n - 1.f) * (value - lo) / ((hi - lo) + 1e-20f);
        sc = fminf(fmaxf(sc + 0.5f, 0.f), n - 1.f) / (n - 1.f);
        const float ur = fminf(fmaxf(sc * n - 0.5f, 0.f), n - 1.f);
        p.scratch_u[c * hw + idx] = ok ? ur : -1.f;
        if (ok) {
          umin[c] = fminf(umin[c], ur);
          umax[c] = fmaxf(umax[c], ur);
        }
      }
      if (ok) any_ok = 1.f;
    }
    if (!(block_max(any_ok, red) > 0.f)) continue;
    int lo_k[NCH], hi_k[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float u_min = block_min(umin[c], red);
      const float u_max = block_max(umax[c], red);
      if (p.compressed) {
        // two-sided knot window: knots at or below the tile's min fold
        // into the prefix sums, knots at or past its max contribute 0
        int a = 0, b = 0;
        for (int jk = 0; jk < m; ++jk) {
          const float pos = p.kpos[c * m + jk];
          a += pos <= u_min;
          b += pos < u_max;
        }
        lo_k[c] = a;
        hi_k[c] = b;
      } else {
        lo_k[c] = min(max((int)floorf(u_min), 0), nk - 2);
        hi_k[c] = min(max((int)floorf(u_max), 0), nk - 2);
      }
    }

    // phase B: classify, merge channels, composite
    const float dzw = p.dz * w_s;
    float tloc = 0.f;
    for (int q = threadIdx.x; q < npx; q += blockDim.x) {
      const int i = row0 + q / p.tc, j = col0 + q % p.tc;
      if (i >= p.H || j >= p.W) {
        tloc = fmaxf(tloc, t_oob);
        continue;
      }
      const size_t idx = (size_t)i * p.W + j;
      float trun = p.out_t[idx];
      if (p.scratch_u[idx] < 0.f) {  // no field support here
        tloc = fmaxf(tloc, trun);
        continue;
      }
      const float e = dzw * p.sec[idx];
      float slab_a = 0.f, slab_r = 0.f, slab_g = 0.f, slab_b = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float u = p.scratch_u[c * hw + idx];
        float cr, cg, cb, ca;
        if (p.compressed) {
          const float* cum = p.kcum + ((size_t)c * (m + 1) + lo_k[c]) * 8;
          const float* bs = p.kbase + c * 4;
          cr = (bs[0] + u * cum[0]) - cum[4];
          cg = (bs[1] + u * cum[1]) - cum[5];
          cb = (bs[2] + u * cum[2]) - cum[6];
          ca = (bs[3] + u * cum[3]) - cum[7];
          for (int jk = lo_k[c]; jk < hi_k[c]; ++jk) {
            const float ramp = fmaxf(u - p.kpos[c * m + jk], 0.f);
            const float* sd = p.ksd + ((size_t)c * m + jk) * 4;
            cr = cr + ramp * sd[0];
            cg = cg + ramp * sd[1];
            cb = cb + ramp * sd[2];
            ca = ca + ramp * sd[3];
          }
        } else {
          const float* l0 = p.lut + ((size_t)c * nk + lo_k[c]) * 4;
          cr = l0[0];
          cg = l0[1];
          cb = l0[2];
          ca = l0[3];
          for (int kk = lo_k[c]; kk <= hi_k[c]; ++kk) {
            const float ramp = fminf(fmaxf(u - (float)kk, 0.f), 1.f);
            const float* d = p.dlut + ((size_t)c * nk + kk + 1) * 4;
            cr = cr + ramp * d[0];
            cg = cg + ramp * d[1];
            cb = cb + ramp * d[2];
            ca = ca + ramp * d[3];
          }
        }
        if (p.compressed && ((p.tau_mask >> c) & 1)) {
          // optical depth: 1-(1-a)^e == 1-exp(-tau*e), one transcendental
          ca = 1.f - expf(-fmaxf(ca, 0.f) * e);
        } else {
          ca = 1.f - powf(fmaxf(1.f - ca, 0.f), e);
        }
        const float contrib = (1.f - slab_a) * ca;
        slab_r = slab_r + contrib * cr;
        slab_g = slab_g + contrib * cg;
        slab_b = slab_b + contrib * cb;
        slab_a = slab_a + contrib;
      }
      p.out_r[idx] = p.out_r[idx] + trun * slab_r;
      p.out_g[idx] = p.out_g[idx] + trun * slab_g;
      p.out_b[idx] = p.out_b[idx] + trun * slab_b;
      trun = trun * (1.f - slab_a);
      p.out_t[idx] = trun;
      tloc = fmaxf(tloc, trun);
    }
    tmax = block_max(tloc, red);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Argument packs:
//   ptrs: ypos, sec, live, act, act_all, prev_t (or 0), dom, kpos, ksd,
//         kbase, kcum, lut, dlut, scratch_u, out_r, out_g, out_b, out_t,
//         t_slab (or 0), t_stop (or 0), then one mids pointer per level
//   ints: n_levels, n_ch, S, H, W, tr, tc, compressed, n_texels, m_knots,
//         tau_mask, has_pt, has_stop, then ny per level
//   flts: dz, then cw per level, then lattice y origin per level
// Returns the launch's cudaError_t (0 = launched).
extern "C" int owx_sweep_chunk(const uint64_t* ptrs, int n_ptrs,
                               const int* ints, int n_ints,
                               const float* flts, int n_flts,
                               void* stream) {
  if (n_ints < 13) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.n_levels = ints[0];
  p.n_ch = ints[1];
  p.S = ints[2];
  p.H = ints[3];
  p.W = ints[4];
  p.tr = ints[5];
  p.tc = ints[6];
  p.compressed = ints[7];
  p.n_texels = ints[8];
  p.m_knots = ints[9];
  p.tau_mask = ints[10];
  p.has_pt = ints[11];
  p.has_stop = ints[12];
  const int L = p.n_levels;
  if (L < 1 || L > kMaxLevels || p.n_ch < 1 || p.n_ch > kMaxCh ||
      n_ints != 13 + L || n_flts != 1 + 2 * L || n_ptrs != 20 + L ||
      p.tr < 1 || p.tc < 1 || p.n_texels < 2)
    return (int)cudaErrorInvalidValue;
  p.n_rt = (p.H + p.tr - 1) / p.tr;
  p.n_ct = (p.W + p.tc - 1) / p.tc;
  p.dz = flts[0];
  for (int l = 0; l < L; ++l) {
    p.ny[l] = ints[13 + l];
    p.cw[l] = flts[1 + l];
    p.orgy_half[l] = flts[1 + L + l] + 0.5f;
    p.mids[l] = (const float*)ptrs[20 + l];
  }
  p.ypos = (const float*)ptrs[0];
  p.sec = (const float*)ptrs[1];
  p.live = (const float*)ptrs[2];
  p.act = (const float*)ptrs[3];
  p.act_all = (const float*)ptrs[4];
  p.prev_t = (const float*)ptrs[5];
  p.dom = (const float*)ptrs[6];
  p.kpos = (const float*)ptrs[7];
  p.ksd = (const float*)ptrs[8];
  p.kbase = (const float*)ptrs[9];
  p.kcum = (const float*)ptrs[10];
  p.lut = (const float*)ptrs[11];
  p.dlut = (const float*)ptrs[12];
  p.scratch_u = (float*)ptrs[13];
  p.out_r = (float*)ptrs[14];
  p.out_g = (float*)ptrs[15];
  p.out_b = (float*)ptrs[16];
  p.out_t = (float*)ptrs[17];
  p.t_slab = (const float*)ptrs[18];
  p.t_stop = (const float*)ptrs[19];
  if (p.has_pt && !p.prev_t) return (int)cudaErrorInvalidValue;
  if (p.has_stop && !(p.t_slab && p.t_stop))
    return (int)cudaErrorInvalidValue;
  if (p.compressed ? !(p.kpos && p.ksd && p.kbase && p.kcum)
                   : !(p.lut && p.dlut))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.n_ct, p.n_rt);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (p.n_ch) {  // the channel count is a template argument so the
                     // per-channel arrays stay in registers
    case 1: sweep_kernel<1><<<grid, kThreads, 0, st>>>(p); break;
    case 2: sweep_kernel<2><<<grid, kThreads, 0, st>>>(p); break;
    case 3: sweep_kernel<3><<<grid, kThreads, 0, st>>>(p); break;
    default: sweep_kernel<4><<<grid, kThreads, 0, st>>>(p); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* owx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
