// K1 for Hopper: the slab-sweep megakernel of one chunk.
//
// Replaces the TPU kernel owlexabrick_tpu/render/pallas_sweep.py
// (_make_kernel, body :152-885, launched by run_chunk's pallas_call at
// :1859).  Per (tr x tc) image tile and per slab of the chunk it
// computes the y-tent interpolation of every level's x-resampled mids
// (sw, swv), value = swv/sw, the transfer-function classification
// (compressed relu-PWL knots from the tile's knot window, or the dense
// range-limited 128-texel loop), the opacity correction (1-exp(-tau*e)
// for optical-depth channels, else 1-(1-a)^e with e = dz*w_s*sec), the
// channel merge, and the front-to-back composite with an
// absolute-transmittance carry.  With a surface stop (has_stop, the TPU
// kernel's t_slab/t_stop refs, pallas_sweep.py:247-249, tested at
// :510-511, :618-619, :660-663) a sample counts only where the slab's
// sweep parameter t_slab[s] lies strictly before the pixel's t_stop: the
// iso or geometry hit caps the volume interval (integrateVolume's
// t1 = min(t1, surface t)).  Its plain-torch twin is
// render/sweep.py::sweep_chunk_reference.
//
// What bounds it on this card: every active (slab, pixel) reads two
// lattice rows of each level's mids per component, about
// 2 * L * (C+1) * S * H * W * 4 bytes per chunk (~100-400 MB at 1080p),
// against ~40 flops of classification per sample plus ~10 per knot
// walked.  That is far below the tensor-core ridge (the y contraction is
// two taps per level), so the kernel is bound by memory and by the
// instructions it issues.
//
// The design:
// * One thread-block cluster of kCluster blocks per reference tile: the
//   tile's rows are split over the cluster's blocks (216 rows at 1080p:
//   27 each, 600 blocks instead of 75 tiles), so every SM works while
//   every per-tile decision of the reference stays tile-wide.  Those
//   decisions (the stride weight w_s and act_all, live[s], the skip of
//   tiles earlier chunks saturated, the per-slab max T > 0.005 test with
//   out-of-bounds lanes at t_oob, any_ok, the knot window's lower end
//   from the tile's u_min) come from one record per slab, {max T, any_ok,
//   u_min per channel}, reduced over the block's warps and then over the
//   cluster's blocks through distributed shared memory: one block-wide
//   and one cluster-wide round per slab, beside the barrier that
//   publishes the slab's taps.  Every skip is taken on cluster-reduced
//   values, so every block reaches the same barriers.
//   Phase A (interpolation) of a slab runs before that slab's saturation
//   test is known; phase B (classification) stays gated, so the image
//   does not change.
// * Each pixel stops its knot walk at its own value: knots from the
//   tile's lo_k up to the first with pos >= u (dense: up to floor(u)).
//   The knots past it add exact zeros (relu(u - pos) = 0; the TPU kernel
//   says so at pallas_sweep.py:758-761), so the tile's upper window end
//   is not needed.  The knot tables (or the dense LUT's differences) sit
//   in shared memory.
// * The two rows and tent weights of each (row, level) are computed once
//   per slab into shared memory, with the same operations.
// * A thread owns fixed pixels of its block's rows for the whole chunk;
//   their r, g, b, T, sec and per-channel texel coordinate stay in shared
//   memory (the carry), prev_t is read once and the outputs are written
//   once.  A tile too large for shared memory (a 256x512 tile) keeps the
//   same carry in a wrapper-allocated global scratch instead.
//
// Per sample the arithmetic is the reference's, in its order (levels,
// taps, channels; the strict stop; expf / powf opacity), built with
// -fmad=false so each multiply and add rounds like the plain torch
// version's separate ops.  The kernel allocates nothing and launches on
// the caller's stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// The per-level table (mids pointer, ny, cw, lattice y origin) is passed
// by value and holds every level of the grids: a cell's width is
// 1 << level over int32 corners (core/types.py), so no scene has more than
// 31 distinct levels (0..30), and 32 entries hold any of them.  The
// per-row taps in shared memory grow with the count: rpb * L float4
// (27 rows * 16 levels = 6.9 KB at 1080p), and a carry that no longer
// fits beside them moves to the global scratch, so the launch does not
// fail.
constexpr int kMaxLevels = 32;
constexpr int kMaxCh = 10;  // MAX_CHANNELS of the data model
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// blocks per tile (the portable maximum): measured faster at 1080p than
// 4, 2 and 1, and faster with the carry on chip than in global memory
// (PERF.md)
constexpr int kCluster = 8;

// The launch shape of one chunk: a cluster of k blocks per tile, each
// holding rpb rows; dynamic shared memory (in floats) = the warp records,
// the cluster record (two slots), the classification tables, the per-row
// taps and, where it fits, the carry.
struct Shape {
  int k, rpb, cap, off_crec, off_tab, off_taps, off_carry, carry_floats;
  int smem_bytes, on_chip;
  dim3 grid;
};

struct Params {
  const float* mids[kMaxLevels];  // (C+1, S, ny, W): channels, then mask
  int ny[kMaxLevels];
  float cw[kMaxLevels];
  float orgy_half[kMaxLevels];  // lattice y origin + 0.5 (exact)
  int n_levels, n_ch, S, H, W, tr, tc, n_rt, n_ct;
  int compressed, n_texels, m_knots, tau_mask, has_pt, has_stop;
  float dz;
  Shape shape;
  const float* ypos;     // (S, H)
  const float* sec;      // (H, W)
  const float* live;     // (S,)
  const float* act;      // (S, R, Ct)
  const float* act_all;  // (R, Ct)
  const float* prev_t;   // (H, W) or null
  const float* t_slab;   // (S,) or null: each slab's sweep parameter
  const float* t_stop;   // (H, W) or null: per-pixel stop parameter
  const unsigned char* done;  // (1,) bool or null: the early exit's flag
  const float* dom;      // (C, 2)
  const float* kpos;     // (C, M), sorted, padded with N
  const float* ksd;      // (C, M, 4)
  const float* kbase;    // (C, 4)
  const float* kcum;     // (C, M+1, 8)
  const float* lut;      // (C, N, 4)
  const float* dlut;     // (C, N, 4)
  float* carry_g;        // global carry when it does not fit on chip
  float* out_r;
  float* out_g;
  float* out_b;
  float* out_t;
};

__host__ __device__ constexpr int rec_floats(int n_ch) { return 2 + n_ch; }
__host__ __device__ constexpr int carry_planes(int n_ch) { return 5 + n_ch; }

int round4(int v) { return (v + 3) & ~3; }

Shape make_shape(const Params& p, int smem_limit) {
  Shape s = {};
  s.k = kCluster;
  s.rpb = (p.tr + s.k - 1) / s.k;
  s.cap = s.rpb * p.tc;
  const int f = rec_floats(p.n_ch);
  s.off_crec = round4(kWarps * f);
  s.off_tab = round4(s.off_crec + 2 * f);
  const int tab = p.compressed ? p.n_ch * p.m_knots * 5
                               : p.n_ch * p.n_texels * 4;
  s.off_taps = round4(s.off_tab + tab);
  s.off_carry = s.off_taps + s.rpb * p.n_levels * 4;
  const long long carry = (long long)carry_planes(p.n_ch) * s.cap;
  s.on_chip = (s.off_carry + carry) * 4 <= smem_limit;
  s.smem_bytes = (int)((s.off_carry + (s.on_chip ? carry : 0)) * 4);
  s.grid = dim3(p.n_ct * s.k, p.n_rt);
  s.carry_floats =
      s.on_chip ? 0 : (int)(carry * s.grid.x * s.grid.y);
  return s;
}

// Reduce the slab record {max T, any_ok, u_min[c]} over the tile: warps,
// then the block, then the cluster's blocks (each block's record sits in
// slot `parity` of its shared memory; every block reads its peers' after
// the cluster barrier, and the other slot is written next, so one
// barrier per round suffices).  Every thread gets the tile's values.
template <int NCH>
__device__ void tile_reduce(float (&rec)[rec_floats(NCH)], float* wrec,
                            float* crec, int parity, int k,
                            const cg::cluster_group& cluster) {
  constexpr int F = rec_floats(NCH);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float v = rec[f];
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = f < 2 ? fmaxf(v, w) : fminf(v, w);
    }
    rec[f] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) wrec[wid * F + f] = rec[f];
  }
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float v = rec[f];
      if (lane < kWarps) v = wrec[lane * F + f];
      for (int o = 16; o > 0; o >>= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, v, o);
        v = f < 2 ? fmaxf(v, w) : fminf(v, w);
      }
      if (lane == 0) crec[parity * F + f] = v;
    }
  }
  cluster.sync();
  for (int r = 0; r < k; ++r) {
    const float* peer = cluster.map_shared_rank(crec + parity * F, r);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float v = peer[f];
      rec[f] = r == 0 ? v : (f < 2 ? fmaxf(rec[f], v) : fminf(rec[f], v));
    }
  }
}

// The in-bounds pixels of a block's rows, dealt to its threads in a fixed
// order: pixel q (its carry slot) at block row lr, tile column col.
struct Span {
  int rows, cols, dr, dc;
  __device__ Span(int rows_in, int cols_in)
      : rows(rows_in), cols(cols_in), dr(kThreads / cols_in),
        dc(kThreads % cols_in) {}
  template <class F>
  __device__ __forceinline__ void each(F&& f) const {
    int lr = threadIdx.x / cols, col = threadIdx.x % cols;
    for (int q = threadIdx.x; lr < rows; q += kThreads) {
      f(q, lr, col);
      col += dc;
      lr += dr;
      if (col >= cols) {
        col -= cols;
        ++lr;
      }
    }
  }
};

template <int NCH>
__global__ void __launch_bounds__(kThreads, NCH <= 2 ? 2 : 1)
sweep_kernel(const __grid_constant__ Params p) {
  constexpr int F = rec_floats(NCH);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ct = blockIdx.x / p.shape.k, rt = blockIdx.y;
  const int row0 = rt * p.tr, col0 = ct * p.tc;
  const int r0 = rank * p.shape.rpb, r1 = min(r0 + p.shape.rpb, p.tr);
  const int rows_in = max(min(r1, p.H - row0) - r0, 0);
  const Span span(rows_in, min(p.tc, p.W - col0));
  // out-of-bounds tile positions never classify; their transmittance
  // (0 with a carried image, else 1) only enters the tile max
  const float t_oob = p.has_pt ? 0.f : 1.f;
  const bool has_oob = r1 > r0 && (row0 + r1 > p.H || col0 + p.tc > p.W);
  const float n = (float)p.n_texels;
  const int nk = p.n_texels, m = p.m_knots, cap = p.shape.cap;

  float* wrec = sm;
  float* crec = sm + p.shape.off_crec;
  float4* taps = reinterpret_cast<float4*>(sm + p.shape.off_taps);
  float* carry =
      p.shape.on_chip ? sm + p.shape.off_carry
                : p.carry_g + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) *
                                  carry_planes(NCH) * cap;
  float* c_t = carry;
  float* c_r = carry + cap;
  float* c_g = carry + 2 * cap;
  float* c_b = carry + 3 * cap;
  float* c_sec = carry + 4 * cap;
  float* c_u = carry + 5 * cap;  // per channel; channel 0 < 0: no support

  // classification tables into shared memory: compressed knots as
  // (sd float4 [C][M], pos [C][M]); dense as the LUT differences
  float4* t_sd = reinterpret_cast<float4*>(sm + p.shape.off_tab);
  float* t_pos = sm + p.shape.off_tab + 4 * NCH * m;
  if (p.compressed) {
    for (int e = threadIdx.x; e < NCH * m; e += kThreads) {
      t_sd[e] = reinterpret_cast<const float4*>(p.ksd)[e];
      t_pos[e] = p.kpos[e];
    }
  } else {
    for (int e = threadIdx.x; e < NCH * nk; e += kThreads)
      t_sd[e] = reinterpret_cast<const float4*>(p.dlut)[e];
  }

  float tloc = has_oob ? t_oob : 0.f;
  span.each([&](int q, int lr, int col) {
    const size_t idx = (size_t)(row0 + r0 + lr) * p.W + col0 + col;
    const float t = p.has_pt ? p.prev_t[idx] : 1.f;
    c_t[q] = t;
    c_r[q] = 0.f;
    c_g[q] = 0.f;
    c_b[q] = 0.f;
    c_sec[q] = p.sec[idx];
    tloc = fmaxf(tloc, t);
  });
  float rec[F];
  rec[0] = tloc;
  rec[1] = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) rec[2 + c] = n - 1.f;
  int parity = 0;
  tile_reduce<NCH>(rec, wrec, crec, parity, p.shape.k, cluster);
  const bool all_act = p.act_all[rt * p.n_ct + ct] > 0.5f;
  // tiles every earlier chunk saturated do nothing at all, nor does any
  // tile once the early exit's flag says every pixel has saturated (the
  // outputs are then rgb 0 and prev_t)
  const bool done = p.done && *p.done;
  for (int s = 0; !done && rec[0] > 0.005f && s < p.S; ++s) {
    // per-(slab, tile) step weight: 0 = no cell reaches the tile, k > 1 =
    // this slab stands in for k coarse-only slabs (adaptive stride)
    const float w_s =
        all_act ? 1.f : p.act[((size_t)s * p.n_rt + rt) * p.n_ct + ct];
    if (!(w_s > 0.f) || !(p.live[s] > 0.f)) continue;

    // the two rows and tent weights of each (block row, level)
    for (int e = threadIdx.x; e < rows_in * p.n_levels; e += kThreads) {
      const int lr = e / p.n_levels, l = e % p.n_levels;
      const int ny = p.ny[l];
      const float yp = p.ypos[(size_t)s * p.H + row0 + r0 + lr];
      const float t = yp / p.cw[l];
      const float base = p.orgy_half[l];
      const float k0f = floorf(t - base);
      const int k0 = (int)k0f;
      float w[2];
      int valid = 0;
#pragma unroll
      for (int tap = 0; tap < 2; ++tap) {
        const int kr = k0 + tap;
        const float qk = t - (base + (k0f + (float)tap));
        w[tap] = fmaxf(1.f - fabsf(qk), 0.f);
        valid |= (kr >= 0 && kr < ny) << tap;
      }
      taps[e] = make_float4(__int_as_float(k0), w[0], w[1],
                            __int_as_float(valid));
    }
    __syncthreads();

    // phase A: interpolate, texel coordinates into the carry
    const float ts = p.has_stop ? p.t_slab[s] : 0.f;
    float any_ok = 0.f;
    float umin[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) umin[c] = n - 1.f;
    span.each([&](int q, int lr, int col) {
      const int i = row0 + r0 + lr, j = col0 + col;
      float sw = 0.f;
      float swv[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) swv[c] = 0.f;
      for (int l = 0; l < p.n_levels; ++l) {
        const float4 tp = taps[lr * p.n_levels + l];
        const int k0 = __float_as_int(tp.x);
        const int valid = __float_as_int(tp.w);
        const size_t cstride = (size_t)p.S * p.ny[l] * p.W;
        const float* m0 =
            p.mids[l] + ((ptrdiff_t)s * p.ny[l] + k0) * p.W + j;
#pragma unroll
        for (int tap = 0; tap < 2; ++tap) {
          if (!((valid >> tap) & 1)) continue;
          const float wk = tap ? tp.z : tp.y;
          const float* r = m0 + (size_t)tap * p.W;
          sw = sw + wk * __ldg(r + NCH * cstride);
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            swv[c] = swv[c] + wk * __ldg(r + c * cstride);
        }
      }
      // the stop is strict: a slab exactly at the surface does not count
      const bool ok =
          sw > 1e-20f &&
          (!p.has_stop || ts < p.t_stop[(size_t)i * p.W + j]);
      const float denom = ok ? sw : 1.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float lo = p.dom[2 * c], hi = p.dom[2 * c + 1];
        const float value = swv[c] / denom;
        float sc = (n - 1.f) * (value - lo) / ((hi - lo) + 1e-20f);
        sc = fminf(fmaxf(sc + 0.5f, 0.f), n - 1.f) / (n - 1.f);
        const float ur = fminf(fmaxf(sc * n - 0.5f, 0.f), n - 1.f);
        c_u[c * cap + q] = ok ? ur : -1.f;
        if (ok) umin[c] = fminf(umin[c], ur);
      }
      if (ok) any_ok = 1.f;
    });

    // the tile's record: max T before this slab, any_ok, u_min
    rec[0] = tloc;
    rec[1] = any_ok;
#pragma unroll
    for (int c = 0; c < NCH; ++c) rec[2 + c] = umin[c];
    parity ^= 1;
    tile_reduce<NCH>(rec, wrec, crec, parity, p.shape.k, cluster);
    if (!(rec[0] > 0.005f)) break;
    if (!(rec[1] > 0.f)) continue;

    // the knot window's lower end: knots at or below the tile's min
    // fold into the prefix sums
    int lo_k[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float u_min = rec[2 + c];
      if (p.compressed) {
        // count the knots at or below u_min, 32 at a time over the warp
        int a = 0;
        for (int j0 = 0; j0 < m; j0 += 32) {
          const int jk = j0 + (threadIdx.x & 31);
          a += __popc(__ballot_sync(
              0xffffffffu, jk < m && t_pos[c * m + jk] <= u_min));
        }
        lo_k[c] = a;
      } else {
        lo_k[c] = min(max((int)floorf(u_min), 0), nk - 2);
      }
    }

    // phase B: classify, merge channels, composite
    const float dzw = p.dz * w_s;
    tloc = has_oob ? t_oob : 0.f;
    span.each([&](int q, int lr, int col) {
      float trun = c_t[q];
      if (c_u[q] < 0.f) {  // no field support here
        tloc = fmaxf(tloc, trun);
        return;
      }
      const float e = dzw * c_sec[q];
      float slab_a = 0.f, slab_r = 0.f, slab_g = 0.f, slab_b = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float u = c_u[c * cap + q];
        const int lo = lo_k[c];
        float cr, cg, cb, ca;
        if (p.compressed) {
          const float* cum = p.kcum + ((size_t)c * (m + 1) + lo) * 8;
          const float* bs = p.kbase + c * 4;
          cr = (__ldg(bs + 0) + u * __ldg(cum + 0)) - __ldg(cum + 4);
          cg = (__ldg(bs + 1) + u * __ldg(cum + 1)) - __ldg(cum + 5);
          cb = (__ldg(bs + 2) + u * __ldg(cum + 2)) - __ldg(cum + 6);
          ca = (__ldg(bs + 3) + u * __ldg(cum + 3)) - __ldg(cum + 7);
          // knots at or past u add exact zeros: stop at the first
          const float* kp = t_pos + c * m;
          const float4* sd = t_sd + c * m;
          for (int jk = lo; jk < m; ++jk) {
            const float pos = kp[jk];
            if (!(pos < u)) break;
            const float ramp = fmaxf(u - pos, 0.f);
            const float4 d = sd[jk];
            cr = cr + ramp * d.x;
            cg = cg + ramp * d.y;
            cb = cb + ramp * d.z;
            ca = ca + ramp * d.w;
          }
        } else {
          const float4 l0 =
              __ldg(reinterpret_cast<const float4*>(p.lut) + c * nk + lo);
          cr = l0.x;
          cg = l0.y;
          cb = l0.z;
          ca = l0.w;
          // texels past floor(u) add exact zeros
          const int top = min((int)floorf(u), nk - 2);
          const float4* d4 = t_sd + c * nk + 1;
          for (int kk = lo; kk <= top; ++kk) {
            const float ramp = fminf(fmaxf(u - (float)kk, 0.f), 1.f);
            const float4 d = d4[kk];
            cr = cr + ramp * d.x;
            cg = cg + ramp * d.y;
            cb = cb + ramp * d.z;
            ca = ca + ramp * d.w;
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
      c_r[q] = c_r[q] + trun * slab_r;
      c_g[q] = c_g[q] + trun * slab_g;
      c_b[q] = c_b[q] + trun * slab_b;
      trun = trun * (1.f - slab_a);
      c_t[q] = trun;
      tloc = fmaxf(tloc, trun);
    });
  }

  span.each([&](int q, int lr, int col) {
    const size_t idx = (size_t)(row0 + r0 + lr) * p.W + col0 + col;
    p.out_r[idx] = c_r[q];
    p.out_g[idx] = c_g[q];
    p.out_b[idx] = c_b[q];
    p.out_t[idx] = c_t[q];
  });
  // no block leaves while a peer may still read its cluster record
  cluster.sync();
}

template <int NCH>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&sweep_kernel<NCH>);
}

const void* kernel_for(int n_ch) {
  switch (n_ch) {  // the channel count is a template argument so the
                   // per-channel arrays stay in registers
    case 1: return kernel_of<1>();
    case 2: return kernel_of<2>();
    case 3: return kernel_of<3>();
    case 4: return kernel_of<4>();
    case 5: return kernel_of<5>();
    case 6: return kernel_of<6>();
    case 7: return kernel_of<7>();
    case 8: return kernel_of<8>();
    case 9: return kernel_of<9>();
    default: return kernel_of<10>();
  }
}

// Fill Params from the ctypes argument packs (see owx_sweep_chunk).
int unpack(Params& p, const uint64_t* ptrs, int n_ptrs, const int* ints,
           int n_ints, const float* flts, int n_flts) {
  if (n_ints < 13) return (int)cudaErrorInvalidValue;
  p = Params{};
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
      n_ints != 13 + L || p.tr < 1 || p.tc < 1 || p.n_texels < 2 ||
      (p.compressed && p.m_knots < 1))
    return (int)cudaErrorInvalidValue;
  p.n_rt = (p.H + p.tr - 1) / p.tr;
  p.n_ct = (p.W + p.tc - 1) / p.tc;
  for (int l = 0; l < L; ++l) p.ny[l] = ints[13 + l];
  if (!ptrs || !flts) return 0;  // the shape alone
  if (n_flts != 1 + 2 * L || n_ptrs != 21 + L)
    return (int)cudaErrorInvalidValue;
  p.dz = flts[0];
  for (int l = 0; l < L; ++l) {
    p.cw[l] = flts[1 + l];
    p.orgy_half[l] = flts[1 + L + l] + 0.5f;
    p.mids[l] = (const float*)ptrs[21 + l];
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
  p.carry_g = (float*)ptrs[13];
  p.out_r = (float*)ptrs[14];
  p.out_g = (float*)ptrs[15];
  p.out_b = (float*)ptrs[16];
  p.out_t = (float*)ptrs[17];
  p.t_slab = (const float*)ptrs[18];
  p.t_stop = (const float*)ptrs[19];
  p.done = (const unsigned char*)ptrs[20];
  if (p.has_pt && !p.prev_t) return (int)cudaErrorInvalidValue;
  if (p.has_stop && !(p.t_slab && p.t_stop))
    return (int)cudaErrorInvalidValue;
  if (p.compressed ? !(p.kpos && p.ksd && p.kbase && p.kcum)
                   : !(p.lut && p.dlut))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The shape of this chunk's launch on the current device, with the
// kernel allowed the dynamic shared memory it asks for.
// The attribute is raised only past what this device's kernel already
// allows, so a launch captured in a CUDA graph makes no such call.
int shape_for(const Params& p, Shape& s) {
  constexpr int kDevices = 64;
  static int limit_of[kDevices];
  static int allowed[kDevices][kMaxCh + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (!limit_of[dev]) {
    err = cudaDeviceGetAttribute(
        &limit_of[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
  }
  s = make_shape(p, limit_of[dev]);
  if (s.smem_bytes > limit_of[dev]) return (int)cudaErrorInvalidValue;
  if (s.smem_bytes > allowed[dev][p.n_ch]) {
    err = cudaFuncSetAttribute(kernel_for(p.n_ch),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               s.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    allowed[dev][p.n_ch] = s.smem_bytes;
  }
  return 0;
}

cudaLaunchConfig_t launch_config(const Shape& s, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = s.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = s.smem_bytes;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// K1's launch shape for a chunk (ints as for owx_sweep_chunk): out[0..8]
// = cluster size, grid x, grid y, threads per block, dynamic shared
// bytes, carry on chip (1) or in the global scratch (0), floats of that
// scratch, rows per block, and (when `occupancy`) the most clusters the
// card holds at once (else -1).  Returns a cudaError_t.
extern "C" int owx_sweep_shape(const int* ints, int n_ints, int occupancy,
                               int* out) {
  Params p;
  int err = unpack(p, nullptr, 0, ints, n_ints, nullptr, 0);
  Shape s;
  if (!err) err = shape_for(p, s);
  if (err) return err;
  int clusters = -1;
  if (occupancy) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(s, 0, attr);
    err = (int)cudaOccupancyMaxActiveClusters(&clusters,
                                              kernel_for(p.n_ch), &cfg);
    if (err) return err;
  }
  const int vals[9] = {s.k, (int)s.grid.x, (int)s.grid.y, kThreads,
                       s.smem_bytes, s.on_chip, s.carry_floats, s.rpb,
                       clusters};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// Plain C entry point (bound with ctypes).  Argument packs:
//   ptrs: ypos, sec, live, act, act_all, prev_t (or 0), dom, kpos, ksd,
//         kbase, kcum, lut, dlut, carry scratch (owx_sweep_shape's floats;
//         0 when the carry is on chip), out_r, out_g, out_b, out_t,
//         t_slab (or 0), t_stop (or 0), the early exit's flag (or 0:
//         never set), then one mids pointer per level
//   ints: n_levels, n_ch, S, H, W, tr, tc, compressed, n_texels, m_knots,
//         tau_mask, has_pt, has_stop, then ny per level
//   flts: dz, then cw per level, then lattice y origin per level
// Returns the launch's cudaError_t (0 = launched).
extern "C" int owx_sweep_chunk(const uint64_t* ptrs, int n_ptrs,
                               const int* ints, int n_ints,
                               const float* flts, int n_flts,
                               void* stream) {
  Params p;
  int err = unpack(p, ptrs, n_ptrs, ints, n_ints, flts, n_flts);
  Shape s;
  if (!err) err = shape_for(p, s);
  if (err) return err;
  if (!s.on_chip && !p.carry_g) return (int)cudaErrorInvalidValue;
  p.shape = s;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(s, (cudaStream_t)stream, attr);
  void* args[] = {&p};
  err = (int)cudaLaunchKernelExC(&cfg, kernel_for(p.n_ch), args);
  if (err) return err;
  return (int)cudaGetLastError();
}

// K7 for Hopper: the per-frame activity and stride tables of one chunk.
//
// Replaces no TPU kernel: the JAX package's pallas_sweep.combine_activity
// (:1489-1579) is jitted, and XLA fuses its small ops.  Eager PyTorch
// issued them one by one, ~145 launches and two host waits a chunk (the
// slabs' live mask and the cell widths copied to the card), for tables of a
// few hundred entries; K7 is that function in one launch, with those host
// inputs passed by value in its parameters.  Its plain-torch twin is
// render/sweep.py::combine_activity_reference.
//
// What bounds it: launch latency.  It reads L*S*R*Ct bytes of geometric
// activity, 2*C*S*R floats of TF-cull bounds and C*N*4 floats of LUTs, and
// writes S*R*Ct + R*Ct + S floats: kilobytes at the main path's chunks.
//
// The design: a tile's tables depend only on its own column of slabs, so
// one thread takes one (row tile, column tile).  Each block first marks,
// per channel, which LUT entries have a positive alpha, each alpha through
// xf.py::lookup_xf's operations in their order, and keeps prefix counts of
// them in shared memory, so the TF test of a (slab, row tile) reads two
// counts.  Each thread then ORs the levels, masks dead slabs, applies the
// TF cull (active_for_volume_sampling's clamps and truncation), finds the
// finest active cell width, and forms the greedy 8/4/2 stride groups with
// the twin's representative (the first minimum of its score), its padding
// of a ragged last group and its consumed slabs.  Block 0 also writes the
// live mask as floats, the form K1 reads.
//
// Every comparison and rounding is the twin's on the card (-fmad=false;
// PyTorch divides a CUDA tensor by a host scalar as a product with the
// scalar's reciprocal, so those two divisions are written so here), and
// the tables are booleans and small counts: the outputs are bit-equal.

namespace {

constexpr int kMaxSlabs = 256;   // kernels.MAX_SLABS
constexpr int kMaxTexels = 128;  // kernels.MAX_TEXELS
constexpr int kActThreads = 128;

struct ActParams {
  const unsigned char* acts_l;  // (L, S, R, Ct) bool
  const float* vmin;            // (C, S, R), or null: no TF cull
  const float* vmax;            // (C, S, R)
  const float* dom;             // (>= C, 2)
  const float* lut[kMaxCh];     // per channel (N, 4), alpha prescaled
  float* act;                   // out (S, R, Ct)
  float* act_all;               // out (R, Ct)
  float* live_f;                // out (S,)
  float cw[kMaxLevels];
  unsigned live[kMaxSlabs / 32];
  int n_levels, n_ch, S, n_rt, n_ct, n_texels, stride;
};

__device__ __forceinline__ bool bit(const unsigned* w, int i) {
  return (w[i >> 5] >> (i & 31)) & 1u;
}

// torch.clamp on floats: NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// The alpha of LUT entry j as active_for_volume_sampling computes it:
// lookup_xf at the entry's cell value, opacity scale 1
__device__ float entry_alpha(const float* lut, int n, float lo, float hi,
                             int j) {
  const float nm1 = (float)(n - 1), inv = 1.f / nm1;
  const float span = hi - lo;
  const float value = (float)j * inv * span + lo;
  float s = nm1 * (value - lo) / (span + 1e-20f);
  s = clamp_nan(s + 0.5f, 0.f, nm1) * inv;
  const float u = s * (float)n - 0.5f;
  const float f0 = floorf(u);
  const float frac = u - f0;
  const long long k = (long long)f0;
  const int i0 = (int)min(max(k, 0LL), (long long)(n - 1));
  const int i1 = (int)min(max(k + 1, 0LL), (long long)(n - 1));
  return lut[4 * i0 + 3] * (1.f - frac) + lut[4 * i1 + 3] * frac;
}

// The TF cull of slab s, row tile rt: some channel's value range holds a
// LUT entry of positive alpha.  cnt[c][k]: positive alphas below entry k.
__device__ bool tf_active(const ActParams& p, const int* cnt, int s, int rt) {
  const int n = p.n_texels;
  const float nm1 = (float)(n - 1), big = (float)(n + 1);
  for (int c = 0; c < p.n_ch; ++c) {
    const size_t k = ((size_t)c * p.S + s) * p.n_rt + rt;
    const float vlo = p.vmin[k], vhi = p.vmax[k];
    const float lo = p.dom[2 * c], hi = p.dom[2 * c + 1];
    const float span = (hi - lo) + 1e-20f;
    const int ilo = min(max((int)clamp_nan((vlo - lo) / span * nm1, -big,
                                           big), 0), n - 1);
    const int ihi = min(max((int)clamp_nan((vhi - lo) / span * nm1, -big,
                                           big) + 1, 0), n - 1);
    const int* cc = cnt + c * (kMaxTexels + 1);
    const bool inside = !(vlo > hi || vhi < lo);
    if (inside && ilo <= ihi && cc[ihi + 1] > cc[ilo] && vhi >= vlo)
      return true;
  }
  return false;
}

__global__ void __launch_bounds__(kActThreads)
activity_kernel(const __grid_constant__ ActParams p) {
  __shared__ int cnt[kMaxCh * (kMaxTexels + 1)];
  __shared__ unsigned char pos[kMaxCh * kMaxTexels];
  const int n = p.n_texels;
  for (int e = threadIdx.x; e < p.n_ch * n; e += blockDim.x) {
    const int c = e / n;
    pos[e] = entry_alpha(p.lut[c], n, p.dom[2 * c], p.dom[2 * c + 1],
                         e % n) > 0.f;
  }
  __syncthreads();
  if (threadIdx.x < p.n_ch) {
    int* cc = cnt + threadIdx.x * (kMaxTexels + 1);
    int run = 0;
    for (int j = 0; j < n; ++j) {
      cc[j] = run;
      run += pos[threadIdx.x * n + j];
    }
    cc[n] = run;
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int s = threadIdx.x; s < p.S; s += blockDim.x)
      p.live_f[s] = bit(p.live, s) ? 1.f : 0.f;
  const int plane = p.n_rt * p.n_ct;
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= plane) return;
  const int rt = tile / p.n_ct;

  float cw_min = p.cw[0];
  for (int l = 1; l < p.n_levels; ++l) cw_min = fminf(cw_min, p.cw[l]);
  // per slab: active, the stride limit (finest active cell width over
  // the finest of all; inf where inactive) and the step weight
  unsigned act[kMaxSlabs / 32] = {};
  float lim[kMaxSlabs];
  unsigned char wt[kMaxSlabs];
  for (int s = 0; s < p.S; ++s) {
    bool a = false;
    float cwa = INFINITY;
    for (int l = 0; l < p.n_levels; ++l) {
      if (p.acts_l[((size_t)l * p.S + s) * plane + tile]) {
        a = true;
        cwa = fminf(cwa, p.cw[l]);
      }
    }
    a = a && bit(p.live, s);
    if (a && p.vmin) a = tf_active(p, cnt, s, rt);
    if (a) act[s >> 5] |= 1u << (s & 31);
    lim[s] = a ? cwa / cw_min : INFINITY;
    wt[s] = a;
  }

  if (p.stride && p.S > 1) {
    // groups of 8, then 4, then 2 consecutive slabs; a ragged last group
    // is padded with inactive, unlimited, unconsumed slots
    unsigned used[kMaxSlabs / 32] = {};
    for (int c = 8; c >= 2; c >>= 1) {
      if (c > p.S) continue;
      for (int g0 = 0; g0 < p.S; g0 += c) {
        const int g1 = min(g0 + c, p.S);
        float lmin = INFINITY;
        int na = 0, first = c, last = -1;
        bool taken = false;
        for (int s = g0; s < g1; ++s) {
          lmin = fminf(lmin, lim[s]);
          taken = taken || bit(used, s);
          if (bit(act, s)) {
            ++na;
            first = min(first, s - g0);
            last = s - g0;
          }
        }
        if (!(lmin >= (float)c && na >= 2 && !taken)) continue;
        // the representative: the active slot nearest the active span's
        // middle, the first of equals
        const float mid = 0.5f * ((float)first + (float)last);
        int rep = 0;
        float best = INFINITY;
        for (int j = 0; j < c; ++j) {
          const bool aj = g0 + j < p.S && bit(act, g0 + j);
          const float score = fabsf((float)j - mid) + (aj ? 0.f : 1e9f);
          if (score < best) {
            best = score;
            rep = j;
          }
        }
        for (int s = g0; s < g1; ++s) {
          if (bit(act, s)) wt[s] = s - g0 == rep ? na : 0;
          used[s >> 5] |= 1u << (s & 31);
        }
      }
    }
  }

  // "every slab active at unit weight"
  bool all = true;
  for (int s = 0; s < p.S; ++s) {
    const float w = (float)wt[s];
    p.act[(size_t)s * plane + tile] = w;
    all = all && bit(act, s) && fabsf(w - 1.f) < 0.5f;
  }
  p.act_all[tile] = all ? 1.f : 0.f;
}

}  // namespace

// Plain C entry point of K7 (bound with ctypes).  Argument packs:
//   ptrs: acts_l, vmin, vmax, domains (the last three 0 without the TF
//         cull), act, act_all, live_f, then one LUT pointer per channel
//   ints: n_levels, n_ch (0 without the TF cull), S, R, Ct, n_texels,
//         TF cull, adaptive stride, then each slab's live bit (S ints)
//   flts: cw per level
// Returns the launch's cudaError_t (0 = launched).
extern "C" int owx_activity_chunk(const uint64_t* ptrs, int n_ptrs,
                                  const int* ints, int n_ints,
                                  const float* flts, int n_flts,
                                  void* stream) {
  if (n_ints < 8) return (int)cudaErrorInvalidValue;
  ActParams p = {};
  p.n_levels = ints[0];
  p.n_ch = ints[1];
  p.S = ints[2];
  p.n_rt = ints[3];
  p.n_ct = ints[4];
  p.n_texels = ints[5];
  const int has_tf = ints[6];
  p.stride = ints[7];
  const int L = p.n_levels, C = p.n_ch;
  if (L < 1 || L > kMaxLevels || p.S < 1 || p.S > kMaxSlabs ||
      p.n_rt < 1 || p.n_ct < 1 || n_ints != 8 + p.S || n_flts != L ||
      n_ptrs != 7 + C || !ptrs || !flts ||
      (has_tf ? C < 1 || C > kMaxCh || p.n_texels < 2 ||
                    p.n_texels > kMaxTexels
              : C != 0))
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < p.S; ++s)
    if (ints[8 + s]) p.live[s >> 5] |= 1u << (s & 31);
  for (int l = 0; l < L; ++l) p.cw[l] = flts[l];
  p.acts_l = (const unsigned char*)ptrs[0];
  p.vmin = (const float*)ptrs[1];
  p.vmax = (const float*)ptrs[2];
  p.dom = (const float*)ptrs[3];
  p.act = (float*)ptrs[4];
  p.act_all = (float*)ptrs[5];
  p.live_f = (float*)ptrs[6];
  for (int c = 0; c < C; ++c) {
    p.lut[c] = (const float*)ptrs[7 + c];
    if (!p.lut[c]) return (int)cudaErrorInvalidValue;
  }
  if (!(p.acts_l && p.act && p.act_all && p.live_f) ||
      (has_tf && !(p.vmin && p.vmax && p.dom)))
    return (int)cudaErrorInvalidValue;
  if (!has_tf) p.vmin = p.vmax = nullptr;
  const int tiles = p.n_rt * p.n_ct;
  activity_kernel<<<(tiles + kActThreads - 1) / kActThreads, kActThreads, 0,
                    (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* owx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
