// Native preprocessing core for owlexabrick-tpu.
//
// Implements the two offline, latency-sensitive build stages natively
// (the reference keeps these in C++ too: builder/builder.cpp and
// exa/Regions.cpp):
//
//   1. cells -> bricks partitioning with the three split strategies
//      (spatial-median / sah-alike / small-brick-count) + kd-tree
//   2. "same-bricks" region build: BSP over brick domains recording the
//      point-location tree, per-region brick lists, finest cell width and
//      multi-channel value ranges
//
// Exposed as a C API consumed through ctypes (no pybind11 dependency).
// The algorithms intentionally match the numpy implementations
// bit-for-bit so either backend can serve the same tests.

#include <algorithm>
#include <atomic>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <future>
#include <limits>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct V3i { int64_t x, y, z; };
struct V3f { float x, y, z; };

static inline int64_t divRoundDown(int64_t a, int64_t b) {
  return a >= 0 ? a / b : (a - (b - 1)) / b;
}
static inline int64_t divRoundUp(int64_t a, int64_t b) {
  return a >= 0 ? (a + b - 1) / b : a / b;
}

// ---------------------------------------------------------------------------
// brick builder
// ---------------------------------------------------------------------------

struct BrickOut {
  int32_t lower[3];
  int32_t size[3];
  int32_t level;
  int64_t cells_begin;  // into cell_ids
};

struct KdNodeOut {
  int32_t axis;       // 0..2 inner, 3 leaf
  int32_t word0;      // split (inner) / first brick (leaf)
  int32_t lo30;       // first child (inner) / count (leaf)
  int32_t max_level;
};

struct BuildCtx {
  const int32_t* lower;   // (n,3)
  const int32_t* level;   // (n,)
  int strategy;           // 0 spatial-median, 1 sah, 2 small-brick-count
  int max_leaf_width;

  std::vector<BrickOut> bricks;
  std::vector<int32_t> cell_ids;
  std::vector<KdNodeOut> kd;
  std::mutex mtx;
};

struct Bounds4 {
  int64_t lo[4];
  int64_t hi[4];
};

static Bounds4 cellBounds(const BuildCtx& c, int64_t id) {
  Bounds4 b;
  int64_t w = int64_t(1) << c.level[id];
  for (int a = 0; a < 3; a++) {
    b.lo[a] = c.lower[id * 3 + a];
    b.hi[a] = b.lo[a] + w;
  }
  b.lo[3] = c.level[id];
  b.hi[3] = c.level[id] + 1;
  return b;
}

static Bounds4 computeBounds(const BuildCtx& c, const std::vector<int64_t>& ids) {
  Bounds4 r;
  for (int a = 0; a < 4; a++) {
    r.lo[a] = std::numeric_limits<int64_t>::max();
    r.hi[a] = std::numeric_limits<int64_t>::min();
  }
  for (int64_t id : ids) {
    Bounds4 b = cellBounds(c, id);
    for (int a = 0; a < 4; a++) {
      r.lo[a] = std::min(r.lo[a], b.lo[a]);
      r.hi[a] = std::max(r.hi[a], b.hi[a]);
    }
  }
  return r;
}

static bool tryMakeLeaf(BuildCtx& c, const Bounds4& b4,
                        const std::vector<int64_t>& ids, int node_id) {
  if (b4.hi[3] - b4.lo[3] > 1) return false;
  int64_t cw = int64_t(1) << (b4.hi[3] - 1);
  int64_t size3[3];
  int64_t vol_units = 1;
  for (int a = 0; a < 3; a++) {
    size3[a] = (b4.hi[a] - b4.lo[a]) / cw;
    if (size3[a] > c.max_leaf_width) return false;
    vol_units *= (b4.hi[a] - b4.lo[a]);
  }
  if (vol_units != (int64_t)ids.size() * cw * cw * cw) return false;

  int64_t ncells = size3[0] * size3[1] * size3[2];
  std::vector<int32_t> grid((size_t)ncells, -1);
  for (int64_t id : ids) {
    int64_t ix = (c.lower[id * 3 + 0] - b4.lo[0]) / cw;
    int64_t iy = (c.lower[id * 3 + 1] - b4.lo[1]) / cw;
    int64_t iz = (c.lower[id * 3 + 2] - b4.lo[2]) / cw;
    grid[(size_t)(ix + size3[0] * (iy + size3[1] * iz))] = (int32_t)id;
  }
  for (int32_t v : grid)
    if (v < 0) return false;

  std::lock_guard<std::mutex> lock(c.mtx);
  BrickOut b;
  for (int a = 0; a < 3; a++) {
    b.lower[a] = (int32_t)b4.lo[a];
    b.size[a] = (int32_t)size3[a];
  }
  b.level = (int32_t)b4.lo[3];
  b.cells_begin = (int64_t)c.cell_ids.size();
  c.cell_ids.insert(c.cell_ids.end(), grid.begin(), grid.end());
  c.kd[node_id].axis = 3;
  c.kd[node_id].word0 = (int32_t)c.bricks.size();
  c.kd[node_id].lo30 = 1;
  c.kd[node_id].max_level = 0;
  c.bricks.push_back(b);
  return true;
}

static void buildRec(BuildCtx& c, std::vector<int64_t>& ids, int node_id,
                     int depth) {
  Bounds4 b4 = computeBounds(c, ids);
  int64_t coarse_w = int64_t(1) << (b4.hi[3] - 1);
  for (int a = 0; a < 3; a++) {
    b4.lo[a] = coarse_w * divRoundDown(b4.lo[a], coarse_w);
    b4.hi[a] = coarse_w * divRoundUp(b4.hi[a], coarse_w);
  }
  if (tryMakeLeaf(c, b4, ids, node_id)) return;

  int64_t grid_dims[3];
  for (int a = 0; a < 3; a++)
    grid_dims[a] = (b4.hi[a] - b4.lo[a]) / coarse_w;

  int32_t max_level = 0;
  for (int64_t id : ids) max_level = std::max(max_level, c.level[id]);

  int best_dim = -1;
  int64_t best_pos = -1;
  double best_cost = std::numeric_limits<double>::infinity();

  if (c.strategy == 1 || c.strategy == 2) {
    for (int d = 0; d < 3; d++) {
      int64_t nd = grid_dims[d];
      if (nd <= 1) continue;
      // per-slice volume, 4D bounds, level bitmask
      std::vector<int64_t> vol(nd, 0);
      std::vector<Bounds4> sb(nd);
      std::vector<uint32_t> lvl(nd, 0);
      for (int64_t s = 0; s < nd; s++)
        for (int a = 0; a < 4; a++) {
          sb[s].lo[a] = std::numeric_limits<int64_t>::max();
          sb[s].hi[a] = std::numeric_limits<int64_t>::min();
        }
      for (int64_t id : ids) {
        Bounds4 cb = cellBounds(c, id);
        int64_t bin = (cb.lo[d] - b4.lo[d]) / coarse_w;
        int64_t w = cb.hi[0] - cb.lo[0];
        vol[bin] += w * w * w;
        for (int a = 0; a < 4; a++) {
          sb[bin].lo[a] = std::min(sb[bin].lo[a], cb.lo[a]);
          sb[bin].hi[a] = std::max(sb[bin].hi[a], cb.hi[a]);
        }
        lvl[bin] |= (1u << c.level[id]);
      }
      int64_t total_units = 1;
      for (int a = 0; a < 3; a++) total_units *= (b4.hi[a] - b4.lo[a]);
      int64_t expected_slice_vol = total_units / nd;

      // prefix/suffix unions
      std::vector<Bounds4> pre(nd), suf(nd);
      std::vector<uint32_t> preL(nd), sufL(nd);
      pre[0] = sb[0]; preL[0] = lvl[0];
      for (int64_t s = 1; s < nd; s++) {
        pre[s] = pre[s - 1];
        for (int a = 0; a < 4; a++) {
          pre[s].lo[a] = std::min(pre[s].lo[a], sb[s].lo[a]);
          pre[s].hi[a] = std::max(pre[s].hi[a], sb[s].hi[a]);
        }
        preL[s] = preL[s - 1] | lvl[s];
      }
      suf[nd - 1] = sb[nd - 1]; sufL[nd - 1] = lvl[nd - 1];
      for (int64_t s = nd - 2; s >= 0; s--) {
        suf[s] = suf[s + 1];
        for (int a = 0; a < 4; a++) {
          suf[s].lo[a] = std::min(suf[s].lo[a], sb[s].lo[a]);
          suf[s].hi[a] = std::max(suf[s].hi[a], sb[s].hi[a]);
        }
        sufL[s] = sufL[s + 1] | lvl[s];
      }

      for (int64_t plane = 1; plane < nd; plane++) {
        int64_t ls = plane - 1, rs = plane;
        int64_t llo = sb[ls].lo[3], lsz = sb[ls].hi[3] - sb[ls].lo[3];
        int64_t rlo = sb[rs].lo[3], rsz = sb[rs].hi[3] - sb[rs].lo[3];
        bool lFull = vol[ls] == expected_slice_vol;
        bool rFull = vol[rs] == expected_slice_vol;
        if (llo == rlo && lsz == rsz && lFull && rFull) continue;

        double cost;
        if (c.strategy == 1) {
          auto area = [](const Bounds4& b) {
            double sx = std::max<int64_t>(b.hi[0] - b.lo[0], 0);
            double sy = std::max<int64_t>(b.hi[1] - b.lo[1], 0);
            double sz = std::max<int64_t>(b.hi[2] - b.lo[2], 0);
            return sx * sy + sy * sz + sz * sx;
          };
          auto volm = [](const Bounds4& b) {
            double sx = std::max<int64_t>(b.hi[0] - b.lo[0], 0);
            double sy = std::max<int64_t>(b.hi[1] - b.lo[1], 0);
            double sz = std::max<int64_t>(b.hi[2] - b.lo[2], 0);
            return sx * sy * sz;
          };
          double lw = std::max<int64_t>(pre[ls].hi[3] - pre[ls].lo[3], 0);
          double rw = std::max<int64_t>(suf[rs].hi[3] - suf[rs].lo[3], 0);
          cost = area(pre[ls]) * volm(pre[ls]) * lw
               + area(suf[rs]) * volm(suf[rs]) * rw;
        } else {
          cost = (double)__builtin_popcount(preL[ls])
               + (double)__builtin_popcount(sufL[rs]);
        }

        int64_t pos = b4.lo[d] + plane * coarse_w;
        if (cost < best_cost) {
          best_cost = cost;
          best_dim = d;
          best_pos = pos;
        } else if (c.strategy == 2 && cost == best_cost && best_dim >= 0) {
          int64_t middle = grid_dims[best_dim] / 2;
          if (std::llabs(pos - middle) < std::llabs(best_pos - middle)) {
            best_dim = d;
            best_pos = pos;
          }
        }
      }
    }
  }

  if (best_dim == -1) {
    best_dim = 0;
    for (int a = 1; a < 3; a++)
      if (grid_dims[a] > grid_dims[best_dim]) best_dim = a;
    best_pos = b4.lo[best_dim] + (grid_dims[best_dim] / 2) * coarse_w;
  }

  std::vector<int64_t> l, r;
  l.reserve(ids.size() / 2);
  r.reserve(ids.size() / 2);
  for (int64_t id : ids) {
    int64_t clo = c.lower[id * 3 + best_dim];
    int64_t chi = clo + (int64_t(1) << c.level[id]);
    if (clo >= best_pos) r.push_back(id);
    else if (chi <= best_pos) l.push_back(id);
    // straddle impossible by construction (coarse-aligned planes)
  }
  std::vector<int64_t>().swap(ids);

  int first_child;
  {
    std::lock_guard<std::mutex> lock(c.mtx);
    first_child = (int)c.kd.size();
    c.kd.push_back({});
    c.kd.push_back({});
    c.kd[node_id].axis = best_dim;
    c.kd[node_id].word0 = (int32_t)best_pos;
    c.kd[node_id].lo30 = first_child;
    c.kd[node_id].max_level = max_level;
  }

  // serial recursion keeps brick/kd ids deterministic (matching the
  // python builder bit-for-bit); the expensive stage is the region
  // value-range scan, which is threaded
  (void)depth;
  buildRec(c, l, first_child, depth + 1);
  buildRec(c, r, first_child + 1, depth + 1);
}

}  // namespace

extern "C" {

struct ExaBuildResult {
  std::vector<BrickOut> bricks;
  std::vector<int32_t> cell_ids;
  std::vector<KdNodeOut> kd;
};

// Build bricks. lower: (n,3) int32, level: (n,) int32. Returns a handle.
void* exa_build_bricks(const int32_t* lower, const int32_t* level, int64_t n,
                       int strategy, int max_leaf_width) {
  BuildCtx ctx;
  ctx.lower = lower;
  ctx.level = level;
  ctx.strategy = strategy;
  ctx.max_leaf_width = max_leaf_width;

  // dedup: unique positions, finest level wins (builder.cpp:301-351)
  std::vector<int64_t> ids(n);
  for (int64_t i = 0; i < n; i++) ids[i] = i;
  std::sort(ids.begin(), ids.end(), [&](int64_t a, int64_t b) {
    for (int k = 0; k < 3; k++) {
      if (lower[a * 3 + k] != lower[b * 3 + k])
        return lower[a * 3 + k] < lower[b * 3 + k];
    }
    return level[a] < level[b];
  });
  std::vector<int64_t> uniq;
  uniq.reserve(ids.size());
  for (size_t i = 0; i < ids.size(); i++) {
    if (i > 0) {
      int64_t a = ids[i - 1], b = ids[i];
      if (lower[a * 3] == lower[b * 3] && lower[a * 3 + 1] == lower[b * 3 + 1]
          && lower[a * 3 + 2] == lower[b * 3 + 2])
        continue;  // same position: keep the first (finest level)
    }
    uniq.push_back(ids[i]);
  }

  ctx.kd.push_back({});
  buildRec(ctx, uniq, 0, 0);

  auto* out = new ExaBuildResult;
  out->bricks = std::move(ctx.bricks);
  out->cell_ids = std::move(ctx.cell_ids);
  out->kd = std::move(ctx.kd);
  return out;
}

int64_t exa_build_num_bricks(void* h) {
  return (int64_t)((ExaBuildResult*)h)->bricks.size();
}
int64_t exa_build_num_cells(void* h) {
  return (int64_t)((ExaBuildResult*)h)->cell_ids.size();
}
int64_t exa_build_num_kd(void* h) {
  return (int64_t)((ExaBuildResult*)h)->kd.size();
}

void exa_build_copy(void* h, int32_t* lower, int32_t* size, int32_t* level,
                    int64_t* begin, int32_t* cell_ids, int32_t* kd_axis,
                    int32_t* kd_word0, int32_t* kd_lo30, int32_t* kd_maxlvl) {
  auto* r = (ExaBuildResult*)h;
  for (size_t i = 0; i < r->bricks.size(); i++) {
    const BrickOut& b = r->bricks[i];
    for (int a = 0; a < 3; a++) {
      lower[i * 3 + a] = b.lower[a];
      size[i * 3 + a] = b.size[a];
    }
    level[i] = b.level;
    begin[i] = b.cells_begin;
  }
  std::memcpy(cell_ids, r->cell_ids.data(),
              r->cell_ids.size() * sizeof(int32_t));
  for (size_t i = 0; i < r->kd.size(); i++) {
    kd_axis[i] = r->kd[i].axis;
    kd_word0[i] = r->kd[i].word0;
    kd_lo30[i] = r->kd[i].lo30;
    kd_maxlvl[i] = r->kd[i].max_level;
  }
}

void exa_build_free(void* h) { delete (ExaBuildResult*)h; }

// ---------------------------------------------------------------------------
// region builder (exa/Regions.cpp semantics + recorded BSP tree)
// ---------------------------------------------------------------------------

struct RegionsResult {
  std::vector<float> region_lo, region_hi;   // (R,3)
  std::vector<float> vrange;                 // (R,2)
  std::vector<float> finest_cw;              // (R,)
  std::vector<int32_t> leaf_list;            // packed
  std::vector<int64_t> leaf_begin, leaf_size;
  // BSP tree
  std::vector<int32_t> axis;    // 3 = leaf
  std::vector<float> split;
  std::vector<int32_t> child;
  std::vector<int32_t> leaf;    // region id or -1
  std::vector<float> node_lo, node_hi;  // (T,3)
  int depth = 1;
};

struct Prim { float lo[3], hi[3]; int32_t id; };

struct RegionCtx {
  const int32_t* b_lower;  // (m,3)
  const int32_t* b_size;   // (m,3)
  const int32_t* b_level;  // (m,)
  const int64_t* b_begin;  // (m,)
  const float* scalars;    // (nchan, total_cells)
  int64_t total_cells;
  int nchan;
  RegionsResult out;
};

static int newNode(RegionCtx& c) {
  c.out.axis.push_back(3);
  c.out.split.push_back(0.f);
  c.out.child.push_back(-1);
  c.out.leaf.push_back(-1);
  for (int a = 0; a < 3; a++) {
    c.out.node_lo.push_back(0.f);
    c.out.node_hi.push_back(0.f);
  }
  return (int)c.out.axis.size() - 1;
}

static void regionRec(RegionCtx& c, int node, std::vector<Prim>& prims,
                      float dlo[3], float dhi[3], int depth) {
  c.out.depth = std::max(c.out.depth, depth);
  for (int a = 0; a < 3; a++) {
    c.out.node_lo[node * 3 + a] = dlo[a];
    c.out.node_hi[node * 3 + a] = dhi[a];
  }
  if (prims.empty()) return;
  for (int a = 0; a < 3; a++)
    if (dhi[a] <= dlo[a]) return;

  // candidate split per dim: prim face strictly inside, closest to center
  float center[3], best_pos[3], best_dist[3];
  for (int a = 0; a < 3; a++) {
    center[a] = 0.5f * (dlo[a] + dhi[a]);
    best_pos[a] = dlo[a];
    best_dist[a] = dhi[a] - dlo[a];
  }
  for (const Prim& p : prims) {
    for (int dim = 0; dim < 3; dim++) {
      for (int side = 0; side < 2; side++) {
        float pos = side ? p.lo[dim] : p.hi[dim];
        if (pos <= dlo[dim] || pos >= dhi[dim]) continue;
        float dist = std::fabs(center[dim] - pos);
        if (dist < best_dist[dim]) {
          best_dist[dim] = dist;
          best_pos[dim] = pos;
        }
      }
    }
  }

  int widest = 0;
  for (int a = 1; a < 3; a++)
    if (dhi[a] - dlo[a] > dhi[widest] - dlo[widest]) widest = a;
  int split_dim = -1;
  float split_pos = 0.f;
  for (int i = 0; i < 3; i++) {
    int dim = (widest + i) % 3;
    if (best_pos[dim] <= dlo[dim] || best_pos[dim] >= dhi[dim]) continue;
    split_dim = dim;
    split_pos = best_pos[dim];
    break;
  }

  if (split_dim < 0) {
    // leaf: unique brick ids
    std::vector<int32_t> bids;
    bids.reserve(prims.size());
    for (const Prim& p : prims) bids.push_back(p.id);
    std::sort(bids.begin(), bids.end());
    bids.erase(std::unique(bids.begin(), bids.end()), bids.end());
    if (bids.empty()) return;
    int rid = (int)(c.out.leaf_begin.size());
    c.out.leaf[node] = rid;
    for (int a = 0; a < 3; a++) {
      c.out.region_lo.push_back(dlo[a]);
      c.out.region_hi.push_back(dhi[a]);
    }
    c.out.leaf_begin.push_back((int64_t)c.out.leaf_list.size());
    c.out.leaf_size.push_back((int64_t)bids.size());
    c.out.leaf_list.insert(c.out.leaf_list.end(), bids.begin(), bids.end());
    c.out.vrange.push_back(0.f);  // filled later
    c.out.vrange.push_back(0.f);
    c.out.finest_cw.push_back(0.f);
    return;
  }

  float dlo_l[3], dhi_l[3], dlo_r[3], dhi_r[3];
  for (int a = 0; a < 3; a++) {
    dlo_l[a] = dlo[a]; dhi_l[a] = dhi[a];
    dlo_r[a] = dlo[a]; dhi_r[a] = dhi[a];
  }
  dhi_l[split_dim] = split_pos;
  dlo_r[split_dim] = split_pos;

  std::vector<Prim> l, r;
  l.reserve(prims.size());
  r.reserve(prims.size());
  for (const Prim& p : prims) {
    Prim q = p;
    // clip left
    bool ok = true;
    for (int a = 0; a < 3; a++) {
      q.lo[a] = std::max(p.lo[a], dlo_l[a]);
      q.hi[a] = std::min(p.hi[a], dhi_l[a]);
      if (!(q.lo[a] < q.hi[a])) ok = false;
    }
    if (ok) l.push_back(q);
    ok = true;
    for (int a = 0; a < 3; a++) {
      q.lo[a] = std::max(p.lo[a], dlo_r[a]);
      q.hi[a] = std::min(p.hi[a], dhi_r[a]);
      if (!(q.lo[a] < q.hi[a])) ok = false;
    }
    if (ok) r.push_back(q);
  }
  std::vector<Prim>().swap(prims);

  int first = newNode(c);
  newNode(c);
  c.out.axis[node] = split_dim;
  c.out.split[node] = split_pos;
  c.out.child[node] = first;

  regionRec(c, first, l, dlo_l, dhi_l, depth + 1);
  regionRec(c, first + 1, r, dlo_r, dhi_r, depth + 1);
}

static void computeRanges(RegionCtx& c) {
  int64_t n_regions = (int64_t)c.out.leaf_begin.size();
  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    int64_t rid;
    while ((rid = next.fetch_add(1)) < n_regions) {
      const float* rlo = &c.out.region_lo[rid * 3];
      const float* rhi = &c.out.region_hi[rid * 3];
      float vmin = std::numeric_limits<float>::infinity();
      float vmax = -vmin;
      float fin = std::numeric_limits<float>::infinity();
      for (int64_t k = 0; k < c.out.leaf_size[rid]; k++) {
        int32_t b = c.out.leaf_list[c.out.leaf_begin[rid] + k];
        float cw = (float)(1 << c.b_level[b]);
        fin = std::min(fin, cw);
        int sx = c.b_size[b * 3], sy = c.b_size[b * 3 + 1],
            sz = c.b_size[b * 3 + 2];
        // valid index ranges per axis: cells whose basis support
        // (center +- cw) overlaps the region (Regions.cpp:182-240)
        int lo_i[3], hi_i[3];
        int dims[3] = {sx, sy, sz};
        for (int a = 0; a < 3; a++) {
          // cell center pos = lower + (i+.5)*cw; support overlaps when
          // pos - cw <= rhi  &&  pos + cw >= rlo  (Regions.cpp:196-218)
          float lower = (float)c.b_lower[b * 3 + a];
          float i_min = (rlo[a] - lower) / cw - 1.5f;   // i >= i_min
          float i_max = (rhi[a] - lower) / cw + 0.5f;   // i <= i_max
          lo_i[a] = std::max(0, (int)std::ceil(i_min));
          hi_i[a] = std::min(dims[a] - 1, (int)std::floor(i_max));
        }
        for (int ch = 0; ch < c.nchan; ch++) {
          const float* s = c.scalars + (int64_t)ch * c.total_cells
                         + c.b_begin[b];
          for (int iz = lo_i[2]; iz <= hi_i[2]; iz++)
            for (int iy = lo_i[1]; iy <= hi_i[1]; iy++)
              for (int ix = lo_i[0]; ix <= hi_i[0]; ix++) {
                float v = s[ix + (int64_t)sx * (iy + (int64_t)sy * iz)];
                vmin = std::min(vmin, v);
                vmax = std::max(vmax, v);
              }
        }
      }
      c.out.vrange[rid * 2] = vmin;
      c.out.vrange[rid * 2 + 1] = vmax;
      c.out.finest_cw[rid] = fin;
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

void* exa_build_regions(const int32_t* b_lower, const int32_t* b_size,
                        const int32_t* b_level, const int64_t* b_begin,
                        int64_t n_bricks, const float* scalars,
                        int64_t total_cells, int nchan) {
  RegionCtx ctx;
  ctx.b_lower = b_lower;
  ctx.b_size = b_size;
  ctx.b_level = b_level;
  ctx.b_begin = b_begin;
  ctx.scalars = scalars;
  ctx.total_cells = total_cells;
  ctx.nchan = nchan;

  std::vector<Prim> prims((size_t)n_bricks);
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n_bricks; i++) {
    float cw = (float)(1 << b_level[i]);
    for (int a = 0; a < 3; a++) {
      prims[i].lo[a] = b_lower[i * 3 + a] - 0.5f * cw;
      prims[i].hi[a] = b_lower[i * 3 + a] + (b_size[i * 3 + a] + 0.5f) * cw;
      lo[a] = std::min(lo[a], prims[i].lo[a]);
      hi[a] = std::max(hi[a], prims[i].hi[a]);
    }
    prims[i].id = (int32_t)i;
  }

  int root = newNode(ctx);
  regionRec(ctx, root, prims, lo, hi, 1);
  if (scalars && nchan > 0) computeRanges(ctx);

  auto* out = new RegionsResult(std::move(ctx.out));
  return out;
}

int64_t exa_regions_num(void* h) {
  return (int64_t)((RegionsResult*)h)->leaf_begin.size();
}
int64_t exa_regions_leaf_list_len(void* h) {
  return (int64_t)((RegionsResult*)h)->leaf_list.size();
}
int64_t exa_regions_num_nodes(void* h) {
  return (int64_t)((RegionsResult*)h)->axis.size();
}
int32_t exa_regions_depth(void* h) {
  return ((RegionsResult*)h)->depth;
}

void exa_regions_copy(void* h, float* region_lo, float* region_hi,
                      float* vrange, float* finest_cw, int32_t* leaf_list,
                      int64_t* leaf_begin, int64_t* leaf_size,
                      int32_t* axis, float* split, int32_t* child,
                      int32_t* leaf, float* node_lo, float* node_hi) {
  auto* r = (RegionsResult*)h;
  auto cp = [](auto* dst, const auto& src) {
    std::memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cp(region_lo, r->region_lo);
  cp(region_hi, r->region_hi);
  cp(vrange, r->vrange);
  cp(finest_cw, r->finest_cw);
  cp(leaf_list, r->leaf_list);
  cp(leaf_begin, r->leaf_begin);
  cp(leaf_size, r->leaf_size);
  cp(axis, r->axis);
  cp(split, r->split);
  cp(child, r->child);
  cp(leaf, r->leaf);
  cp(node_lo, r->node_lo);
  cp(node_hi, r->node_hi);
}

void exa_regions_free(void* h) { delete (RegionsResult*)h; }

}  // extern "C"
