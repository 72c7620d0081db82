// Binned-SAH BVH builder with threaded (hit/miss-link) flattening, the
// host side of the mesh arena build (zyg_tpu_torch/scene/trimesh.py).
//
// The port's own copy of zyg_tpu/native/bvh_builder.cpp: the same
// algorithm and array contract, so the port builds the same trees as the
// JAX package. The top of the tree splits sequentially (object or spatial
// splits, straddling references duplicated within the caller's budget)
// until enough independent subtrees exist, then worker threads build them
// in parallel into disjoint node blocks (each subtree of m prims needs
// <= 2m-1 nodes, so blocks are pre-partitioned: no locks on the hot path).
// Callers allocate the output arrays; returns the node count, or -1 on
// overflow.
//
// Built at first use by zyg_tpu_torch/native/__init__.py:
//   g++ -O2 -shared -fPIC -pthread -o <_build>/libzyg_bvh_<hash>.so bvh_builder.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr int kNumBins = 16;

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float half_area(const V3 &mn, const V3 &mx) {
  const float dx = std::max(mx.x - mn.x, 0.0f);
  const float dy = std::max(mx.y - mn.y, 0.0f);
  const float dz = std::max(mx.z - mn.z, 0.0f);
  return dx * dy + dy * dz + dz * dx;
}

struct Range {
  int node, lo, hi;
};

}  // namespace

namespace {

struct Shared {
  const V3 *prim_min;
  const V3 *prim_max;
  const V3 *cent;
  int *prim_order;
  int leaf_size;
  V3 *nmin;
  V3 *nmax;
  int *lchild;
  int *first;
  int *count;
};

// Process one range: write the node, either mark a leaf or partition and
// push both children (allocated from [*alloc, alloc_end)). Returns false
// on node-capacity overflow.
bool process_range(const Shared &S, const Range &r, std::vector<Range> &stack,
                   std::vector<int> &scratch, int *alloc, int alloc_end) {
  int *idx = S.prim_order + r.lo;
  const int m = r.hi - r.lo;
  const V3 *prim_min = S.prim_min;
  const V3 *prim_max = S.prim_max;
  const V3 *cent = S.cent;

  V3 bmin = prim_min[idx[0]], bmax = prim_max[idx[0]];
  V3 cmin = cent[idx[0]], cmax = cent[idx[0]];
  for (int k = 1; k < m; ++k) {
    bmin = vmin(bmin, prim_min[idx[k]]);
    bmax = vmax(bmax, prim_max[idx[k]]);
    cmin = vmin(cmin, cent[idx[k]]);
    cmax = vmax(cmax, cent[idx[k]]);
  }
  S.nmin[r.node] = bmin;
  S.nmax[r.node] = bmax;

  if (m <= S.leaf_size) {
    S.first[r.node] = r.lo;
    S.count[r.node] = m;
    return true;
  }

  const float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
  int axis = 0;
  if (ext[1] > ext[axis]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;
  auto comp = [&](int i) {
    return axis == 0 ? cent[i].x : (axis == 1 ? cent[i].y : cent[i].z);
  };
  const float cmin_a = axis == 0 ? cmin.x : (axis == 1 ? cmin.y : cmin.z);

  int split;
  if (ext[axis] <= 1e-12f) {
    std::stable_sort(idx, idx + m, [&](int a, int b) { return comp(a) < comp(b); });
    split = m / 2;
  } else {
    const float scale = kNumBins * (1.0f - 1e-6f) / ext[axis];
    int bin_count[kNumBins] = {0};
    V3 bin_min[kNumBins], bin_max[kNumBins];
    for (int b = 0; b < kNumBins; ++b) {
      bin_min[b] = {INFINITY, INFINITY, INFINITY};
      bin_max[b] = {-INFINITY, -INFINITY, -INFINITY};
    }
    std::vector<int8_t> which(m);
    for (int k = 0; k < m; ++k) {
      int b = static_cast<int>((comp(idx[k]) - cmin_a) * scale);
      b = std::min(b, kNumBins - 1);
      which[k] = static_cast<int8_t>(b);
      ++bin_count[b];
      bin_min[b] = vmin(bin_min[b], prim_min[idx[k]]);
      bin_max[b] = vmax(bin_max[b], prim_max[idx[k]]);
    }
    // prefix/suffix sweep (ref builder_base.zig splittingPlane)
    float larea[kNumBins], rarea[kNumBins];
    int lcnt[kNumBins], rcnt[kNumBins];
    {
      V3 amn = bin_min[0], amx = bin_max[0];
      int c = 0;
      for (int b = 0; b < kNumBins; ++b) {
        amn = vmin(amn, bin_min[b]);
        amx = vmax(amx, bin_max[b]);
        c += bin_count[b];
        larea[b] = half_area(amn, amx);
        lcnt[b] = c;
      }
      amn = bin_min[kNumBins - 1];
      amx = bin_max[kNumBins - 1];
      c = 0;
      for (int b = kNumBins - 1; b >= 0; --b) {
        amn = vmin(amn, bin_min[b]);
        amx = vmax(amx, bin_max[b]);
        c += bin_count[b];
        rarea[b] = half_area(amn, amx);
        rcnt[b] = c;
      }
    }
    int best = -1;
    float best_cost = std::numeric_limits<float>::infinity();
    for (int b = 0; b + 1 < kNumBins; ++b) {
      if (lcnt[b] == 0 || rcnt[b + 1] == 0) continue;
      const float cost = larea[b] * lcnt[b] + rarea[b + 1] * rcnt[b + 1];
      if (cost < best_cost) {
        best_cost = cost;
        best = b;
      }
    }
    if (best < 0) {
      std::stable_sort(idx, idx + m, [&](int a, int b) { return comp(a) < comp(b); });
      split = m / 2;
    } else {
      // stable partition by bin <= best
      int nl = 0, nr = 0;
      if (static_cast<int>(scratch.size()) < m) scratch.resize(m);
      for (int k = 0; k < m; ++k) {
        if (which[k] <= best) idx[nl++] = idx[k];
        else scratch[nr++] = idx[k];
      }
      std::memcpy(idx + nl, scratch.data(), nr * sizeof(int));
      split = nl;
    }
  }

  if (*alloc + 2 > alloc_end) return false;
  const int li = *alloc, ri = *alloc + 1;
  *alloc += 2;
  S.lchild[r.node] = li;
  stack.push_back({ri, r.lo + split, r.hi});
  stack.push_back({li, r.lo, r.lo + split});
  return true;
}

}  // namespace

namespace {

// ---- spatial splits (SBVH-lite, ref builder_base.zig:83-95,330): the
// sequential top phase also evaluates CHOPPED spatial-split candidates —
// kNumBins slabs over the node bounds' widest axis, each primitive's
// AABB clipped to every slab it spans, straddling references DUPLICATED
// into both children (bounded by a global budget). Deep nodes keep plain
// object splits: overlap shrinks fast below the top levels and the
// in-place parallel phase stays duplication-free.

struct VRange {
  int node;
  std::vector<int> prims;
};

bool process_vrange(const Shared &S, VRange r, std::vector<VRange> &stack,
                    int *alloc, int alloc_end, int *dup_budget) {
  const int m = static_cast<int>(r.prims.size());
  const int *idx = r.prims.data();
  const V3 *prim_min = S.prim_min;
  const V3 *prim_max = S.prim_max;
  const V3 *cent = S.cent;

  V3 bmin = prim_min[idx[0]], bmax = prim_max[idx[0]];
  V3 cmin = cent[idx[0]], cmax = cent[idx[0]];
  for (int k = 1; k < m; ++k) {
    bmin = vmin(bmin, prim_min[idx[k]]);
    bmax = vmax(bmax, prim_max[idx[k]]);
    cmin = vmin(cmin, cent[idx[k]]);
    cmax = vmax(cmax, cent[idx[k]]);
  }
  S.nmin[r.node] = bmin;
  S.nmax[r.node] = bmax;
  // callers guarantee m > leaf_size (leaf vranges go straight to the
  // flat phase, whose process_range re-derives bounds and first/count)

  // ---- object-split candidate (centroid binning, as process_range)
  auto axis_of = [](const V3 &v, int a) {
    return a == 0 ? v.x : (a == 1 ? v.y : v.z);
  };
  const float cext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
  int oaxis = 0;
  if (cext[1] > cext[oaxis]) oaxis = 1;
  if (cext[2] > cext[oaxis]) oaxis = 2;
  float obj_cost = std::numeric_limits<float>::infinity();
  int obj_best = -1;
  float oscale = 0.0f;
  if (cext[oaxis] > 1e-12f) {
    oscale = kNumBins * (1.0f - 1e-6f) / cext[oaxis];
    int bin_count[kNumBins] = {0};
    V3 bin_min[kNumBins], bin_max[kNumBins];
    for (int b = 0; b < kNumBins; ++b) {
      bin_min[b] = {INFINITY, INFINITY, INFINITY};
      bin_max[b] = {-INFINITY, -INFINITY, -INFINITY};
    }
    const float c0 = axis_of(cmin, oaxis);
    for (int k = 0; k < m; ++k) {
      int b = static_cast<int>((axis_of(cent[idx[k]], oaxis) - c0) * oscale);
      b = std::min(b, kNumBins - 1);
      ++bin_count[b];
      bin_min[b] = vmin(bin_min[b], prim_min[idx[k]]);
      bin_max[b] = vmax(bin_max[b], prim_max[idx[k]]);
    }
    float larea[kNumBins], rarea[kNumBins];
    int lcnt[kNumBins], rcnt[kNumBins];
    V3 amn = bin_min[0], amx = bin_max[0];
    int c = 0;
    for (int b = 0; b < kNumBins; ++b) {
      amn = vmin(amn, bin_min[b]);
      amx = vmax(amx, bin_max[b]);
      c += bin_count[b];
      larea[b] = half_area(amn, amx);
      lcnt[b] = c;
    }
    amn = bin_min[kNumBins - 1];
    amx = bin_max[kNumBins - 1];
    c = 0;
    for (int b = kNumBins - 1; b >= 0; --b) {
      amn = vmin(amn, bin_min[b]);
      amx = vmax(amx, bin_max[b]);
      c += bin_count[b];
      rarea[b] = half_area(amn, amx);
      rcnt[b] = c;
    }
    for (int b = 0; b + 1 < kNumBins; ++b) {
      if (lcnt[b] == 0 || rcnt[b + 1] == 0) continue;
      const float cost = larea[b] * lcnt[b] + rarea[b + 1] * rcnt[b + 1];
      if (cost < obj_cost) {
        obj_cost = cost;
        obj_best = b;
      }
    }
  }

  // ---- chopped spatial-split candidate over the NODE bounds
  const float next[3] = {bmax.x - bmin.x, bmax.y - bmin.y, bmax.z - bmin.z};
  int saxis = 0;
  if (next[1] > next[saxis]) saxis = 1;
  if (next[2] > next[saxis]) saxis = 2;
  float sp_cost = std::numeric_limits<float>::infinity();
  int sp_best = -1;
  int sp_dups = 0;
  const float n0 = axis_of(bmin, saxis);
  const float next_a = next[saxis];
  if (next_a > 1e-12f && *dup_budget > 0) {
    const float sscale = kNumBins * (1.0f - 1e-6f) / next_a;
    const float inv = next_a / kNumBins;
    V3 bin_min[kNumBins], bin_max[kNumBins];
    int entry[kNumBins] = {0}, exit_[kNumBins] = {0};
    for (int b = 0; b < kNumBins; ++b) {
      bin_min[b] = {INFINITY, INFINITY, INFINITY};
      bin_max[b] = {-INFINITY, -INFINITY, -INFINITY};
    }
    for (int k = 0; k < m; ++k) {
      const V3 pmn = prim_min[idx[k]], pmx = prim_max[idx[k]];
      int b0 = static_cast<int>((axis_of(pmn, saxis) - n0) * sscale);
      int b1 = static_cast<int>((axis_of(pmx, saxis) - n0) * sscale);
      b0 = std::max(0, std::min(b0, kNumBins - 1));
      b1 = std::max(b0, std::min(b1, kNumBins - 1));
      ++entry[b0];
      ++exit_[b1];
      for (int b = b0; b <= b1; ++b) {
        // clip the prim AABB to the slab (chopped binning)
        V3 cmn = pmn, cmx = pmx;
        const float lo = n0 + b * inv, hi = n0 + (b + 1) * inv;
        if (saxis == 0) {
          cmn.x = std::max(cmn.x, lo);
          cmx.x = std::min(cmx.x, hi);
        } else if (saxis == 1) {
          cmn.y = std::max(cmn.y, lo);
          cmx.y = std::min(cmx.y, hi);
        } else {
          cmn.z = std::max(cmn.z, lo);
          cmx.z = std::min(cmx.z, hi);
        }
        bin_min[b] = vmin(bin_min[b], cmn);
        bin_max[b] = vmax(bin_max[b], cmx);
      }
    }
    float larea[kNumBins], rarea[kNumBins];
    int lcnt[kNumBins], rcnt[kNumBins];
    V3 amn = bin_min[0], amx = bin_max[0];
    int c = 0;
    for (int b = 0; b < kNumBins; ++b) {
      amn = vmin(amn, bin_min[b]);
      amx = vmax(amx, bin_max[b]);
      c += entry[b];
      larea[b] = half_area(amn, amx);
      lcnt[b] = c;  // prims entering at or before b
    }
    amn = bin_min[kNumBins - 1];
    amx = bin_max[kNumBins - 1];
    c = 0;
    for (int b = kNumBins - 1; b >= 0; --b) {
      amn = vmin(amn, bin_min[b]);
      amx = vmax(amx, bin_max[b]);
      c += exit_[b];
      rarea[b] = half_area(amn, amx);
      rcnt[b] = c;  // prims exiting at or after b
    }
    for (int b = 0; b + 1 < kNumBins; ++b) {
      if (lcnt[b] == 0 || rcnt[b + 1] == 0) continue;
      const int dups = lcnt[b] + rcnt[b + 1] - m;
      if (dups > *dup_budget) continue;
      const float cost = larea[b] * lcnt[b] + rarea[b + 1] * rcnt[b + 1];
      if (cost < sp_cost) {
        sp_cost = cost;
        sp_best = b;
        sp_dups = dups;
      }
    }
  }

  std::vector<int> left, right;
  if (sp_best >= 0 && sp_cost < obj_cost) {
    // spatial: straddlers go BOTH ways
    const float plane = n0 + (sp_best + 1) * (next_a / kNumBins);
    const float sscale = kNumBins * (1.0f - 1e-6f) / next_a;
    for (int k = 0; k < m; ++k) {
      const V3 pmn = prim_min[idx[k]], pmx = prim_max[idx[k]];
      int b0 = static_cast<int>((axis_of(pmn, saxis) - n0) * sscale);
      int b1 = static_cast<int>((axis_of(pmx, saxis) - n0) * sscale);
      b0 = std::max(0, std::min(b0, kNumBins - 1));
      b1 = std::max(b0, std::min(b1, kNumBins - 1));
      if (b0 <= sp_best) left.push_back(idx[k]);
      if (b1 > sp_best) right.push_back(idx[k]);
    }
    (void)plane;
    *dup_budget -= sp_dups;
  } else if (obj_best >= 0) {
    const float c0 = axis_of(cmin, oaxis);
    for (int k = 0; k < m; ++k) {
      int b = static_cast<int>((axis_of(cent[idx[k]], oaxis) - c0) * oscale);
      b = std::min(b, kNumBins - 1);
      if (b <= obj_best) left.push_back(idx[k]);
      else right.push_back(idx[k]);
    }
  } else {
    // degenerate: median split on the widest centroid axis
    std::vector<int> tmp(r.prims);
    std::stable_sort(tmp.begin(), tmp.end(), [&](int a, int b) {
      return axis_of(cent[a], oaxis) < axis_of(cent[b], oaxis);
    });
    left.assign(tmp.begin(), tmp.begin() + m / 2);
    right.assign(tmp.begin() + m / 2, tmp.end());
  }
  if (left.empty() || right.empty()) {
    // spatial plane collapsed to one side: fall back to median
    std::vector<int> tmp(r.prims);
    std::stable_sort(tmp.begin(), tmp.end(), [&](int a, int b) {
      return axis_of(cent[a], saxis) < axis_of(cent[b], saxis);
    });
    left.assign(tmp.begin(), tmp.begin() + m / 2);
    right.assign(tmp.begin() + m / 2, tmp.end());
  }

  if (*alloc + 2 > alloc_end) return false;
  const int li = *alloc, ri = *alloc + 1;
  *alloc += 2;
  S.lchild[r.node] = li;
  stack.push_back({ri, std::move(right)});
  stack.push_back({li, std::move(left)});
  return true;
}

}  // namespace

extern "C" int zyg_build_bvh2(
    const float *prim_min_f, const float *prim_max_f, int n, int leaf_size,
    float *nodes_min, float *nodes_max, int *hit_link, int *miss_link,
    int *first_prim, int *prim_count, int *prim_order, int cap,
    int prim_cap, int *out_nprims) {
  if (n <= 0 || cap < 1 || prim_cap < n) return -1;
  const V3 *prim_min = reinterpret_cast<const V3 *>(prim_min_f);
  const V3 *prim_max = reinterpret_cast<const V3 *>(prim_max_f);

  std::vector<V3> cent(n);
  for (int i = 0; i < n; ++i) {
    cent[i] = {0.5f * (prim_min[i].x + prim_max[i].x),
               0.5f * (prim_min[i].y + prim_max[i].y),
               0.5f * (prim_min[i].z + prim_max[i].z)};
  }

  std::vector<V3> nmin(cap), nmax(cap);
  std::vector<int> lchild(cap, -1), first(cap, -1), count(cap, 0);
  Shared S{prim_min, prim_max, cent.data(), prim_order, leaf_size,
           nmin.data(), nmax.data(), lchild.data(), first.data(),
           count.data()};

  int node_count = 1;
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const int want = (n >= 1 << 15 && hw > 1) ? static_cast<int>(2 * hw) : 0;

  // ---- sequential top over vector ranges: spatial OR object splits,
  // straddling references duplicated within the prim_cap budget. Runs
  // the top ~5 levels (ranges larger than n/32) — where child overlap,
  // and therefore spatial-split benefit, concentrates.
  int dup_budget = prim_cap - n;
  const int spatial_min =
      std::max({n >> 5, 4 * leaf_size, 1024});
  const bool top_phase = n >= (1 << 14) && dup_budget > 0;
  std::vector<VRange> vstack, vleaves;
  {
    VRange root;
    root.node = 0;
    root.prims.resize(n);
    for (int i = 0; i < n; ++i) root.prims[i] = i;
    vstack.push_back(std::move(root));
  }
  while (top_phase && !vstack.empty()) {
    if (static_cast<int>(vstack.back().prims.size()) <= spatial_min) {
      vleaves.push_back(std::move(vstack.back()));
      vstack.pop_back();
      continue;
    }
    VRange r = std::move(vstack.back());
    vstack.pop_back();
    if (!process_vrange(S, std::move(r), vstack, &node_count, cap,
                        &dup_budget))
      return -1;
  }

  // ---- flatten vranges into the shared prim array; unsplit remainder
  // continues on the lock-free in-place machinery
  std::vector<Range> stack;
  {
    int lo = 0;
    auto flatten = [&](std::vector<VRange> &src) -> bool {
      for (auto &vr : src) {
        const int m = static_cast<int>(vr.prims.size());
        if (lo + m > prim_cap) return false;
        std::memcpy(prim_order + lo, vr.prims.data(), m * sizeof(int));
        stack.push_back({vr.node, lo, lo + m});
        lo += m;
      }
      return true;
    };
    if (!flatten(vstack) || !flatten(vleaves)) return -1;
    *out_nprims = lo;
  }
  std::vector<int> scratch(n);
  while (!stack.empty() &&
         (want == 0 || static_cast<int>(stack.size()) < want)) {
    const Range r = stack.back();
    stack.pop_back();
    if (!process_range(S, r, stack, scratch, &node_count, cap)) return -1;
  }

  if (!stack.empty()) {
    // ---- parallel subtrees in disjoint node blocks (<= 2m-1 nodes each)
    const int ntasks = static_cast<int>(stack.size());
    std::vector<int> base(ntasks), end(ntasks);
    {
      long long acc = node_count;
      for (int i = 0; i < ntasks; ++i) {
        const long long need = 2LL * (stack[i].hi - stack[i].lo);
        base[i] = static_cast<int>(acc);
        acc += need;
        end[i] = static_cast<int>(acc);
      }
      if (acc > cap) return -1;
      node_count = static_cast<int>(acc);
    }
    std::vector<char> failed(ntasks, 0);
    const int nthreads = std::min<int>(hw, ntasks);
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int tid = 0; tid < nthreads; ++tid) {
      pool.emplace_back([&, tid]() {
        std::vector<Range> st;
        std::vector<int> scr;
        for (int i = tid; i < ntasks; i += nthreads) {
          st.clear();
          st.push_back(stack[i]);
          int alloc = base[i];
          while (!st.empty()) {
            const Range r = st.back();
            st.pop_back();
            if (!process_range(S, r, st, scr, &alloc, end[i])) {
              failed[i] = 1;
              return;
            }
          }
        }
      });
    }
    for (auto &t : pool) t.join();
    for (int i = 0; i < ntasks; ++i)
      if (failed[i]) return -1;
  }

  // DFS renumber + thread (hit/miss links), matching bvh.py's layout
  std::vector<int> new_index(node_count, -1), dfs;
  dfs.reserve(node_count);
  {
    std::vector<int> st = {0};
    while (!st.empty()) {
      const int ni = st.back();
      st.pop_back();
      new_index[ni] = static_cast<int>(dfs.size());
      dfs.push_back(ni);
      if (lchild[ni] >= 0) {
        st.push_back(lchild[ni] + 1);
        st.push_back(lchild[ni]);
      }
    }
  }
  const int mcount = static_cast<int>(dfs.size());
  for (int i = 0; i < mcount; ++i) {
    const int old = dfs[i];
    nodes_min[3 * i + 0] = nmin[old].x;
    nodes_min[3 * i + 1] = nmin[old].y;
    nodes_min[3 * i + 2] = nmin[old].z;
    nodes_max[3 * i + 0] = nmax[old].x;
    nodes_max[3 * i + 1] = nmax[old].y;
    nodes_max[3 * i + 2] = nmax[old].z;
    first_prim[i] = first[old];
    prim_count[i] = count[old];
  }
  // miss links via DFS with "next right sibling"
  {
    std::vector<std::pair<int, int>> work = {{0, -1}};
    while (!work.empty()) {
      const auto [i, ms] = work.back();
      work.pop_back();
      miss_link[i] = ms;
      const int old = dfs[i];
      if (lchild[old] >= 0) {
        const int l_new = new_index[lchild[old]];
        const int r_new = new_index[lchild[old] + 1];
        hit_link[i] = l_new;
        work.push_back({l_new, r_new});
        work.push_back({r_new, ms});
      } else {
        hit_link[i] = ms;
      }
    }
  }
  return mcount;
}
