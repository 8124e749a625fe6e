// Native BVH builder: binned-SAH BVH2 (+ SBVH spatial splits) + wide
// collapse emitters.
//
// Counterpart of the reference's tinybvh C plugin
// (Assets/Plugins/Web/plugin.cpp) — same role (host-side acceleration
// structure construction, called through an FFI boundary), new
// implementation emitting the SoA node layout the JAX traversal consumes
// (see unity_webgpu_pathtracer_tpu/accel/mbvh.py for the format contract):
//   bounds[n*48 .. ] = [lox*8 | loy*8 | loz*8 | hix*8 | hiy*8 | hiz*8]
//   child[n*8 + k]   = 0 empty, c>0 inner node (c-1), c<0 leaf -(off*16+cnt)
//
// Algorithms:
//  * 8-bin SAH sweep per axis (same family as tiny_bvh.h:2292-2380),
//    leaves capped at `leaf_size` triangles, collapse grows each wide node
//    by expanding the largest-surface-area inner child until slots fill.
//  * SBVH spatial splits (quality=1; the same algorithm family as the
//    reference's vendored-but-unused tinybvh BuildHQ): binned object split
//    vs binned spatial split with triangle clipping, chosen per node by
//    SAH; straddling references are split (duplicated) under a ref budget,
//    with reference unsplitting when the budget runs out.  The output
//    `order` array becomes a REFERENCE list (length >= tri_count, entries
//    are original triangle ids, duplicates allowed).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <array>
#include <utility>
#include <vector>

namespace {

constexpr int kBins = 8;
constexpr int kWidth = 8;
constexpr int kLeafCntBits = 16;

struct V3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

static inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float area(const V3& lo, const V3& hi) {
  float dx = std::max(hi.x - lo.x, 0.f);
  float dy = std::max(hi.y - lo.y, 0.f);
  float dz = std::max(hi.z - lo.z, 0.f);
  return dx * dy + dy * dz + dz * dx;
}

struct Node2 {
  V3 lo, hi;
  int left = -1;   // right = left + 1
  int start = 0;
  int count = 0;   // >0 -> leaf
};

struct Builder {
  const float* pos;
  int tri_count;
  int leaf_size;
  std::vector<V3> tlo, thi, cent;
  std::vector<int> order;
  std::vector<Node2> nodes;

  void tri_bounds() {
    tlo.resize(tri_count);
    thi.resize(tri_count);
    cent.resize(tri_count);
    for (int i = 0; i < tri_count; ++i) {
      const float* p = pos + i * 9;
      V3 a{p[0], p[1], p[2]}, b{p[3], p[4], p[5]}, c{p[6], p[7], p[8]};
      tlo[i] = vmin(vmin(a, b), c);
      thi[i] = vmax(vmax(a, b), c);
      cent[i] = {(tlo[i].x + thi[i].x) * 0.5f, (tlo[i].y + thi[i].y) * 0.5f,
                 (tlo[i].z + thi[i].z) * 0.5f};
    }
  }

  void build() {
    tri_bounds();
    order.resize(tri_count);
    for (int i = 0; i < tri_count; ++i) order[i] = i;
    nodes.reserve(2 * tri_count + 1);
    nodes.emplace_back();
    struct Item { int node, lo, hi; };
    std::vector<Item> stack{{0, 0, tri_count}};
    while (!stack.empty()) {
      Item it = stack.back();
      stack.pop_back();
      subdivide(it.node, it.lo, it.hi, stack);
    }
  }

  template <typename Stack>
  void subdivide(int ni, int lo, int hi, Stack& stack) {
    V3 blo{FLT_MAX, FLT_MAX, FLT_MAX}, bhi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    V3 clo{FLT_MAX, FLT_MAX, FLT_MAX}, chi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = lo; i < hi; ++i) {
      int t = order[i];
      blo = vmin(blo, tlo[t]);
      bhi = vmax(bhi, thi[t]);
      clo = vmin(clo, cent[t]);
      chi = vmax(chi, cent[t]);
    }
    Node2& nd = nodes[ni];
    nd.lo = blo;
    nd.hi = bhi;
    int n = hi - lo;
    if (n <= leaf_size) {
      nd.start = lo;
      nd.count = n;
      return;
    }

    // Binned SAH over centroid extent, all 3 axes.
    float best_cost = FLT_MAX;
    int best_axis = -1, best_bin = -1;
    float best_scale = 0.f, best_orig = 0.f;
    for (int axis = 0; axis < 3; ++axis) {
      float ext = chi[axis] - clo[axis];
      if (ext <= 1e-12f) continue;
      float scale = kBins * (1.0f - 1e-6f) / ext;
      int cnt[kBins] = {0};
      V3 binlo[kBins], binhi[kBins];
      for (int b = 0; b < kBins; ++b) {
        binlo[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
        binhi[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      }
      for (int i = lo; i < hi; ++i) {
        int t = order[i];
        int b = std::min(int((cent[t][axis] - clo[axis]) * scale), kBins - 1);
        cnt[b]++;
        binlo[b] = vmin(binlo[b], tlo[t]);
        binhi[b] = vmax(binhi[b], thi[t]);
      }
      // Left/right sweeps.
      float sal[kBins], sar[kBins];
      int nl[kBins], nr[kBins];
      V3 acc_lo{FLT_MAX, FLT_MAX, FLT_MAX}, acc_hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int acc_n = 0;
      for (int b = 0; b < kBins; ++b) {
        acc_lo = vmin(acc_lo, binlo[b]);
        acc_hi = vmax(acc_hi, binhi[b]);
        acc_n += cnt[b];
        sal[b] = area(acc_lo, acc_hi);
        nl[b] = acc_n;
      }
      acc_lo = {FLT_MAX, FLT_MAX, FLT_MAX};
      acc_hi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      acc_n = 0;
      for (int b = kBins - 1; b >= 0; --b) {
        acc_lo = vmin(acc_lo, binlo[b]);
        acc_hi = vmax(acc_hi, binhi[b]);
        acc_n += cnt[b];
        sar[b] = area(acc_lo, acc_hi);
        nr[b] = acc_n;
      }
      for (int b = 0; b < kBins - 1; ++b) {
        if (nl[b] == 0 || nr[b + 1] == 0) continue;
        float cost = sal[b] * nl[b] + sar[b + 1] * nr[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
          best_scale = scale;
          best_orig = clo[axis];
        }
      }
    }

    int mid;
    if (best_axis < 0) {
      // Degenerate centroids: median split on the longest axis.
      int axis = 0;
      V3 ext{chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
      if (ext.y > ext[axis]) axis = 1;
      if (ext.z > ext[axis]) axis = 2;
      mid = lo + n / 2;
      std::nth_element(order.begin() + lo, order.begin() + mid, order.begin() + hi,
                       [&](int a, int b) { return cent[a][axis] < cent[b][axis]; });
    } else {
      // Leaves are hard-capped at leaf_size (downstream formats pack exactly
      // leaf_size triangle lanes), so an unprofitable split still splits.
      auto side = [&](int t) {
        int b = std::min(int((cent[t][best_axis] - best_orig) * best_scale), kBins - 1);
        return b <= best_bin;
      };
      int i = lo, j = hi - 1;
      while (i <= j) {
        if (side(order[i])) { ++i; }
        else { std::swap(order[i], order[j]); --j; }
      }
      mid = i;
      if (mid == lo || mid == hi) mid = lo + n / 2;  // safety
    }

    int li = (int)nodes.size();
    nodes.emplace_back();
    nodes.emplace_back();
    nodes[ni].left = li;
    stack.push_back({li, lo, mid});
    stack.push_back({li + 1, mid, hi});
  }
};

// ---------------------------------------------------------------------------
// SBVH: binned object-split vs binned spatial-split builder (Stich et al.
// 2009 family — the algorithm behind tinybvh's vendored-but-unused BuildHQ).
// Produces the same (nodes, order) contract as Builder, except `order` is a
// reference list: original triangle ids, length >= tri_count, duplicates
// allowed (a triangle straddling a spatial split appears in both subtrees).
// ---------------------------------------------------------------------------
struct Ref {
  int tri;
  V3 lo, hi;
};

static inline bool box_valid(const V3& lo, const V3& hi) {
  return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z;
}

struct SBVHBuilder {
  static constexpr int NB = 16;           // bins (object and spatial)
  static constexpr float kAlpha = 1e-5f;  // overlap trigger vs root area
  const float* pos;   // (F, 9) triangle vertices
  int tri_count;
  int leaf_size;
  std::vector<Node2> nodes;
  std::vector<int> order;   // leaf refs in DFS order (subtree-contiguous)
  long long ref_budget = 0;
  long long live_refs = 0;
  float root_area = 0.f;

  // Sutherland-Hodgman clip of a convex polygon against one axis plane.
  static int clip_plane(const V3* in, int n, int axis, float c,
                        bool keep_above, V3* out) {
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const V3& a = in[i];
      const V3& b = in[(i + 1) % n];
      float da = keep_above ? a[axis] - c : c - a[axis];
      float db = keep_above ? b[axis] - c : c - b[axis];
      if (da >= 0) out[m++] = a;
      if ((da >= 0) != (db >= 0)) {
        float f = da / (da - db);
        out[m++] = {a.x + f * (b.x - a.x), a.y + f * (b.y - a.y),
                    a.z + f * (b.z - a.z)};
      }
    }
    return m;
  }

  // AABB of the ORIGINAL triangle clipped to the axis slab [l, r],
  // intersected with the ref's own box (the ref may be a fragment).
  bool clip_box(const Ref& ref, int axis, float l, float r,
                V3* out_lo, V3* out_hi) const {
    const float* p = pos + (size_t)ref.tri * 9;
    V3 a[9] = {{p[0], p[1], p[2]}, {p[3], p[4], p[5]}, {p[6], p[7], p[8]}};
    V3 b[9];
    int n = 3;
    if (l > -FLT_MAX) {
      n = clip_plane(a, n, axis, l, true, b);
    } else {
      std::memcpy(b, a, sizeof(V3) * 3);
    }
    n = clip_plane(b, n, axis, r, false, a);
    if (n == 0) return false;
    V3 lo{FLT_MAX, FLT_MAX, FLT_MAX}, hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = 0; i < n; ++i) {
      lo = vmin(lo, a[i]);
      hi = vmax(hi, a[i]);
    }
    lo = vmax(lo, ref.lo);
    hi = vmin(hi, ref.hi);
    // Clamp the split axis exactly to the slab so fragment unions stay
    // watertight at the plane.
    float* lo_a = &lo.x;
    float* hi_a = &hi.x;
    lo_a[axis] = std::max(lo_a[axis], l);
    hi_a[axis] = std::min(hi_a[axis], r);
    if (!box_valid(lo, hi)) return false;
    *out_lo = lo;
    *out_hi = hi;
    return true;
  }

  void build() {
    std::vector<Ref> refs(tri_count);
    V3 rlo{FLT_MAX, FLT_MAX, FLT_MAX}, rhi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = 0; i < tri_count; ++i) {
      const float* p = pos + (size_t)i * 9;
      V3 a{p[0], p[1], p[2]}, b{p[3], p[4], p[5]}, c{p[6], p[7], p[8]};
      refs[i] = {i, vmin(vmin(a, b), c), vmax(vmax(a, b), c)};
      rlo = vmin(rlo, refs[i].lo);
      rhi = vmax(rhi, refs[i].hi);
    }
    live_refs = tri_count;
    ref_budget = (long long)tri_count + tri_count / 2 + 64;
    root_area = area(rlo, rhi);
    nodes.reserve((size_t)tri_count * 2 + 16);
    order.reserve((size_t)ref_budget + 16);
    nodes.emplace_back();
    subdivide(0, std::move(refs));
  }

  void make_leaf(int ni, const std::vector<Ref>& refs) {
    int start = (int)order.size();
    int cnt = 0;
    for (const Ref& r : refs) {
      bool dup = false;
      for (int j = 0; j < cnt; ++j)
        if (order[start + j] == r.tri) { dup = true; break; }
      if (!dup) {
        order.push_back(r.tri);
        ++cnt;
      }
    }
    nodes[ni].start = start;
    nodes[ni].count = cnt;
  }

  bool do_spatial(std::vector<Ref>& refs, int axis, float split,
                  std::vector<Ref>& left, std::vector<Ref>& right) {
    const int n = (int)refs.size();
    left.reserve(n);
    right.reserve(n);
    for (const Ref& r : refs) {
      const float* rlo = &r.lo.x;
      const float* rhi = &r.hi.x;
      if (rhi[axis] <= split) {
        left.push_back(r);
      } else if (rlo[axis] >= split) {
        right.push_back(r);
      } else if (live_refs < ref_budget) {
        V3 llo, lhi, rrlo, rrhi;
        bool okl = clip_box(r, axis, -FLT_MAX, split, &llo, &lhi);
        bool okr = clip_box(r, axis, split, FLT_MAX, &rrlo, &rrhi);
        if (okl && okr) {
          left.push_back({r.tri, llo, lhi});
          right.push_back({r.tri, rrlo, rrhi});
          ++live_refs;
        } else if (okl) {
          left.push_back({r.tri, llo, lhi});
        } else if (okr) {
          right.push_back({r.tri, rrlo, rrhi});
        } else {
          left.push_back(r);   // fully degenerate fragment: keep whole
        }
      } else {
        // Budget exhausted: unsplit to the side covering more of the ref.
        float dl = split - rlo[axis], dr = rhi[axis] - split;
        (dl >= dr ? left : right).push_back(r);
      }
    }
    if (left.empty() || right.empty()) return false;
    if ((int)left.size() >= n && (int)right.size() >= n) return false;
    return true;
  }

  void subdivide(int ni, std::vector<Ref> refs) {
    V3 blo{FLT_MAX, FLT_MAX, FLT_MAX}, bhi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    V3 clo{FLT_MAX, FLT_MAX, FLT_MAX}, chi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (const Ref& r : refs) {
      blo = vmin(blo, r.lo);
      bhi = vmax(bhi, r.hi);
      V3 cen{(r.lo.x + r.hi.x) * 0.5f, (r.lo.y + r.hi.y) * 0.5f,
             (r.lo.z + r.hi.z) * 0.5f};
      clo = vmin(clo, cen);
      chi = vmax(chi, cen);
    }
    nodes[ni].lo = blo;
    nodes[ni].hi = bhi;
    const int n = (int)refs.size();
    if (n <= leaf_size) {
      make_leaf(ni, refs);
      return;
    }

    // ---- object split: binned SAH over ref centroids ----
    float obj_cost = FLT_MAX;
    int obj_axis = -1, obj_bin = -1;
    float obj_scale = 0.f, obj_orig = 0.f;
    V3 oL_lo{}, oL_hi{}, oR_lo{}, oR_hi{};
    for (int axis = 0; axis < 3; ++axis) {
      const float* clo_a = &clo.x;
      const float* chi_a = &chi.x;
      float ext = chi_a[axis] - clo_a[axis];
      if (ext <= 1e-12f) continue;
      float scale = NB * (1.0f - 1e-6f) / ext;
      int cnt[NB] = {0};
      V3 binlo[NB], binhi[NB];
      for (int b = 0; b < NB; ++b) {
        binlo[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
        binhi[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      }
      for (const Ref& r : refs) {
        float cen = ((&r.lo.x)[axis] + (&r.hi.x)[axis]) * 0.5f;
        int b = std::min((int)((cen - clo_a[axis]) * scale), NB - 1);
        cnt[b]++;
        binlo[b] = vmin(binlo[b], r.lo);
        binhi[b] = vmax(binhi[b], r.hi);
      }
      V3 plo[NB], phi[NB], slo[NB], shi[NB];
      int nl[NB], nr[NB];
      V3 alo{FLT_MAX, FLT_MAX, FLT_MAX}, ahi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int an = 0;
      for (int b = 0; b < NB; ++b) {
        alo = vmin(alo, binlo[b]);
        ahi = vmax(ahi, binhi[b]);
        an += cnt[b];
        plo[b] = alo; phi[b] = ahi; nl[b] = an;
      }
      alo = {FLT_MAX, FLT_MAX, FLT_MAX};
      ahi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      an = 0;
      for (int b = NB - 1; b >= 0; --b) {
        alo = vmin(alo, binlo[b]);
        ahi = vmax(ahi, binhi[b]);
        an += cnt[b];
        slo[b] = alo; shi[b] = ahi; nr[b] = an;
      }
      for (int b = 0; b < NB - 1; ++b) {
        if (nl[b] == 0 || nr[b + 1] == 0) continue;
        float cost = area(plo[b], phi[b]) * nl[b] + area(slo[b + 1], shi[b + 1]) * nr[b + 1];
        if (cost < obj_cost) {
          obj_cost = cost;
          obj_axis = axis;
          obj_bin = b;
          obj_scale = scale;
          obj_orig = clo_a[axis];
          oL_lo = plo[b]; oL_hi = phi[b];
          oR_lo = slo[b + 1]; oR_hi = shi[b + 1];
        }
      }
    }

    // ---- spatial split: only when the object split's children overlap ----
    float sp_cost = FLT_MAX;
    int sp_axis = -1;
    float sp_pos = 0.f;
    bool try_spatial = true;
    if (obj_axis >= 0) {
      V3 ovlo = vmax(oL_lo, oR_lo), ovhi = vmin(oL_hi, oR_hi);
      try_spatial = box_valid(ovlo, ovhi) && area(ovlo, ovhi) > kAlpha * root_area;
    }
    if (try_spatial) {
      const float* blo_a = &blo.x;
      const float* bhi_a = &bhi.x;
      for (int axis = 0; axis < 3; ++axis) {
        float ext = bhi_a[axis] - blo_a[axis];
        if (ext <= 1e-12f) continue;
        float scale = NB * (1.0f - 1e-6f) / ext;
        float width = ext / (NB * (1.0f - 1e-6f));
        int entry[NB] = {0}, exit_[NB] = {0};
        V3 binlo[NB], binhi[NB];
        for (int b = 0; b < NB; ++b) {
          binlo[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
          binhi[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        }
        for (const Ref& r : refs) {
          int b0 = std::min(std::max((int)(((&r.lo.x)[axis] - blo_a[axis]) * scale), 0), NB - 1);
          int b1 = std::min(std::max((int)(((&r.hi.x)[axis] - blo_a[axis]) * scale), b0), NB - 1);
          entry[b0]++;
          exit_[b1]++;
          if (b0 == b1) {
            binlo[b0] = vmin(binlo[b0], r.lo);
            binhi[b0] = vmax(binhi[b0], r.hi);
          } else {
            for (int b = b0; b <= b1; ++b) {
              float l = b == 0 ? blo_a[axis] : blo_a[axis] + b * width;
              float rr = b == NB - 1 ? bhi_a[axis] : blo_a[axis] + (b + 1) * width;
              V3 flo, fhi;
              if (clip_box(r, axis, l, rr, &flo, &fhi)) {
                binlo[b] = vmin(binlo[b], flo);
                binhi[b] = vmax(binhi[b], fhi);
              }
            }
          }
        }
        float larea[NB], rarea[NB];
        int lcnt[NB], rcnt[NB];
        V3 alo{FLT_MAX, FLT_MAX, FLT_MAX}, ahi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
        int an = 0;
        for (int b = 0; b < NB; ++b) {
          alo = vmin(alo, binlo[b]);
          ahi = vmax(ahi, binhi[b]);
          an += entry[b];
          larea[b] = box_valid(alo, ahi) ? area(alo, ahi) : 0.f;
          lcnt[b] = an;
        }
        alo = {FLT_MAX, FLT_MAX, FLT_MAX};
        ahi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        an = 0;
        for (int b = NB - 1; b >= 0; --b) {
          alo = vmin(alo, binlo[b]);
          ahi = vmax(ahi, binhi[b]);
          an += exit_[b];
          rarea[b] = box_valid(alo, ahi) ? area(alo, ahi) : 0.f;
          rcnt[b] = an;
        }
        for (int b = 0; b < NB - 1; ++b) {
          if (lcnt[b] == 0 || rcnt[b + 1] == 0) continue;
          float cost = larea[b] * lcnt[b] + rarea[b + 1] * rcnt[b + 1];
          if (cost < sp_cost) {
            sp_cost = cost;
            sp_axis = axis;
            sp_pos = blo_a[axis] + (b + 1) * width;
          }
        }
      }
    }

    // ---- partition ----
    std::vector<Ref> left, right;
    bool did = false;
    if (sp_axis >= 0 && sp_cost < obj_cost) {
      did = do_spatial(refs, sp_axis, sp_pos, left, right);
      if (!did) { left.clear(); right.clear(); }
    }
    if (!did && obj_axis >= 0) {
      for (const Ref& r : refs) {
        float cen = ((&r.lo.x)[obj_axis] + (&r.hi.x)[obj_axis]) * 0.5f;
        int b = std::min((int)((cen - obj_orig) * obj_scale), NB - 1);
        (b <= obj_bin ? left : right).push_back(r);
      }
      did = !left.empty() && !right.empty();
      if (!did) { left.clear(); right.clear(); }
    }
    if (!did) {
      // Degenerate: median split on the longest centroid axis.
      int axis = 0;
      V3 ext{chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
      if (ext.y > ext[axis]) axis = 1;
      if (ext.z > ext[axis]) axis = 2;
      std::sort(refs.begin(), refs.end(), [axis](const Ref& a, const Ref& b) {
        return (&a.lo.x)[axis] + (&a.hi.x)[axis] < (&b.lo.x)[axis] + (&b.hi.x)[axis];
      });
      int mid = n / 2;
      left.assign(refs.begin(), refs.begin() + mid);
      right.assign(refs.begin() + mid, refs.end());
    }
    refs.clear();
    refs.shrink_to_fit();

    int li = (int)nodes.size();
    nodes.emplace_back();
    nodes.emplace_back();
    nodes[ni].left = li;
    subdivide(li, std::move(left));
    subdivide(li + 1, std::move(right));
  }
};

struct Collapser {
  const Builder& b;
  std::vector<float>& bounds;
  std::vector<int32_t>& child;
  std::vector<float> sa;

  int emit(int c0, int c1) {
    int my = (int)(child.size() / kWidth);
    bounds.resize(bounds.size() + 48, 0.f);
    child.resize(child.size() + kWidth, 0);

    int kids[kWidth];
    int nk = 0;
    kids[nk++] = c0;
    kids[nk++] = c1;
    while (nk < kWidth) {
      int grow = -1;
      float best = -1.f;
      for (int i = 0; i < nk; ++i) {
        int k = kids[i];
        if (b.nodes[k].count == 0 && sa[k] > best) {
          best = sa[k];
          grow = i;
        }
      }
      if (grow < 0) break;
      int k = kids[grow];
      kids[grow] = b.nodes[k].left;
      kids[nk++] = b.nodes[k].left + 1;
    }

    float* row = bounds.data() + (size_t)my * 48;
    for (int a = 0; a < 3; ++a)
      for (int s = 0; s < kWidth; ++s) {
        row[a * kWidth + s] = FLT_MAX;          // lo
        row[(3 + a) * kWidth + s] = -FLT_MAX;   // hi
      }
    for (int s = 0; s < nk; ++s) {
      const Node2& nd = b.nodes[kids[s]];
      row[0 * kWidth + s] = nd.lo.x;
      row[1 * kWidth + s] = nd.lo.y;
      row[2 * kWidth + s] = nd.lo.z;
      row[3 * kWidth + s] = nd.hi.x;
      row[4 * kWidth + s] = nd.hi.y;
      row[5 * kWidth + s] = nd.hi.z;
      if (nd.count > 0) {
        child[(size_t)my * kWidth + s] =
            -(int32_t)((int64_t)nd.start * kLeafCntBits + nd.count);
      } else {
        int sub = emit(nd.left, nd.left + 1);
        // `row` may dangle after reallocation inside emit(); re-derive it.
        row = bounds.data() + (size_t)my * 48;
        child[(size_t)my * kWidth + s] = sub + 1;
      }
    }
    return my;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// Skip-pointer linearization (ops/traverse_skip.py format): 8 octant DFS
// orders; node row = [lo.xyz, hi.xyz, leaf_code(int), skip(int)].
// ---------------------------------------------------------------------------
extern "C" int build_skip_bvh(const float* positions, int tri_count,
                              int leaf_size, float* out_nodes,
                              int32_t* out_order, int node_capacity) {
  if (tri_count <= 0 || leaf_size <= 0 || leaf_size >= kLeafCntBits) return -1;
  Builder bld{positions, tri_count, leaf_size};
  bld.build();
  const int n = (int)bld.nodes.size();
  if (n > node_capacity) return -1;

  // Split axis per inner node from child centroid separation.
  std::vector<int> axis(n, 0);
  for (int i = 0; i < n; ++i) {
    const Node2& nd = bld.nodes[i];
    if (nd.count > 0) continue;
    const Node2 &l = bld.nodes[nd.left], &r = bld.nodes[nd.left + 1];
    float dx = std::fabs((r.lo.x + r.hi.x) - (l.lo.x + l.hi.x));
    float dy = std::fabs((r.lo.y + r.hi.y) - (l.lo.y + l.hi.y));
    float dz = std::fabs((r.lo.z + r.hi.z) - (l.lo.z + l.hi.z));
    axis[i] = dx >= dy ? (dx >= dz ? 0 : 2) : (dy >= dz ? 1 : 2);
  }
  // Subtree sizes (post-order via explicit stack).
  std::vector<int> subtree(n, 1);
  {
    std::vector<std::pair<int, bool>> st{{0, false}};
    while (!st.empty()) {
      auto [node, done] = st.back();
      st.pop_back();
      const Node2& nd = bld.nodes[node];
      if (nd.count > 0) continue;
      if (done) {
        subtree[node] = 1 + subtree[nd.left] + subtree[nd.left + 1];
      } else {
        st.push_back({node, true});
        st.push_back({nd.left, false});
        st.push_back({nd.left + 1, false});
      }
    }
  }

  for (int oct = 0; oct < 8; ++oct) {
    float* rows = out_nodes + (size_t)oct * node_capacity * 8;
    int cursor = 0;
    // Pre-order DFS with octant-dependent child order; skip = index+subtree.
    std::vector<int> stack{0};
    while (!stack.empty()) {
      int node = stack.back();
      stack.pop_back();
      const Node2& nd = bld.nodes[node];
      float* row = rows + (size_t)cursor * 8;
      row[0] = nd.lo.x; row[1] = nd.lo.y; row[2] = nd.lo.z;
      row[3] = nd.hi.x; row[4] = nd.hi.y; row[5] = nd.hi.z;
      int32_t leaf_code = 0;
      if (nd.count > 0)
        leaf_code = (int32_t)((int64_t)nd.start * kLeafCntBits + nd.count);
      int32_t skip = cursor + subtree[node];
      std::memcpy(row + 6, &leaf_code, 4);
      std::memcpy(row + 7, &skip, 4);
      ++cursor;
      if (nd.count == 0) {
        int first = nd.left, second = nd.left + 1;
        if ((oct >> axis[node]) & 1) std::swap(first, second);
        stack.push_back(second);  // popped after `first`
        stack.push_back(first);
      }
    }
  }
  std::memcpy(out_order, bld.order.data(), bld.order.size() * sizeof(int32_t));
  return n;
}

// ---------------------------------------------------------------------------
// Fat-row 4-ary format (ops/traverse_wide.py / accel/wide.py contract):
// unified (N, 48) float rows per octant order.
//   internal: [0:24] 4 child AABBs, [24:28] child DFS ptrs (int),
//             [44] skip (int), [45] leaf count = 0
//   leaf:     [0:36] 4-lane SoA tri records [e2x*4|e2y*4|...|v0z*4],
//             [36:40] attribute indices (int), [44] skip, [45] count 1..4
// ---------------------------------------------------------------------------
namespace {

struct WideEmitter {
  const Builder& b;
  const float* recs;          // (F, 9) [e2,e1,v0] in *original* order
  const std::vector<int>& axis;
  int octant;
  float* rows;                // (cap, 48) output for this octant
  int cursor = 0;
  int capacity;

  void leaf_row(float* row, const Node2& nd) {
    int cnt = nd.count;
    for (int c = 0; c < 9; ++c)
      for (int k = 0; k < 4; ++k)
        row[c * 4 + k] = 0.f;
    int32_t idx4[4] = {0, 0, 0, 0};
    for (int k = 0; k < cnt; ++k) {
      int orig = b.order[nd.start + k];
      const float* rec = recs + (size_t)orig * 9;
      for (int c = 0; c < 9; ++c) row[c * 4 + k] = rec[c];
      idx4[k] = orig;
    }
    std::memcpy(row + 36, idx4, 16);
    int32_t cnt32 = cnt;
    std::memcpy(row + 45, &cnt32, 4);
  }

  int children4(int node, int* kids) {
    const Node2& nd = b.nodes[node];
    int pair[2] = {nd.left, nd.left + 1};
    if ((octant >> axis[node]) & 1) std::swap(pair[0], pair[1]);
    int n = 0;
    for (int c : pair) {
      if (b.nodes[c].count > 0) {
        kids[n++] = c;
      } else {
        int sub[2] = {b.nodes[c].left, b.nodes[c].left + 1};
        if ((octant >> axis[c]) & 1) std::swap(sub[0], sub[1]);
        kids[n++] = sub[0];
        kids[n++] = sub[1];
      }
    }
    return n;
  }

  int emit(int node) {
    if (cursor >= capacity) return -1;
    int my = cursor++;
    float* row = rows + (size_t)my * 48;
    std::memset(row, 0, 48 * sizeof(float));
    const Node2& nd = b.nodes[node];
    if (nd.count > 0) {
      leaf_row(row, nd);
    } else {
      int kids[4];
      int nk = children4(node, kids);
      // SoA within the row: [lox*4|loy*4|loz*4|hix*4|hiy*4|hiz*4].
      for (int k = 0; k < 4; ++k) {
        row[0 * 4 + k] = row[1 * 4 + k] = row[2 * 4 + k] = FLT_MAX;
        row[3 * 4 + k] = row[4 * 4 + k] = row[5 * 4 + k] = -FLT_MAX;
      }
      int32_t ptrs[4] = {0, 0, 0, 0};
      for (int k = 0; k < nk; ++k) {
        const Node2& c = b.nodes[kids[k]];
        row[0 * 4 + k] = c.lo.x; row[1 * 4 + k] = c.lo.y; row[2 * 4 + k] = c.lo.z;
        row[3 * 4 + k] = c.hi.x; row[4 * 4 + k] = c.hi.y; row[5 * 4 + k] = c.hi.z;
        int sub = emit(kids[k]);
        if (sub < 0) return -1;
        row = rows + (size_t)my * 48;  // re-derive (no realloc here, but keep pattern)
        ptrs[k] = sub;
      }
      std::memcpy(row + 24, ptrs, 16);
    }
    int32_t skip = cursor;
    std::memcpy(row + 44, &skip, 4);
    return my;
  }
};

}  // namespace

extern "C" int build_wide_bvh(const float* positions, int tri_count,
                              int leaf_size, const float* tri_records,
                              float* out_nodes, int node_capacity,
                              int octants) {
  if (tri_count <= 0 || leaf_size <= 0 || leaf_size > 4) return -1;
  if (octants != 1 && octants != 8) return -1;
  Builder bld{positions, tri_count, leaf_size};
  bld.build();
  const int n2 = (int)bld.nodes.size();
  std::vector<int> axis(n2, 0);
  for (int i = 0; i < n2; ++i) {
    const Node2& nd = bld.nodes[i];
    if (nd.count > 0) continue;
    const Node2 &l = bld.nodes[nd.left], &r = bld.nodes[nd.left + 1];
    float dx = std::fabs((r.lo.x + r.hi.x) - (l.lo.x + l.hi.x));
    float dy = std::fabs((r.lo.y + r.hi.y) - (l.lo.y + l.hi.y));
    float dz = std::fabs((r.lo.z + r.hi.z) - (l.lo.z + l.hi.z));
    axis[i] = dx >= dy ? (dx >= dz ? 0 : 2) : (dy >= dz ? 1 : 2);
  }
  int count = -1;
  for (int oct = 0; oct < octants; ++oct) {
    WideEmitter em{bld, tri_records, axis, oct,
                   out_nodes + (size_t)oct * node_capacity * 48, 0, node_capacity};
    if (bld.nodes[0].count > 0) {
      // Single-leaf scene: root is itself a leaf row.
      float* row = em.rows;
      std::memset(row, 0, 48 * sizeof(float));
      em.leaf_row(row, bld.nodes[0]);
      int32_t skip = 1;
      std::memcpy(row + 44, &skip, 4);
      em.cursor = 1;
    } else if (em.emit(0) < 0) {
      return -1;
    }
    if (count >= 0 && em.cursor != count) return -1;
    count = em.cursor;
  }
  return count;
}

extern "C" int build_mbvh8(const float* positions, int tri_count, int leaf_size,
                           float* out_bounds, int32_t* out_child,
                           int32_t* out_order, int node_capacity) {
  if (tri_count <= 0 || leaf_size <= 0 || leaf_size >= kLeafCntBits) return -1;
  Builder bld{positions, tri_count, leaf_size};
  bld.build();

  std::vector<float> bounds;
  std::vector<int32_t> child;
  Collapser col{bld, bounds, child, {}};
  col.sa.resize(bld.nodes.size());
  for (size_t i = 0; i < bld.nodes.size(); ++i)
    col.sa[i] = area(bld.nodes[i].lo, bld.nodes[i].hi);

  if (bld.nodes[0].count > 0) {
    // Single-leaf scene.
    bounds.assign(48, 0.f);
    child.assign(kWidth, 0);
    for (int a = 0; a < 3; ++a)
      for (int s = 0; s < kWidth; ++s) {
        bounds[a * kWidth + s] = FLT_MAX;
        bounds[(3 + a) * kWidth + s] = -FLT_MAX;
      }
    const Node2& nd = bld.nodes[0];
    bounds[0 * kWidth] = nd.lo.x; bounds[1 * kWidth] = nd.lo.y; bounds[2 * kWidth] = nd.lo.z;
    bounds[3 * kWidth] = nd.hi.x; bounds[4 * kWidth] = nd.hi.y; bounds[5 * kWidth] = nd.hi.z;
    child[0] = -(int32_t)((int64_t)nd.start * kLeafCntBits + nd.count);
  } else {
    col.emit(bld.nodes[0].left, bld.nodes[0].left + 1);
  }

  int n = (int)(child.size() / kWidth);
  if (n > node_capacity) return -1;
  std::memcpy(out_bounds, bounds.data(), bounds.size() * sizeof(float));
  std::memcpy(out_child, child.data(), child.size() * sizeof(int32_t));
  std::memcpy(out_order, bld.order.data(), bld.order.size() * sizeof(int32_t));
  return n;
}

// ---------------------------------------------------------------------------
// wide8: 8-wide quantized stack format (accel/wide8.py layout).
// Row (48 floats): [0:3]=anchor, [3]=meta (0 inner / 1..8 leaf count),
// inner: [4]=packed biased exponents, [8:20]=q8 child boxes comp-major,
// [20:28]=child ptrs (-1 empty); leaf: [4:40]=9x8 f16 tri comps (v0 anchor-
// relative), [40:48]=attr idx. Matches the numpy builder's semantics.
// ---------------------------------------------------------------------------
namespace {

static inline uint16_t f2h(float f) {
  // Round-to-nearest-even float32 -> float16 (matches numpy astype), then
  // canonicalized to the table contract (accel/wide16.py::_canon_f16): NO
  // subnormals or -0 (both flush to +0 — offsets < 6.1e-5 world units are
  // below the f16 quantization noise anyway) and NO inf/nan (clamped to
  // +-65504).  The numpy emitter applies the same rule, so both builders
  // emit bit-identical tables.
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
  uint32_t man = x & 0x7FFFFFu;
  if (((x >> 23) & 0xFF) == 0xFF) return (uint16_t)(sign | 0x7BFFu);  // inf/nan -> max finite
  if (exp >= 0x1F) return (uint16_t)(sign | 0x7BFFu);  // overflow -> max finite
  if (exp <= 0) {
    if (exp < -10) return 0;                           // underflow -> +0
    man |= 0x800000u;
    int shift = 14 - exp;
    uint32_t half = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1);
    uint32_t mid = 1u << (shift - 1);
    if (rem > mid || (rem == mid && (half & 1))) half++;
    if ((half & 0x7C00u) == 0) return 0;               // subnormal -> +0
    return (uint16_t)(sign | half);
  }
  uint32_t half = (uint32_t)(exp << 10) | (man >> 13);
  uint32_t rem = man & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
  // Round-to-nearest can carry 0x7BFF -> 0x7C00 (inf): values in
  // (65504, 65520] overflow AFTER the exponent check above.  Clamp to max
  // finite like every other overflow (numpy rounds these to inf, which
  // _canon_f16 then clamps — the paths must stay bit-identical).
  if ((half & 0x7C00u) == 0x7C00u) half = 0x7BFFu;
  return (uint16_t)(sign | half);
}

struct Wide8Emitter {
  const Builder& b;
  const float* recs;   // (F,9) [e2,e1,v0] in ORIGINAL triangle order
  std::vector<int> sstart, scount;   // subtree ranges
  std::vector<float> rows;
  int max_depth = 0;

  void ranges() {
    int n = (int)b.nodes.size();
    sstart.resize(n);
    scount.resize(n);
    for (int i = n - 1; i >= 0; --i) {
      const Node2& nd = b.nodes[i];
      if (nd.count > 0) { sstart[i] = nd.start; scount[i] = nd.count; }
      else {
        int l = nd.left;
        sstart[i] = std::min(sstart[l], sstart[l + 1]);
        scount[i] = scount[l] + scount[l + 1];
      }
    }
  }

  float* new_row() {
    rows.resize(rows.size() + 48, 0.f);
    return rows.data() + rows.size() - 48;
  }

  int emit_leaf(int node) {
    int my = (int)(rows.size() / 48);
    float* row = new_row();
    const int lo = sstart[node], cnt = scount[node];
    const Node2& nd = b.nodes[node];
    row[0] = nd.lo.x; row[1] = nd.lo.y; row[2] = nd.lo.z;
    int32_t meta = cnt;
    std::memcpy(row + 3, &meta, 4);
    // 9 comps x 8 lanes f16, v0 (comps 6..8) anchor-relative.
    uint16_t halves[9][8] = {};
    int32_t idx[8];
    for (int k = 0; k < 8; ++k) idx[k] = -1;
    for (int j = 0; j < cnt; ++j) {
      int t = b.order[lo + j];
      const float* r = recs + (size_t)t * 9;
      for (int c = 0; c < 9; ++c) {
        float v = r[c];
        if (c >= 6) v -= row[c - 6];
        halves[c][j] = f2h(v);
      }
      // Attribute index = position in BVH order: the host permutes the
      // attribute tables by `order`, so spatially adjacent leaves read
      // adjacent attr rows (gather locality in the shade transition).
      idx[j] = lo + j;
    }
    std::memcpy(row + 4, halves, 9 * 8 * 2);
    std::memcpy(row + 40, idx, 8 * 4);
    return my;
  }

  int emit(int node, int depth) {
    max_depth = std::max(max_depth, depth);
    if (scount[node] <= 8) return emit_leaf(node);
    int my = (int)(rows.size() / 48);
    new_row();

    // Greedy SA collapse to <= 8 children; subtrees with <= 8 tris stay whole.
    int kids[8];
    int nk = 0;
    const Node2& nd = b.nodes[node];
    kids[nk++] = nd.left;
    kids[nk++] = nd.left + 1;
    while (nk < 8) {
      int grow = -1;
      float best = -1.f;
      for (int i = 0; i < nk; ++i) {
        int k = kids[i];
        if (b.nodes[k].count == 0 && scount[k] > 8) {
          float a = area(b.nodes[k].lo, b.nodes[k].hi);
          if (a > best) { best = a; grow = i; }
        }
      }
      if (grow < 0) break;
      int k = kids[grow];
      kids[grow] = b.nodes[k].left;
      kids[nk++] = b.nodes[k].left + 1;
    }

    // Octant slot assignment (largest child picks first; nearest free slot
    // by XOR distance ordered by popcount then value).
    int slots[8];
    for (int s = 0; s < 8; ++s) slots[s] = -1;
    int order_by_sa[8];
    for (int i = 0; i < nk; ++i) order_by_sa[i] = kids[i];
    std::sort(order_by_sa, order_by_sa + nk, [&](int a, int c) {
      return area(b.nodes[a].lo, b.nodes[a].hi) > area(b.nodes[c].lo, b.nodes[c].hi);
    });
    static const int xor_order[8] = {0, 1, 2, 4, 3, 5, 6, 7};
    float pcx = (nd.lo.x + nd.hi.x) * 0.5f;
    float pcy = (nd.lo.y + nd.hi.y) * 0.5f;
    float pcz = (nd.lo.z + nd.hi.z) * 0.5f;
    for (int i = 0; i < nk; ++i) {
      int c = order_by_sa[i];
      const Node2& cn = b.nodes[c];
      int code = ((cn.lo.x + cn.hi.x) * 0.5f > pcx ? 1 : 0)
               | ((cn.lo.y + cn.hi.y) * 0.5f > pcy ? 2 : 0)
               | ((cn.lo.z + cn.hi.z) * 0.5f > pcz ? 4 : 0);
      for (int d = 0; d < 8; ++d) {
        int s = code ^ xor_order[d];
        if (slots[s] < 0) { slots[s] = c; break; }
      }
    }

    // Quantize: anchor = node lo, conservative power-of-two scales.
    float anchor[3] = {nd.lo.x, nd.lo.y, nd.lo.z};
    float ext[3] = {std::max(nd.hi.x - nd.lo.x, 0.f),
                    std::max(nd.hi.y - nd.lo.y, 0.f),
                    std::max(nd.hi.z - nd.lo.z, 0.f)};
    int e[3];
    float scale[3];
    for (int c = 0; c < 3; ++c) {
      float v = std::max(ext[c] / 255.0f, 1e-30f);
      e[c] = (int)std::ceil(std::log2((double)v));
      e[c] = std::min(std::max(e[c], -126), 127);
      scale[c] = std::ldexp(1.0f, e[c]);
      if (255.0f * scale[c] < ext[c]) {
        e[c] = std::min(e[c] + 1, 127);
        scale[c] = std::ldexp(1.0f, e[c]);
      }
    }
    uint8_t qlo[3][8], qhi[3][8];
    for (int c = 0; c < 3; ++c)
      for (int s = 0; s < 8; ++s) { qlo[c][s] = 255; qhi[c][s] = 0; }
    for (int s = 0; s < 8; ++s) {
      if (slots[s] < 0) continue;
      const Node2& cn = b.nodes[slots[s]];
      float clo[3] = {cn.lo.x, cn.lo.y, cn.lo.z};
      float chi[3] = {cn.hi.x, cn.hi.y, cn.hi.z};
      for (int c = 0; c < 3; ++c) {
        float ql = std::floor((clo[c] - anchor[c]) / scale[c]);
        float qh = std::ceil((chi[c] - anchor[c]) / scale[c]);
        qlo[c][s] = (uint8_t)std::min(std::max(ql, 0.f), 255.f);
        qhi[c][s] = (uint8_t)std::min(std::max(qh, 0.f), 255.f);
      }
    }

    // Children first gives ptrs; then write the row (rows may reallocate).
    int32_t ptrs[8];
    for (int s = 0; s < 8; ++s)
      ptrs[s] = slots[s] < 0 ? -1 : emit(slots[s], depth + 1);

    float* row = rows.data() + (size_t)my * 48;
    row[0] = anchor[0]; row[1] = anchor[1]; row[2] = anchor[2];
    int32_t meta = 0;
    std::memcpy(row + 3, &meta, 4);
    int32_t eword = (e[0] + 127) | ((e[1] + 127) << 8) | ((e[2] + 127) << 16);
    std::memcpy(row + 4, &eword, 4);
    uint8_t qbytes[48];
    for (int c = 0; c < 3; ++c) {
      std::memcpy(qbytes + c * 8, qlo[c], 8);
      std::memcpy(qbytes + 24 + c * 8, qhi[c], 8);
    }
    std::memcpy(row + 8, qbytes, 48);
    std::memcpy(row + 20, ptrs, 8 * 4);
    return my;
  }
};

}  // namespace

extern "C" int build_wide8(const float* positions, const float* tri_records,
                           int tri_count, int leaf_size, float* out_rows,
                           int row_capacity, int32_t* out_depth,
                           int32_t* out_order) {
  if (tri_count <= 0 || leaf_size <= 0 || leaf_size > 8) return -1;
  Builder bld{positions, tri_count, leaf_size};
  bld.build();
  Wide8Emitter em{bld, tri_records};
  em.ranges();
  em.emit(0, 1);
  int n = (int)(em.rows.size() / 48);
  if (n > row_capacity) return -1;
  std::memcpy(out_rows, em.rows.data(), em.rows.size() * sizeof(float));
  if (out_depth) *out_depth = em.max_depth;
  if (out_order)
    std::memcpy(out_order, bld.order.data(), bld.order.size() * sizeof(int32_t));
  return n;
}

// ---------------------------------------------------------------------------
// wide16: 16-wide quantized stack format (accel/wide16.py layout).
// Row (96 floats): [0:3]=anchor, [3]=meta (0 inner / 1..16 leaf count),
// inner: [4]=packed biased exponents, [8:32]=q8 child boxes comp-major
// (qlox*16|qloy*16|qloz*16|qhix*16|qhiy*16|qhiz*16), [32:48]=child ptrs
// (-1 empty); leaf: [4:76]=9x16 f16 tri comps (v0 anchor-relative),
// [76:92]=attr idx. Children in surface-area order (the traversal picks
// nearest-first at runtime from slab-entry t, so no octant coding).
// ---------------------------------------------------------------------------
namespace {

// SAH-optimal 16-wide collapse (Ylitie/Karras/Laine 2017 Sec. 3, adapted
// to the wavefront traversal's cost model: EVERY arrival -- inner or leaf
// -- costs one row gather per lane, and a leaf row's 16 MT slots
// are pre-paid whether occupied or not.  The objective is therefore the
// SA-weighted expected ARRIVAL count: c_leaf = one arrival for any leaf
// of <= LEAF refs (merging small sibling subtrees into one fuller leaf is
// free), c_node = one arrival per visited inner row.  The greedy
// largest-area collapse this replaces leaves many of the 16 slots empty.
//
// Tables per BVH2 node:
//   cdist[i] (i>=2): best cost of splitting the subtree into 2..i roots
//                    distributed over the two BVH2 children (full costs).
//   cfull[i]:        best cost as <= i roots; cfull[1] = min(leaf-able,
//                    wrap into one wide node at c_node*A + cdist[W]).
// Reconstruction: a wide node's children = the ddist[W] split (always a
// true 2-way distribute, so no self-reference); parents expand
// forest(v, i) by cfull's winner at budget i.
struct Collapse16DP {
  static constexpr int W = 16;
  const std::vector<Node2>& bn;
  const std::vector<int>& scount;
  int LEAF;
  float c_node = 1.0f, c_leaf = 1.0f;
  std::vector<std::array<float, W + 1>> cfull, cdist;
  std::vector<std::array<int8_t, W + 1>> ddist;  // j of best (j, i-j) split
  std::vector<int8_t> dsingle;                   // cfull[1]: 0 leaf, 1 wrap

  void run() {
    int n = (int)bn.size();
    cfull.resize(n);
    cdist.resize(n);
    ddist.resize(n);
    dsingle.resize(n);
    std::vector<int> st, order;
    st.push_back(0);
    order.reserve(n);
    while (!st.empty()) {
      int v = st.back();
      st.pop_back();
      order.push_back(v);
      if (bn[v].count == 0) {
        st.push_back(bn[v].left);
        st.push_back(bn[v].left + 1);
      }
    }
    for (int k = (int)order.size() - 1; k >= 0; --k) compute(order[k]);
  }

  void compute(int v) {
    float a = area(bn[v].lo, bn[v].hi);
    auto& cf = cfull[v];
    if (bn[v].count > 0) {
      // BVH2 leaf (count <= leaf_size <= LEAF): only a leaf row.
      for (int i = 1; i <= W; ++i) cf[i] = c_leaf * a;
      dsingle[v] = 0;
      for (int i = 2; i <= W; ++i) { cdist[v][i] = 1e30f; ddist[v][i] = 1; }
      return;
    }
    int l = bn[v].left, r = l + 1;
    auto& cd = cdist[v];
    auto& dd = ddist[v];
    for (int i = 2; i <= W; ++i) {
      cd[i] = 1e30f;
      dd[i] = 1;
      for (int j = 1; j < i; ++j) {
        float s = cfull[l][j] + cfull[r][i - j];
        if (s < cd[i]) { cd[i] = s; dd[i] = (int8_t)j; }
      }
      if (cd[i - 1] < cd[i] && i > 2) { cd[i] = cd[i - 1]; dd[i] = dd[i - 1]; }
    }
    float wrap = c_node * a + cd[W];
    int8_t ds = 1;
    if (scount[v] <= LEAF) {
      float lf = c_leaf * a;
      if (lf <= wrap) { wrap = lf; ds = 0; }
    }
    cf[1] = wrap;
    dsingle[v] = ds;
    for (int i = 2; i <= W; ++i) cf[i] = std::min(cf[1], cd[i]);
  }

  // Forest roots for (v, budget i): (bvh2 node, kind 0=leaf row 1=wide).
  void forest(int v, int i, std::vector<std::pair<int, int>>& out) const {
    if (i <= 1 || bn[v].count > 0 || cfull[v][1] <= cdist[v][i]) {
      out.push_back({v, (int)dsingle[v]});
      return;
    }
    int j = ddist[v][i];
    forest(bn[v].left, j, out);
    forest(bn[v].left + 1, i - j, out);
  }

  // Children of a node emitted AS a wide inner row: always the ddist[W]
  // distribute (never the single-root option, which would self-refer).
  void children(int v, std::vector<std::pair<int, int>>& out) const {
    int j = ddist[v][W];
    forest(bn[v].left, j, out);
    forest(bn[v].left + 1, W - j, out);
  }
};

struct Wide16Emitter {
  static constexpr int W = 16;   // children per inner node (both variants)
  // Takes the BVH2 by (nodes, order) so both the binned Builder and the
  // SBVH builder can feed it.  With SBVH, `order` is a reference list:
  // entries are original triangle ids and may repeat across leaves.
  const std::vector<Node2>& bnodes;
  const std::vector<int>& border;
  const float* recs;   // (F,9) [e2,e1,v0] in ORIGINAL triangle order
  // leaf8 variant (accel/wide16.py ROW8): 48-float rows, 8 triangle slots
  // per leaf (9x8 f16 at [4:40], attr idx at [40:48]); inner rows use
  // words 0..47 identically in both widths.
  int LEAF = 16;       // triangle slots per leaf row (16 or 8)
  int ROWF = 96;       // floats per row (96 or 48)
  const Collapse16DP* dp = nullptr;   // SAH-optimal collapse (else greedy)
  std::vector<int> sstart, scount;
  std::vector<float> rows;
  int max_depth = 0;

  void ranges() {
    int n = (int)bnodes.size();
    sstart.resize(n);
    scount.resize(n);
    for (int i = n - 1; i >= 0; --i) {
      const Node2& nd = bnodes[i];
      if (nd.count > 0) { sstart[i] = nd.start; scount[i] = nd.count; }
      else {
        int l = nd.left;
        sstart[i] = std::min(sstart[l], sstart[l + 1]);
        scount[i] = scount[l] + scount[l + 1];
      }
    }
  }

  float* new_row() {
    rows.resize(rows.size() + ROWF, 0.f);
    return rows.data() + rows.size() - ROWF;
  }

  int emit_leaf(int node) {
    int my = (int)(rows.size() / ROWF);
    float* row = new_row();
    const int lo = sstart[node], cnt = scount[node];
    const Node2& nd = bnodes[node];
    row[0] = nd.lo.x; row[1] = nd.lo.y; row[2] = nd.lo.z;
    uint16_t halves[9][W] = {};
    int32_t idx[W];
    for (int k = 0; k < W; ++k) idx[k] = -1;
    // SBVH subtrees merged into one leaf row can reference the same
    // triangle from several fragments; pack each triangle once.
    int packed = 0;
    const int half = LEAF / 2;
    for (int j = 0; j < cnt; ++j) {
      int t = border[lo + j];
      bool dup = false;
      for (int k = 0; k < packed; ++k)
        if (border[idx[k]] == t) { dup = true; break; }
      if (dup) continue;
      const float* r = recs + (size_t)t * 9;
      // SPLIT halfword order (accel/wide16.py PERM_H_POS / PERM_H8_POS):
      // slot s lives at halfword 2s (s<half) / 2(s-half)+1 — word w
      // carries slots (w, w+half) so the Pallas decode's lo/hi blocks
      // come out slot-ordered.
      const int hpos = packed < half ? 2 * packed : 2 * (packed - half) + 1;
      for (int c = 0; c < 9; ++c) {
        float v = r[c];
        if (c >= 6) v -= row[c - 6];
        halves[c][hpos] = f2h(v);
      }
      idx[packed] = lo + j;   // attr row = BVH-order position (host permutes)
      ++packed;
    }
    int32_t meta = packed;
    std::memcpy(row + 3, &meta, 4);
    // halves is laid out [9][W]; with LEAF==8 only the first 8 halfwords
    // of each comp are live — copy comp-by-comp at the packed stride.
    for (int c = 0; c < 9; ++c)
      std::memcpy(row + 4 + c * (LEAF / 2), halves[c], (size_t)LEAF * 2);
    std::memcpy(row + 4 + 9 * (LEAF / 2), idx, (size_t)LEAF * 4);
    return my;
  }

  int emit_inner_dp(int node, int depth) {
    int my = (int)(rows.size() / ROWF);
    new_row();
    std::vector<std::pair<int, int>> kids;   // (bvh2 node, kind 0=leaf 1=wide)
    dp->children(node, kids);
    int nk = (int)kids.size();
    std::sort(kids.begin(), kids.end(), [&](const auto& a, const auto& c) {
      return area(bnodes[a.first].lo, bnodes[a.first].hi) >
             area(bnodes[c.first].lo, bnodes[c.first].hi);
    });

    const Node2& nd = bnodes[node];
    float anchor[3] = {nd.lo.x, nd.lo.y, nd.lo.z};
    float ext[3] = {std::max(nd.hi.x - nd.lo.x, 0.f),
                    std::max(nd.hi.y - nd.lo.y, 0.f),
                    std::max(nd.hi.z - nd.lo.z, 0.f)};
    int e[3];
    float scale[3];
    for (int c = 0; c < 3; ++c) {
      float v = std::max(ext[c] / 255.0f, 1e-30f);
      e[c] = (int)std::ceil(std::log2((double)v));
      e[c] = std::min(std::max(e[c], -126), 127);
      scale[c] = std::ldexp(1.0f, e[c]);
      if (255.0f * scale[c] < ext[c]) {
        e[c] = std::min(e[c] + 1, 127);
        scale[c] = std::ldexp(1.0f, e[c]);
      }
    }
    uint8_t qlo[3][W], qhi[3][W];
    for (int c = 0; c < 3; ++c)
      for (int s = 0; s < W; ++s) { qlo[c][s] = 255; qhi[c][s] = 0; }
    for (int s = 0; s < nk; ++s) {
      const Node2& cn = bnodes[kids[s].first];
      float clo[3] = {cn.lo.x, cn.lo.y, cn.lo.z};
      float chi[3] = {cn.hi.x, cn.hi.y, cn.hi.z};
      for (int c = 0; c < 3; ++c) {
        float ql = std::floor((clo[c] - anchor[c]) / scale[c]);
        float qh = std::ceil((chi[c] - anchor[c]) / scale[c]);
        qlo[c][s] = (uint8_t)std::min(std::max(ql, 0.f), 255.f);
        qhi[c][s] = (uint8_t)std::min(std::max(qh, 0.f), 255.f);
      }
    }
    int32_t ptrs[W];
    for (int s = 0; s < W; ++s) {
      if (s >= nk) { ptrs[s] = -1; continue; }
      max_depth = std::max(max_depth, depth + 1);
      ptrs[s] = kids[s].second == 0 ? emit_leaf(kids[s].first)
                                    : emit_inner_dp(kids[s].first, depth + 1);
    }
    float* row = rows.data() + (size_t)my * ROWF;
    row[0] = anchor[0]; row[1] = anchor[1]; row[2] = anchor[2];
    int32_t meta = 0;
    std::memcpy(row + 3, &meta, 4);
    int32_t eword = (e[0] + 127) | ((e[1] + 127) << 8) | ((e[2] + 127) << 16);
    std::memcpy(row + 4, &eword, 4);
    uint8_t qbytes[96];
    for (int c = 0; c < 3; ++c)
      for (int s = 0; s < W; ++s) {
        const int qpos = 4 * (s % 4) + s / 4;
        qbytes[c * W + qpos] = qlo[c][s];
        qbytes[48 + c * W + qpos] = qhi[c][s];
      }
    std::memcpy(row + 8, qbytes, 96);
    std::memcpy(row + 32, ptrs, W * 4);
    return my;
  }

  int emit(int node, int depth) {
    max_depth = std::max(max_depth, depth);
    if (dp) {
      // SAH-optimal path: leaf/inner decided by the DP's i=1 decision.
      if (dp->dsingle[node] == 0) return emit_leaf(node);
      return emit_inner_dp(node, depth);
    }
    if (scount[node] <= LEAF) return emit_leaf(node);
    int my = (int)(rows.size() / ROWF);
    new_row();

    // Greedy SA collapse to <= 16 children; subtrees with <= LEAF tris
    // stay whole (one leaf row each).
    int kids[W];
    int nk = 0;
    const Node2& nd = bnodes[node];
    kids[nk++] = nd.left;
    kids[nk++] = nd.left + 1;
    while (nk < W) {
      int grow = -1;
      float best = -1.f;
      for (int i = 0; i < nk; ++i) {
        int k = kids[i];
        if (bnodes[k].count == 0 && scount[k] > LEAF) {
          float a = area(bnodes[k].lo, bnodes[k].hi);
          if (a > best) { best = a; grow = i; }
        }
      }
      if (grow < 0) break;
      int k = kids[grow];
      kids[grow] = bnodes[k].left;
      kids[nk++] = bnodes[k].left + 1;
    }
    std::sort(kids, kids + nk, [&](int a, int c) {
      return area(bnodes[a].lo, bnodes[a].hi) > area(bnodes[c].lo, bnodes[c].hi);
    });

    // Quantize: anchor = node lo, conservative power-of-two scales.
    float anchor[3] = {nd.lo.x, nd.lo.y, nd.lo.z};
    float ext[3] = {std::max(nd.hi.x - nd.lo.x, 0.f),
                    std::max(nd.hi.y - nd.lo.y, 0.f),
                    std::max(nd.hi.z - nd.lo.z, 0.f)};
    int e[3];
    float scale[3];
    for (int c = 0; c < 3; ++c) {
      float v = std::max(ext[c] / 255.0f, 1e-30f);
      e[c] = (int)std::ceil(std::log2((double)v));
      e[c] = std::min(std::max(e[c], -126), 127);
      scale[c] = std::ldexp(1.0f, e[c]);
      if (255.0f * scale[c] < ext[c]) {
        e[c] = std::min(e[c] + 1, 127);
        scale[c] = std::ldexp(1.0f, e[c]);
      }
    }
    uint8_t qlo[3][W], qhi[3][W];
    for (int c = 0; c < 3; ++c)
      for (int s = 0; s < W; ++s) { qlo[c][s] = 255; qhi[c][s] = 0; }
    for (int s = 0; s < nk; ++s) {
      const Node2& cn = bnodes[kids[s]];
      float clo[3] = {cn.lo.x, cn.lo.y, cn.lo.z};
      float chi[3] = {cn.hi.x, cn.hi.y, cn.hi.z};
      for (int c = 0; c < 3; ++c) {
        float ql = std::floor((clo[c] - anchor[c]) / scale[c]);
        float qh = std::ceil((chi[c] - anchor[c]) / scale[c]);
        qlo[c][s] = (uint8_t)std::min(std::max(ql, 0.f), 255.f);
        qhi[c][s] = (uint8_t)std::min(std::max(qh, 0.f), 255.f);
      }
    }

    // Children first gives ptrs; then write the row (rows may reallocate).
    int32_t ptrs[W];
    for (int s = 0; s < W; ++s)
      ptrs[s] = s < nk ? emit(kids[s], depth + 1) : -1;

    float* row = rows.data() + (size_t)my * ROWF;
    row[0] = anchor[0]; row[1] = anchor[1]; row[2] = anchor[2];
    int32_t meta = 0;
    std::memcpy(row + 3, &meta, 4);
    int32_t eword = (e[0] + 127) | ((e[1] + 127) << 8) | ((e[2] + 127) << 16);
    std::memcpy(row + 4, &eword, 4);
    uint8_t qbytes[96];
    // SPLIT byte order (accel/wide16.py PERM_Q): slot s at byte
    // 4*(s%4) + s/4 of its comp group — byte j of word w = slot 4j+w,
    // so the Pallas decode's whole-word shifts come out slot-ordered.
    for (int c = 0; c < 3; ++c)
      for (int s = 0; s < W; ++s) {
        const int qpos = 4 * (s % 4) + s / 4;
        qbytes[c * W + qpos] = qlo[c][s];
        qbytes[48 + c * W + qpos] = qhi[c][s];
      }
    std::memcpy(row + 8, qbytes, 96);
    std::memcpy(row + 32, ptrs, W * 4);
    return my;
  }
};

}  // namespace

// quality: 0 = binned SAH (Builder), 1 = SBVH spatial splits (SBVHBuilder).
// `out_order` receives the leaf reference list (original triangle ids,
// duplicates allowed under SBVH); its length is written to *out_refs and
// must fit order_capacity.
// quality bits: bit 0 = SBVH spatial splits (else binned SAH); bit 1 =
// SAH-optimal DP collapse (else greedy largest-area collapse).
static int build_wide16_impl(const float* positions, const float* tri_records,
                             int tri_count, int leaf_size, int quality,
                             int leaf_slots, float* out_rows,
                             int row_capacity, int32_t* out_depth,
                             int32_t* out_order, int order_capacity,
                             int32_t* out_refs) {
  if (tri_count <= 0 || leaf_size <= 0 || leaf_size > leaf_slots) return -1;
  std::vector<Node2> bnodes;
  std::vector<int> border;
  if (quality & 1) {
    SBVHBuilder sb{positions, tri_count, leaf_size};
    sb.build();
    bnodes = std::move(sb.nodes);
    border = std::move(sb.order);
  } else {
    Builder bld{positions, tri_count, leaf_size};
    bld.build();
    bnodes = std::move(bld.nodes);
    border = std::move(bld.order);
  }
  if ((int)border.size() > order_capacity) return -1;
  Wide16Emitter em{bnodes, border, tri_records};
  em.LEAF = leaf_slots;
  em.ROWF = leaf_slots == 8 ? 48 : 96;
  em.ranges();
  Collapse16DP dp{bnodes, em.scount, leaf_slots};
  if (quality & 2) {
    if (const char* e = std::getenv("UWPT_COLLAPSE_CNODE"))
      dp.c_node = (float)atof(e);
    dp.run();
    em.dp = &dp;
  }
  em.emit(0, 1);
  int n = (int)(em.rows.size() / em.ROWF);
  if (n > row_capacity) return -1;
  std::memcpy(out_rows, em.rows.data(), em.rows.size() * sizeof(float));
  if (out_depth) *out_depth = em.max_depth;
  if (out_order)
    std::memcpy(out_order, border.data(), border.size() * sizeof(int32_t));
  if (out_refs) *out_refs = (int)border.size();
  return n;
}

extern "C" int build_wide16_ex(const float* positions, const float* tri_records,
                               int tri_count, int leaf_size, int quality,
                               float* out_rows, int row_capacity,
                               int32_t* out_depth, int32_t* out_order,
                               int order_capacity, int32_t* out_refs) {
  return build_wide16_impl(positions, tri_records, tri_count, leaf_size,
                           quality, 16, out_rows, row_capacity, out_depth,
                           out_order, order_capacity, out_refs);
}

// leaf8 variant: 48-float rows, 8-triangle leaves (accel/wide16.py ROW8).
extern "C" int build_wide16l8_ex(const float* positions,
                                 const float* tri_records, int tri_count,
                                 int leaf_size, int quality, float* out_rows,
                                 int row_capacity, int32_t* out_depth,
                                 int32_t* out_order, int order_capacity,
                                 int32_t* out_refs) {
  return build_wide16_impl(positions, tri_records, tri_count, leaf_size,
                           quality, 8, out_rows, row_capacity, out_depth,
                           out_order, order_capacity, out_refs);
}

extern "C" int build_wide16(const float* positions, const float* tri_records,
                            int tri_count, int leaf_size, float* out_rows,
                            int row_capacity, int32_t* out_depth,
                            int32_t* out_order) {
  return build_wide16_ex(positions, tri_records, tri_count, leaf_size, 0,
                         out_rows, row_capacity, out_depth, out_order,
                         tri_count, nullptr);
}

extern "C" void f2h_batch(const float* in, uint16_t* out, int n) {
  // Test hook: exposes the builder's canonical f32->f16 conversion so the
  // numpy fallback (accel/wide16._canon_f16 after np.float16 RNE) can be
  // property-tested bit-identical against it — the two implementations
  // MUST agree forever or the Pallas fast decode's table contract breaks
  // silently (tests/test_native.py::test_f2h_parity_*).
  for (int i = 0; i < n; ++i) out[i] = f2h(in[i]);
}
