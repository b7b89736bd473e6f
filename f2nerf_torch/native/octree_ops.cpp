// Native octree-maintenance engine + host data-loader primitives (a copy
// of f2nerf_tpu/native/octree_ops.cpp with the same C ABI).
//
// The reference keeps its tree maintenance in C++ (ProcOctree:
// compact / path-compress / subdivide, PersSampler.cpp:120-330; edge pool,
// PersSampler.cpp:614-659). Here the device consumes flat padded arrays, and
// this module performs the same structural rebuilds on host arrays. The
// numpy versions in sampler/octree.py (_proc_octree_np,
// _construct_edge_pool_np) are the plain versions the tests hold this
// against; the training path always runs this one (pointer-chasing loops
// are slow in Python once milestone subdivisions grow the tree to 100k+
// nodes).
//
// C ABI only (consumed via ctypes); struct-of-arrays layout matches the
// numpy side exactly.

#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>
#include <cmath>
#include <algorithm>

namespace {

struct Nodes {
  std::vector<float> center;   // [n*3]
  std::vector<float> side;     // [n]
  std::vector<int32_t> parent; // [n]
  std::vector<int32_t> childs; // [n*8]
  std::vector<uint8_t> leaf;   // [n]
  std::vector<int32_t> trans;  // [n]
  std::vector<int32_t> wstat, astat, visit;
  int n() const { return (int)side.size(); }
};

constexpr int kInitStat = 1000;  // INIT_NODE_STAT (PersSampler.h:10)

}  // namespace

extern "C" {

// Compact dead leaves, path-compress single-child chains, optionally
// subdivide visited valid leaves 8-ways. Returns the new node count, or -1
// if it would exceed max_out. Output arrays must hold max_out nodes.
int f2_proc_octree(
    int n_nodes,
    const float* center, const float* side, const int32_t* parent,
    const int32_t* childs, const uint8_t* is_leaf, const int32_t* trans_idx,
    const int32_t* wstat, const int32_t* astat, const int32_t* visit,
    int do_compact, int do_subdivide, int brute_force, int max_out,
    float* o_center, float* o_side, int32_t* o_parent, int32_t* o_childs,
    uint8_t* o_leaf, int32_t* o_trans, int32_t* o_wstat, int32_t* o_astat) {
  Nodes w;
  w.center.assign(center, center + 3 * n_nodes);
  w.side.assign(side, side + n_nodes);
  w.parent.assign(parent, parent + n_nodes);
  w.childs.assign(childs, childs + 8 * n_nodes);
  w.leaf.assign(is_leaf, is_leaf + n_nodes);
  w.trans.assign(trans_idx, trans_idx + n_nodes);
  w.wstat.assign(wstat, wstat + n_nodes);
  w.astat.assign(astat, astat + n_nodes);
  w.visit.assign(visit, visit + n_nodes);

  if (do_compact) {
    // detach invalid leaves; cascade childless nodes into leaves (fixpoint)
    while (true) {
      for (int u = 0; u < n_nodes; u++) {
        if (w.leaf[u] && w.trans[u] < 0 && w.parent[u] >= 0) {
          int v = w.parent[u];
          for (int st = 0; st < 8; st++)
            if (w.childs[v * 8 + st] == u) w.childs[v * 8 + st] = -1;
        }
      }
      bool changed = false;
      for (int u = 1; u < n_nodes; u++) {
        bool any = false;
        for (int st = 0; st < 8; st++) any |= w.childs[u * 8 + st] >= 0;
        if (!any) {
          if (!w.leaf[u]) changed = true;
          w.leaf[u] = 1;
        }
      }
      if (!changed) break;
    }
    // path compression
    auto single_child = [&](int v) -> int {
      int cnt = 0, ret = -1;
      for (int st = 0; st < 8; st++)
        if (w.childs[v * 8 + st] >= 0) { ret = w.childs[v * 8 + st]; cnt++; }
      return cnt == 1 ? ret : -1;
    };
    for (int u = 0; u < n_nodes; u++) {
      if (w.leaf[u] && w.trans[u] < 0) continue;
      int v = w.parent[u];
      while (v >= 0 && w.parent[v] >= 0 && single_child(v) >= 0) {
        int vv = w.parent[v];
        for (int st = 0; st < 8; st++)
          if (w.childs[vv * 8 + st] == v) w.childs[vv * 8 + st] = u;
        w.parent[u] = vv;
        w.trans[v] = -1;
        w.leaf[v] = 1;  // removal flag
        v = vv;
      }
    }
  }

  // renumber kept nodes (internal or valid leaf); root always kept
  std::vector<int> new_idx(n_nodes, -1);
  std::vector<int> order;
  for (int u = 0; u < n_nodes; u++) {
    bool keep = (u == 0) || !w.leaf[u] || w.trans[u] >= 0;
    if (keep) { new_idx[u] = (int)order.size(); order.push_back(u); }
  }

  Nodes c;
  int nc = (int)order.size();
  c.center.resize(3 * nc); c.side.resize(nc); c.parent.resize(nc);
  c.childs.resize(8 * nc); c.leaf.resize(nc); c.trans.resize(nc);
  c.wstat.resize(nc); c.astat.resize(nc); c.visit.resize(nc);
  for (int i = 0; i < nc; i++) {
    int u = order[i];
    std::memcpy(&c.center[3 * i], &w.center[3 * u], 12);
    c.side[i] = w.side[u];
    c.parent[i] = w.parent[u] >= 0 ? new_idx[w.parent[u]] : -1;
    for (int st = 0; st < 8; st++) {
      int ch = w.childs[u * 8 + st];
      c.childs[i * 8 + st] = ch >= 0 ? new_idx[ch] : -1;
    }
    c.leaf[i] = w.leaf[u];
    c.trans[i] = w.trans[u];
    c.wstat[i] = w.wstat[u];
    c.astat[i] = w.astat[u];
    c.visit[i] = w.visit[u];
  }

  Nodes out;
  if (do_subdivide) {
    // iterative DFS re-pack, splitting visited valid leaves 8-ways
    auto emit = [&out](const Nodes& src, int u, int pa) -> int {
      int id = out.n();
      out.center.insert(out.center.end(), &src.center[3 * u], &src.center[3 * u] + 3);
      out.side.push_back(src.side[u]);
      out.parent.push_back(pa);
      out.childs.insert(out.childs.end(), &src.childs[8 * u], &src.childs[8 * u] + 8);
      out.leaf.push_back(src.leaf[u]);
      out.trans.push_back(src.trans[u]);
      out.wstat.push_back(src.wstat[u]);
      out.astat.push_back(src.astat[u]);
      return id;
    };
    // stack of (old node, new parent, slot in parent)
    struct Item { int u, pa, slot; };
    std::vector<Item> stack{{0, -1, -1}};
    while (!stack.empty()) {
      Item it = stack.back(); stack.pop_back();
      int nu = emit(c, it.u, it.pa);
      if (it.pa >= 0 && it.slot >= 0) out.childs[it.pa * 8 + it.slot] = nu;
      if (c.leaf[it.u]) {
        if (!brute_force && c.visit[it.u] <= 4) continue;
        for (int st = 0; st < 8; st++) {
          float off[3] = {((st >> 2) & 1) - 0.5f, ((st >> 1) & 1) - 0.5f,
                          (st & 1) - 0.5f};
          int v = out.n();
          for (int k = 0; k < 3; k++)
            out.center.push_back(out.center[3 * nu + k] + out.side[nu] * 0.5f * off[k]);
          out.side.push_back(out.side[nu] * 0.5f);
          out.parent.push_back(nu);
          for (int k = 0; k < 8; k++) out.childs.push_back(-1);
          out.leaf.push_back(1);
          out.trans.push_back(out.trans[nu]);
          out.wstat.push_back(out.wstat[nu]);
          out.astat.push_back(out.astat[nu]);
          out.childs[nu * 8 + st] = v;
        }
        out.leaf[nu] = 0;
        out.trans[nu] = -1;
        out.wstat[nu] = kInitStat;
        out.astat[nu] = kInitStat;
      } else {
        // push children in reverse so they pop in order; record their slots
        for (int st = 7; st >= 0; st--) {
          int ch = out.childs[nu * 8 + st];
          if (ch >= 0) stack.push_back({ch, nu, st});
        }
      }
    }
  } else {
    out = std::move(c);
  }

  if (out.n() > max_out) return -1;
  int n = out.n();
  std::memcpy(o_center, out.center.data(), 12 * n);
  std::memcpy(o_side, out.side.data(), 4 * n);
  std::memcpy(o_parent, out.parent.data(), 4 * n);
  std::memcpy(o_childs, out.childs.data(), 32 * n);
  std::memcpy(o_leaf, out.leaf.data(), n);
  std::memcpy(o_trans, out.trans.data(), 4 * n);
  std::memcpy(o_wstat, out.wstat.data(), 4 * n);
  std::memcpy(o_astat, out.astat.data(), 4 * n);
  return n;
}

// Leaf-face adjacency pool (ConstructEdgePool, PersSampler.cpp:614-659).
// Returns edge count or -1 on overflow.
long f2_edge_pool(int n_nodes, const float* center, const float* side,
                  const int32_t* trans_idx, long max_edges,
                  int32_t* e_t, float* e_center, float* e_dir0, float* e_dir1) {
  std::vector<int> valid;
  for (int i = 0; i < n_nodes; i++)
    if (trans_idx[i] >= 0) valid.push_back(i);
  long cnt = 0;
  auto inside = [&](int v, const float* pt) {
    float m = 0.f;
    for (int k = 0; k < 3; k++)
      m = std::max(m, std::fabs((pt[k] - center[3 * v + k]) / side[v] * 2.f));
    return m < 1.f + 1e-4f;
  };
  static const int axes[6][3] = {{0, 1, 2}, {0, 1, 2}, {1, 0, 2},
                                 {1, 0, 2}, {2, 0, 1}, {2, 0, 1}};
  static const float sgn[6] = {1, -1, 1, -1, 1, -1};
  for (size_t ai = 0; ai < valid.size(); ai++) {
    int a = valid[ai];
    for (size_t bi = ai + 1; bi < valid.size(); bi++) {
      int b = valid[bi];
      int u = a, v = b;
      if (side[u] > side[v]) std::swap(u, v);
      float len_u = side[u] * 0.5f;
      for (int f = 0; f < 6; f++) {
        float pt[3] = {center[3 * u], center[3 * u + 1], center[3 * u + 2]};
        pt[axes[f][0]] += sgn[f] * len_u;
        if (!inside(v, pt)) continue;
        if (cnt >= max_edges) return -1;
        e_t[2 * cnt] = trans_idx[a];
        e_t[2 * cnt + 1] = trans_idx[b];
        std::memcpy(&e_center[3 * cnt], pt, 12);
        float d0[3] = {0, 0, 0}, d1[3] = {0, 0, 0};
        d0[axes[f][1]] = len_u;
        d1[axes[f][2]] = len_u;
        std::memcpy(&e_dir0[3 * cnt], d0, 12);
        std::memcpy(&e_dir1[3 * cnt], d1, 12);
        cnt++;
      }
    }
  }
  return cnt;
}

// Multithreaded training-pixel gather: images [n, h, w, 3] uint8 ->
// gt [k, 3] float in [0,1] for (img, y, x) index triples. This is the host
// data-loader path (dataset.data_at_gpu=false; reference keeps images on
// GPU and gathers there, Dataset.cpp:275-298).
void f2_sample_pixels(const uint8_t* images, long h, long w,
                      const int32_t* img_idx, const int32_t* ys,
                      const int32_t* xs, long k, float* out) {
  int n_threads = std::min<long>(std::thread::hardware_concurrency(), 16);
  n_threads = std::max(n_threads, 1);
  auto work = [&](long lo, long hi) {
    for (long i = lo; i < hi; i++) {
      const uint8_t* p = images + ((long)img_idx[i] * h * w +
                                   (long)ys[i] * w + xs[i]) * 3;
      out[3 * i] = p[0] / 255.f;
      out[3 * i + 1] = p[1] / 255.f;
      out[3 * i + 2] = p[2] / 255.f;
    }
  };
  std::vector<std::thread> ts;
  long chunk = (k + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++)
    ts.emplace_back(work, t * chunk, std::min(k, (t + 1) * chunk));
  for (auto& t : ts) t.join();
}

}  // extern "C"
