// gpis_index.cpp — native spatial runtime for gpismap.
//
// Array-pool adaptive 2^D-tree (D = 2 or 3) that reproduces the observable
// semantics of the reference's pointer-based QuadTree/OcTree
// (reference: cpp/src/quadtree.cpp, cpp/src/octree.cpp):
//   * one node per leaf; subdivision forced above the cluster level
//   * min-resolution duplicate rejection (sqdist < min_halfleng^2 within the
//     occupied leaf; quadtree.cpp:194-196) and the tree-wide IsNotNew test
//     (quadtree.cpp:325-348)
//   * upward root growth by box doubling until max_halfleng
//     (quadtree.cpp:122-155)
//   * empty-subtree pruning on removal with active-set erasure
//     (quadtree.cpp:392-436)
//   * ball-shaped QueryRange (quadtree.cpp:573-595) and cluster-level
//     QueryNonEmptyLevelC (quadtree.cpp:615-671)
//
// Differences (documented, deliberate):
//   * index pools + iterative/recursive-on-int implementation instead of
//     raw pointers and shared_ptr
//   * points exactly on a cell boundary tie to the >= side (the reference's
//     strict inequalities make such points un-insertable; quadtree.h:93-98)
//   * cluster-level cells carry a stable "slot" id used by the device-side
//     GP state arrays
//
// Built as a shared library; consumed via ctypes (see
// gpismap/runtime/index.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <unordered_set>
#include <vector>

namespace {

constexpr float kRemoveEps = 1e-12f;  // node match tolerance (quadtree.cpp:22)

struct Cell {
  float c[3];
  float half;
  int parent;
  int child0;   // first of 2^D contiguous children, -1 if leaf
  int node;     // node id or -1
  int count;    // nodes in subtree
  int slot;     // cluster slot id (cluster-level cells only) or -1
};

struct Tree {
  int dim = 2;
  int nch = 4;
  float min_half = 0.2f, max_half = 102.4f, root_half = 12.8f,
        cluster_half = 0.8f;
  float min_half_sq = 0.04f;
  float cluster_eps = 1e-3f;

  std::vector<Cell> cells;
  std::vector<int> free_cells;
  int root = -1;

  // node pool (authoritative node store)
  std::vector<float> pos;       // [cap * dim]
  std::vector<float> grad;      // [cap * dim]
  std::vector<float> val, pos_sig, grad_sig;
  std::vector<uint8_t> alive;
  std::vector<int> node_cell;
  std::vector<int> free_nodes;
  int n_alive = 0;

  std::unordered_set<int> active;   // touched cluster cells (this frame)
  std::vector<int> free_slots;
  int next_slot = 0;
  int max_slots = 1 << 20;
  long long overflow_support = 0;   // support truncation counter

  bool at_cluster(int ci) const {
    return std::fabs(cells[ci].half - cluster_half) < cluster_eps;
  }
  bool is_leaf(int ci) const { return cells[ci].child0 < 0; }
  bool empty_leaf(int ci) const {
    return is_leaf(ci) && cells[ci].node < 0;
  }
  // Reference child visitation order (NW,NE,SW,SE / NWF..SEB; quadtree.cpp
  // :589-592, octree.cpp) maps to bit-order children via XOR with
  // (nch - 2): processing order is observable through re-evaluation
  // sequencing, so traversals must match it.
  int visit_child(int ci, int j) const {
    return child(ci, j ^ (nch - 2));
  }

  bool contains(int ci, const float* p) const {
    const Cell& c = cells[ci];
    for (int a = 0; a < dim; ++a) {
      if (p[a] < c.c[a] - c.half || p[a] >= c.c[a] + c.half) return false;
    }
    return true;
  }
  bool intersects(int ci, const float* bc, float bh) const {
    const Cell& c = cells[ci];
    for (int a = 0; a < dim; ++a) {
      if (bc[a] + bh < c.c[a] - c.half) return false;
      if (bc[a] - bh > c.c[a] + c.half) return false;
    }
    return true;
  }
  float sqd(const float* a, const float* b) const {
    float s = 0;
    for (int k = 0; k < dim; ++k) {
      float d = a[k] - b[k];
      s += d * d;
    }
    return s;
  }
  const float* npos(int nid) const { return &pos[(size_t)nid * dim]; }

  int alloc_cell(const float* center, float half, int parent) {
    int ci;
    if (!free_cells.empty()) {
      ci = free_cells.back();
      free_cells.pop_back();
    } else {
      ci = (int)cells.size();
      cells.push_back(Cell());
    }
    Cell& c = cells[ci];
    std::memset(c.c, 0, sizeof(c.c));
    for (int a = 0; a < dim; ++a) c.c[a] = center[a];
    c.half = half;
    c.parent = parent;
    c.child0 = -1;
    c.node = -1;
    c.count = 0;
    c.slot = -1;
    if (std::fabs(half - cluster_half) < cluster_eps) {
      if (!free_slots.empty()) {
        c.slot = free_slots.back();
        free_slots.pop_back();
      } else if (next_slot < max_slots) {
        c.slot = next_slot++;
      }
    }
    return ci;
  }

  void free_cell(int ci) {
    active.erase(ci);
    if (cells[ci].slot >= 0) {
      free_slots.push_back(cells[ci].slot);
      cells[ci].slot = -1;
    }
    free_cells.push_back(ci);
  }

  void subdivide(int ci) {
    // child k: offsets by bits of k over axes (axis a sign = bit a of k);
    // copy the parent's geometry first — alloc_cell may reallocate `cells`
    float l = cells[ci].half * 0.5f;
    float pc[3];
    for (int a = 0; a < dim; ++a) pc[a] = cells[ci].c[a];
    for (int k = 0; k < nch; ++k) {
      float cc[3];
      for (int a = 0; a < dim; ++a) {
        float s = (k >> a) & 1 ? 1.0f : -1.0f;
        cc[a] = pc[a] + s * l;
      }
      child_ids_scratch[k] = alloc_cell(cc, l, ci);
    }
    cells[ci].child0 = child_table_store(ci);
  }

  // Children are stored in a side table so free-list reuse never breaks
  // contiguity assumptions.
  std::vector<int> child_table;           // groups of nch ids
  std::vector<int> free_child_groups;
  int child_ids_scratch[8];

  int child_table_store(int /*ci*/) {
    int g;
    if (!free_child_groups.empty()) {
      g = free_child_groups.back();
      free_child_groups.pop_back();
    } else {
      g = (int)child_table.size() / 8;
      child_table.resize(child_table.size() + 8, -1);
    }
    for (int k = 0; k < nch; ++k) child_table[g * 8 + k] = child_ids_scratch[k];
    return g;
  }
  int child(int ci, int k) const {
    return child_table[(size_t)cells[ci].child0 * 8 + k];
  }
  void drop_children(int ci) {
    int g = cells[ci].child0;
    for (int k = 0; k < nch; ++k) {
      free_cell(child_table[g * 8 + k]);
      child_table[g * 8 + k] = -1;
    }
    free_child_groups.push_back(g);
    cells[ci].child0 = -1;
  }

  // ---- node pool ----
  int alloc_node(const float* p) {
    int nid;
    if (!free_nodes.empty()) {
      nid = free_nodes.back();
      free_nodes.pop_back();
    } else {
      nid = (int)alive.size();
      alive.push_back(0);
      node_cell.push_back(-1);
      val.push_back(0);
      pos_sig.push_back(0);
      grad_sig.push_back(0);
      pos.resize(pos.size() + dim, 0.f);
      grad.resize(grad.size() + dim, 0.f);
    }
    for (int a = 0; a < dim; ++a) pos[(size_t)nid * dim + a] = p[a];
    for (int a = 0; a < dim; ++a) grad[(size_t)nid * dim + a] = 0.f;
    val[nid] = 0;
    pos_sig[nid] = 0;
    grad_sig[nid] = 0;
    alive[nid] = 1;
    node_cell[nid] = -1;
    ++n_alive;
    return nid;
  }
  void free_node(int nid) {
    alive[nid] = 0;
    node_cell[nid] = -1;
    free_nodes.push_back(nid);
    --n_alive;
  }

  // ---- reference-parity operations ----

  bool is_not_new(const float* p) const {
    // quadtree.cpp:325-348: walk the one leaf path containing p, true if a
    // stored node lies within min_halfleng.
    if (root < 0) return false;
    int ci = root;
    while (ci >= 0) {
      if (!contains(ci, p)) return false;
      if (cells[ci].node >= 0 &&
          sqd(npos(cells[ci].node), p) < min_half_sq) {
        return true;
      }
      if (is_leaf(ci)) return false;
      int next = -1;
      for (int k = 0; k < nch; ++k) {
        int ch = child(ci, k);
        if (contains(ch, p)) {
          next = ch;
          break;
        }
      }
      ci = next;
    }
    return false;
  }

  void grow_root(const float* p) {
    // quadtree.cpp:122-155: create a parent box of twice the size placed so
    // the current root is the child nearest the out-of-bounds point.
    const Cell rc = cells[root];
    float l = rc.half;
    float pc[3];
    int old_k = 0;
    for (int a = 0; a < dim; ++a) {
      bool up = p[a] >= rc.c[a];
      pc[a] = rc.c[a] + (up ? l : -l);
      // old root sits opposite the growth direction
      if (!up) old_k |= (1 << a);
    }
    int parent = alloc_cell(pc, 2.f * l, -1);
    // subdivide parent, then splice the old root in place of child old_k
    float hl = l;
    for (int k = 0; k < nch; ++k) {
      if (k == old_k) {
        child_ids_scratch[k] = root;
        continue;
      }
      float cc[3];
      for (int a = 0; a < dim; ++a) {
        float s = (k >> a) & 1 ? 1.0f : -1.0f;
        cc[a] = pc[a] + s * hl;
      }
      child_ids_scratch[k] = alloc_cell(cc, hl, parent);
    }
    cells[parent].child0 = child_table_store(parent);
    cells[root].parent = parent;
    cells[parent].count = cells[root].count;
    root = parent;
  }

  void mark_active_if_cluster(int ci) {
    if (at_cluster(ci)) active.insert(ci);
  }

  bool insert_rec(int ci, int nid) {
    const float* p = npos(nid);
    if (!contains(ci, p)) return false;

    if (cells[ci].half < min_half) {  // maxDepthReached (quadtree.cpp:60-61)
      if (cells[ci].node < 0) {
        cells[ci].node = nid;
        cells[ci].count = 1;
        node_cell[nid] = ci;
        mark_active_if_cluster(ci);
        return true;
      }
      return false;
    }

    if (is_leaf(ci)) {
      if (cells[ci].half > cluster_half) {
        subdivide(ci);
      } else {
        if (cells[ci].node < 0) {
          cells[ci].node = nid;
          cells[ci].count = 1;
          node_cell[nid] = ci;
          mark_active_if_cluster(ci);
          return true;
        }
        if (sqd(npos(cells[ci].node), p) < min_half_sq) return false;
        int old = cells[ci].node;
        subdivide(ci);
        cells[ci].node = -1;
        for (int k = 0; k < nch; ++k) {
          if (insert_rec(visit_child(ci, k), old)) break;
        }
      }
    }

    for (int k = 0; k < nch; ++k) {
      if (insert_rec(visit_child(ci, k), nid)) {
        mark_active_if_cluster(ci);
        // recompute subtree count (quadtree.cpp:314-323)
        int cnt = 0;
        for (int j = 0; j < nch; ++j) cnt += cells[child(ci, j)].count;
        cells[ci].count = cnt;
        return true;
      }
    }
    return false;
  }

  // returns node id, or -2 (duplicate), -1 (failed)
  int try_insert(const float* p) {
    if (root < 0) {
      float origin[3] = {0.f, 0.f, 0.f};
      root = alloc_cell(origin, root_half, -1);
    }
    if (is_not_new(p)) return -2;
    // grow upward until the point is inside the root or growth is capped
    while (!contains(root, p)) {
      if (cells[root].half > max_half) return -1;  // rootLimitReached
      grow_root(p);
    }
    int nid = alloc_node(p);
    if (insert_rec(root, nid)) return nid;
    free_node(nid);
    return -1;
  }

  void prune_upward(int ci) {
    // quadtree.cpp:374-386: collapse any ancestor whose children are all
    // empty leaves
    while (ci >= 0) {
      if (!is_leaf(ci)) {
        bool all_empty = true;
        for (int k = 0; k < nch; ++k) {
          if (!empty_leaf(child(ci, k))) {
            all_empty = false;
            break;
          }
        }
        if (all_empty) drop_children(ci);
      }
      // refresh count
      if (!is_leaf(ci)) {
        int cnt = 0;
        for (int j = 0; j < nch; ++j) cnt += cells[child(ci, j)].count;
        cells[ci].count = cnt;
      } else {
        cells[ci].count = cells[ci].node >= 0 ? 1 : 0;
      }
      ci = cells[ci].parent;
    }
  }

  bool remove_node(int nid) {
    if (nid < 0 || nid >= (int)alive.size() || !alive[nid]) return false;
    int ci = node_cell[nid];
    if (ci >= 0) {
      cells[ci].node = -1;
      cells[ci].count = 0;
      prune_upward(cells[ci].parent);
    }
    free_node(nid);
    return true;
  }

  void query_range_ball(const float* bc, float bh,
                        std::vector<int>& out) const {
    // quadtree.cpp:573-595: AABB descent, ball test at the leaf
    if (root < 0) return;
    float bh2 = bh * bh;
    std::vector<int> stack{root};
    while (!stack.empty()) {
      int ci = stack.back();
      stack.pop_back();
      if (!intersects(ci, bc, bh) || empty_leaf(ci)) continue;
      if (is_leaf(ci)) {
        if (sqd(npos(cells[ci].node), bc) < bh2) out.push_back(cells[ci].node);
        continue;
      }
      for (int k = nch - 1; k >= 0; --k) stack.push_back(visit_child(ci, k));
    }
  }

  void query_cluster_cells(const float* bc, float bh, std::vector<int>& out,
                           std::vector<float>* sqdst) const {
    // quadtree.cpp:615-671
    if (root < 0) return;
    std::vector<int> stack{root};
    while (!stack.empty()) {
      int ci = stack.back();
      stack.pop_back();
      if (!intersects(ci, bc, bh) || empty_leaf(ci)) continue;
      if (cells[ci].half > cluster_half + cluster_eps) {
        if (is_leaf(ci)) continue;
        for (int k = nch - 1; k >= 0; --k) stack.push_back(visit_child(ci, k));
      } else {
        out.push_back(ci);
        if (sqdst) sqdst->push_back(sqd(cells[ci].c, bc));
      }
    }
  }

  void subtree_nodes(int ci, std::vector<int>& out) const {
    // getAllChildrenNonEmptyNodes (quadtree.cpp:597-613): DFS order
    if (ci < 0) return;
    std::vector<int> stack{ci};
    while (!stack.empty()) {
      int c = stack.back();
      stack.pop_back();
      if (empty_leaf(c)) continue;
      if (is_leaf(c)) {
        out.push_back(cells[c].node);
        continue;
      }
      for (int k = nch - 1; k >= 0; --k) stack.push_back(visit_child(c, k));
    }
  }

  void all_nodes(std::vector<int>& out) const {
    for (int i = 0; i < (int)alive.size(); ++i) {
      if (alive[i]) out.push_back(i);
    }
  }

  void all_cluster_cells(std::vector<int>& out) const {
    if (root < 0) return;
    std::vector<int> stack{root};
    while (!stack.empty()) {
      int ci = stack.back();
      stack.pop_back();
      if (empty_leaf(ci)) continue;
      if (cells[ci].half > cluster_half + cluster_eps) {
        if (is_leaf(ci)) continue;
        for (int k = nch - 1; k >= 0; --k) stack.push_back(visit_child(ci, k));
      } else {
        out.push_back(ci);
      }
    }
  }
};

}  // namespace

extern "C" {

void* gpis_index_create(int dim, float min_half, float max_half,
                        float root_half, float cluster_half,
                        float cluster_eps, int max_slots) {
  Tree* t = new Tree();
  t->dim = dim;
  t->nch = 1 << dim;
  t->min_half = min_half;
  t->min_half_sq = min_half * min_half;
  t->max_half = max_half;
  t->root_half = root_half;
  t->cluster_half = cluster_half;
  t->cluster_eps = cluster_eps;
  t->max_slots = max_slots;
  return t;
}

void gpis_index_destroy(void* h) { delete (Tree*)h; }

void gpis_index_reset(void* h) {
  Tree* t = (Tree*)h;
  int dim = t->dim, nch = t->nch;
  float a = t->min_half, b = t->max_half, c = t->root_half,
        d = t->cluster_half, e = t->cluster_eps;
  int ms = t->max_slots;
  *t = Tree();
  t->dim = dim;
  t->nch = nch;
  t->min_half = a;
  t->min_half_sq = a * a;
  t->max_half = b;
  t->root_half = c;
  t->cluster_half = d;
  t->cluster_eps = e;
  t->max_slots = ms;
}

// Batch insert: for each point, IsNotNew + Insert. out_ids[i] = node id,
// -2 duplicate, -1 failed.
void gpis_index_try_insert(void* h, const float* p, int n, int* out_ids) {
  Tree* t = (Tree*)h;
  for (int i = 0; i < n; ++i) out_ids[i] = t->try_insert(p + (size_t)i * t->dim);
}

void gpis_index_set_node_data(void* h, const int* ids, int n,
                              const float* val, const float* pos_sig,
                              const float* grad, const float* grad_sig) {
  Tree* t = (Tree*)h;
  for (int i = 0; i < n; ++i) {
    int nid = ids[i];
    if (nid < 0 || !t->alive[nid]) continue;
    t->val[nid] = val[i];
    t->pos_sig[nid] = pos_sig[i];
    t->grad_sig[nid] = grad_sig[i];
    for (int a = 0; a < t->dim; ++a) {
      t->grad[(size_t)nid * t->dim + a] = grad[(size_t)i * t->dim + a];
    }
  }
}

void gpis_index_update_noise(void* h, const int* ids, int n,
                             const float* pos_sig, const float* grad_sig) {
  Tree* t = (Tree*)h;
  for (int i = 0; i < n; ++i) {
    int nid = ids[i];
    if (nid < 0 || !t->alive[nid]) continue;
    t->pos_sig[nid] = pos_sig[i];
    t->grad_sig[nid] = grad_sig[i];
  }
}

void gpis_index_remove(void* h, const int* ids, int n) {
  Tree* t = (Tree*)h;
  for (int i = 0; i < n; ++i) t->remove_node(ids[i]);
}

int gpis_index_num_nodes(void* h) { return ((Tree*)h)->n_alive; }
int gpis_index_node_capacity(void* h) {
  return (int)((Tree*)h)->alive.size();
}

// Dump all alive nodes. Arrays sized by node_capacity; alive mask marks
// valid rows. Node ids are row indices (stable across frames until reuse).
void gpis_index_dump_nodes(void* h, float* pos, float* grad, float* val,
                           float* pos_sig, float* grad_sig,
                           uint8_t* alive_out) {
  Tree* t = (Tree*)h;
  size_t cap = t->alive.size();
  std::memcpy(pos, t->pos.data(), cap * t->dim * sizeof(float));
  std::memcpy(grad, t->grad.data(), cap * t->dim * sizeof(float));
  std::memcpy(val, t->val.data(), cap * sizeof(float));
  std::memcpy(pos_sig, t->pos_sig.data(), cap * sizeof(float));
  std::memcpy(grad_sig, t->grad_sig.data(), cap * sizeof(float));
  std::memcpy(alive_out, t->alive.data(), cap * sizeof(uint8_t));
}

// Gather node rows for an id list (invalid ids produce zero rows).
void gpis_index_get_nodes(void* h, const int* ids, int n, float* pos,
                          float* grad, float* val, float* pos_sig,
                          float* grad_sig, uint8_t* alive_out) {
  Tree* t = (Tree*)h;
  int d = t->dim;
  for (int i = 0; i < n; ++i) {
    int nid = ids[i];
    bool ok = nid >= 0 && nid < (int)t->alive.size() && t->alive[nid];
    alive_out[i] = ok ? 1 : 0;
    for (int a = 0; a < d; ++a) {
      pos[(size_t)i * d + a] = ok ? t->pos[(size_t)nid * d + a] : 0.f;
      grad[(size_t)i * d + a] = ok ? t->grad[(size_t)nid * d + a] : 0.f;
    }
    val[i] = ok ? t->val[nid] : 0.f;
    pos_sig[i] = ok ? t->pos_sig[nid] : 0.f;
    grad_sig[i] = ok ? t->grad_sig[nid] : 0.f;
  }
}

int gpis_index_query_range(void* h, const float* center, float half,
                           int* out, int cap) {
  Tree* t = (Tree*)h;
  std::vector<int> res;
  t->query_range_ball(center, half, res);
  int n = std::min((int)res.size(), cap);
  std::memcpy(out, res.data(), n * sizeof(int));
  return (int)res.size();
}

int gpis_index_query_cluster_cells(void* h, const float* center, float half,
                                   int* out_cells, float* out_sqdst,
                                   int cap) {
  Tree* t = (Tree*)h;
  std::vector<int> res;
  std::vector<float> dst;
  t->query_cluster_cells(center, half, res, &dst);
  int n = std::min((int)res.size(), cap);
  std::memcpy(out_cells, res.data(), n * sizeof(int));
  if (out_sqdst) std::memcpy(out_sqdst, dst.data(), n * sizeof(float));
  return (int)res.size();
}

int gpis_index_num_active(void* h) { return (int)((Tree*)h)->active.size(); }

int gpis_index_get_active(void* h, int* out, int cap) {
  Tree* t = (Tree*)h;
  int n = 0;
  for (int ci : t->active) {
    if (n >= cap) break;
    out[n++] = ci;
  }
  return (int)t->active.size();
}

void gpis_index_clear_active(void* h) { ((Tree*)h)->active.clear(); }

void gpis_index_cell_info(void* h, const int* cells, int n, float* centers,
                          float* halfs, int* slots) {
  Tree* t = (Tree*)h;
  for (int i = 0; i < n; ++i) {
    int ci = cells[i];
    for (int a = 0; a < t->dim; ++a) {
      centers[(size_t)i * t->dim + a] = t->cells[ci].c[a];
    }
    halfs[i] = t->cells[ci].half;
    slots[i] = t->cells[ci].slot;
  }
}

// All non-empty cluster-level cells (for the device-side dense grid).
int gpis_index_all_cluster_cells(void* h, int* out, int cap) {
  Tree* t = (Tree*)h;
  std::vector<int> res;
  t->all_cluster_cells(res);
  int n = std::min((int)res.size(), cap);
  std::memcpy(out, res.data(), n * sizeof(int));
  return (int)res.size();
}

// One-call retrain collection (reference: GPisMap.cpp:596-663):
//   update set = active  U  cluster cells intersecting
//                AABB(active cell center, rt * halfLength)
//   per cell: support = nodes within ball of radius rt * halfLength
// Outputs per cell: id, slot, center, support node ids padded with -1.
// Support overflowing `sup_cap` keeps the nodes nearest the cell center
// (the reference has no cap; overflow_support counts occurrences).
int gpis_index_collect_retrain(void* h, float rt, int sup_cap, int cell_cap,
                               int* out_cells, int* out_slots,
                               float* out_centers, int* out_support,
                               int* out_counts) {
  Tree* t = (Tree*)h;
  std::vector<int> update(t->active.begin(), t->active.end());
  std::unordered_set<int> seen(t->active.begin(), t->active.end());
  std::vector<int> qs;
  for (int ci : std::vector<int>(update)) {
    qs.clear();
    t->query_cluster_cells(t->cells[ci].c, rt * t->cells[ci].half, qs,
                           nullptr);
    for (int q : qs) {
      if (seen.insert(q).second) update.push_back(q);
    }
  }
  // deterministic order for reproducibility
  std::sort(update.begin(), update.end());
  int b = std::min((int)update.size(), cell_cap);
  std::vector<int> sup;
  std::vector<std::pair<float, int>> ranked;
  for (int i = 0; i < b; ++i) {
    int ci = update[i];
    out_cells[i] = ci;
    out_slots[i] = t->cells[ci].slot;
    for (int a = 0; a < t->dim; ++a) {
      out_centers[(size_t)i * t->dim + a] = t->cells[ci].c[a];
    }
    sup.clear();
    t->query_range_ball(t->cells[ci].c, rt * t->cells[ci].half, sup);
    int cnt = (int)sup.size();
    if (cnt > sup_cap) {
      ++t->overflow_support;
      ranked.clear();
      for (int nid : sup) {
        ranked.push_back({t->sqd(t->npos(nid), t->cells[ci].c), nid});
      }
      std::nth_element(ranked.begin(), ranked.begin() + sup_cap,
                       ranked.end());
      // keep DFS order among the kept subset
      std::unordered_set<int> keep;
      for (int k = 0; k < sup_cap; ++k) keep.insert(ranked[k].second);
      int w = 0;
      for (int nid : sup) {
        if (keep.count(nid)) sup[w++] = nid;
      }
      cnt = sup_cap;
    }
    out_counts[i] = cnt;
    for (int k = 0; k < sup_cap; ++k) {
      out_support[(size_t)i * sup_cap + k] = k < cnt ? sup[k] : -1;
    }
  }
  return (int)update.size();
}

// Apply re-evaluation outcomes in reference order (GPisMap.cpp:398-452):
// per node, interleaved: 1 = double noise in place, 2 = remove,
// 3 = remove then try re-insert at the fused position with the given data.
// out_newids[i] = new node id for action 3 (or -1).
void gpis_index_apply_reeval(void* h, const int* ids, int n,
                             const int* actions, const float* pos,
                             const float* grad, const float* noise,
                             const float* grad_noise, const float* dbl_ps,
                             const float* dbl_gs, float fused_val,
                             int* out_newids) {
  Tree* t = (Tree*)h;
  int d = t->dim;
  for (int i = 0; i < n; ++i) {
    int nid = ids[i];
    out_newids[i] = -1;
    if (nid < 0 || !t->alive[nid]) continue;
    int a = actions[i];
    if (a == 1) {
      t->pos_sig[nid] = dbl_ps[i];
      t->grad_sig[nid] = dbl_gs[i];
    } else if (a == 2 || a == 3) {
      t->remove_node(nid);
      if (a == 3) {
        int nn = t->try_insert(pos + (size_t)i * d);
        if (nn >= 0) {
          t->val[nn] = fused_val;
          t->pos_sig[nn] = noise[i];
          t->grad_sig[nn] = grad_noise[i];
          for (int ax = 0; ax < d; ++ax) {
            t->grad[(size_t)nn * d + ax] = grad[(size_t)i * d + ax];
          }
          out_newids[i] = nn;
        }
      }
    }
  }
}

// Nodes in a cell's subtree, DFS order (getAllChildrenNonEmptyNodes).
int gpis_index_cell_nodes(void* h, int cell, int* out, int cap) {
  Tree* t = (Tree*)h;
  std::vector<int> res;
  t->subtree_nodes(cell, res);
  int n = std::min((int)res.size(), cap);
  std::memcpy(out, res.data(), n * sizeof(int));
  return (int)res.size();
}

long long gpis_index_overflow_count(void* h) {
  return ((Tree*)h)->overflow_support;
}

}  // extern "C"

// ---- checkpoint serialization ----
// Byte stream: magic, version, params, then every pool verbatim. The tree
// is restored exactly (cell ids, node ids and slots survive), which the
// reference cannot do at all (its only lifecycle op is reset,
// mexGPisMap.cpp:123-130).

namespace {
constexpr uint64_t kMagic = 0x47504953544d4150ull;  // "GPISTMAP"
constexpr uint32_t kVersion = 1;

template <typename T>
void put_vec(std::vector<uint8_t>& out, const std::vector<T>& v) {
  uint64_t n = v.size();
  const uint8_t* p = (const uint8_t*)&n;
  out.insert(out.end(), p, p + 8);
  p = (const uint8_t*)v.data();
  out.insert(out.end(), p, p + n * sizeof(T));
}

template <typename T>
bool get_vec(const uint8_t*& p, const uint8_t* end, std::vector<T>& v) {
  if (end - p < 8) return false;
  uint64_t n;
  std::memcpy(&n, p, 8);
  p += 8;
  if ((uint64_t)(end - p) < n * sizeof(T)) return false;
  v.resize(n);
  std::memcpy(v.data(), p, n * sizeof(T));
  p += n * sizeof(T);
  return true;
}

std::vector<uint8_t> serialize_tree(const Tree& t) {
  std::vector<uint8_t> out;
  auto put = [&out](const void* p, size_t n) {
    out.insert(out.end(), (const uint8_t*)p, (const uint8_t*)p + n);
  };
  put(&kMagic, 8);
  put(&kVersion, 4);
  put(&t.dim, 4);
  put(&t.min_half, 4);
  put(&t.max_half, 4);
  put(&t.root_half, 4);
  put(&t.cluster_half, 4);
  put(&t.cluster_eps, 4);
  put(&t.root, 4);
  put(&t.n_alive, 4);
  put(&t.next_slot, 4);
  put(&t.max_slots, 4);
  put(&t.overflow_support, 8);
  put_vec(out, t.cells);
  put_vec(out, t.free_cells);
  put_vec(out, t.child_table);
  put_vec(out, t.free_child_groups);
  put_vec(out, t.pos);
  put_vec(out, t.grad);
  put_vec(out, t.val);
  put_vec(out, t.pos_sig);
  put_vec(out, t.grad_sig);
  put_vec(out, t.alive);
  put_vec(out, t.node_cell);
  put_vec(out, t.free_nodes);
  put_vec(out, t.free_slots);
  std::vector<int> act(t.active.begin(), t.active.end());
  put_vec(out, act);
  return out;
}

bool deserialize_tree(Tree& t, const uint8_t* p, size_t size) {
  const uint8_t* end = p + size;
  auto get = [&p, end](void* dst, size_t n) {
    if ((size_t)(end - p) < n) return false;
    std::memcpy(dst, p, n);
    p += n;
    return true;
  };
  uint64_t magic;
  uint32_t ver;
  if (!get(&magic, 8) || magic != kMagic) return false;
  if (!get(&ver, 4) || ver != kVersion) return false;
  if (!get(&t.dim, 4)) return false;
  t.nch = 1 << t.dim;
  if (!get(&t.min_half, 4) || !get(&t.max_half, 4)
      || !get(&t.root_half, 4) || !get(&t.cluster_half, 4)
      || !get(&t.cluster_eps, 4) || !get(&t.root, 4)
      || !get(&t.n_alive, 4) || !get(&t.next_slot, 4)
      || !get(&t.max_slots, 4) || !get(&t.overflow_support, 8)) {
    return false;
  }
  t.min_half_sq = t.min_half * t.min_half;
  std::vector<int> act;
  bool ok = get_vec(p, end, t.cells) && get_vec(p, end, t.free_cells)
      && get_vec(p, end, t.child_table)
      && get_vec(p, end, t.free_child_groups) && get_vec(p, end, t.pos)
      && get_vec(p, end, t.grad) && get_vec(p, end, t.val)
      && get_vec(p, end, t.pos_sig) && get_vec(p, end, t.grad_sig)
      && get_vec(p, end, t.alive) && get_vec(p, end, t.node_cell)
      && get_vec(p, end, t.free_nodes) && get_vec(p, end, t.free_slots)
      && get_vec(p, end, act);
  if (!ok) return false;
  t.active = std::unordered_set<int>(act.begin(), act.end());
  return true;
}

std::vector<uint8_t> g_ser_buf;
}  // namespace

extern "C" {

long long gpis_index_serialize_size(void* h) {
  g_ser_buf = serialize_tree(*(Tree*)h);
  return (long long)g_ser_buf.size();
}

void gpis_index_serialize(void* h, uint8_t* out) {
  if (g_ser_buf.empty()) g_ser_buf = serialize_tree(*(Tree*)h);
  std::memcpy(out, g_ser_buf.data(), g_ser_buf.size());
  g_ser_buf.clear();
  g_ser_buf.shrink_to_fit();
}

int gpis_index_deserialize(void* h, const uint8_t* buf, long long size) {
  return deserialize_tree(*(Tree*)h, buf, (size_t)size) ? 0 : 1;
}

int gpis_index_root_cell(void* h) { return ((Tree*)h)->root; }

float gpis_index_root_half(void* h) {
  Tree* t = (Tree*)h;
  return t->root < 0 ? 0.f : t->cells[t->root].half;
}

void gpis_index_root_center(void* h, float* out) {
  Tree* t = (Tree*)h;
  if (t->root < 0) return;
  for (int a = 0; a < t->dim; ++a) out[a] = t->cells[t->root].c[a];
}

int gpis_index_max_slot(void* h) { return ((Tree*)h)->next_slot; }

}  // extern "C"
