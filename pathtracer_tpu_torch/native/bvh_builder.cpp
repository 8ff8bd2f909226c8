// Native BVH builder — the C++ runtime component of the framework.
//
// Counterpart of TriMesh::build_bvh_recur (reference: TriangleMesh.cpp:
// 1029-1130): binary BVH, split axis = largest centroid extent, 16 candidate
// planes scored by area*count, stable partition, leaves <= max_leaf or failed
// splits.  Bit-compatible with the numpy builder in ops/bvh.py (same
// heuristic, same stable partition order) so the two are interchangeable;
// this one handles the multi-million-triangle configs at C++ speed.
//
// Build: g++ -O3 -march=native -shared -fPIC bvh_builder.cpp -o libbvh.so
// Loaded through ctypes (ops/bvh.py) — no pybind11 dependency.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BuildCtx {
  const float* lo;       // (n,3) per-primitive bounds
  const float* hi;
  const float* centers;  // (n,3)
  int n;
  int max_leaf;
  int n_split_tests;

  float* node_lo;
  float* node_hi;
  int32_t* node_a;
  int32_t* node_b;
  uint8_t* node_leaf;
  int32_t* order;

  int n_nodes = 0;
  int depth = 0;
  int max_leaf_seen = 0;
  std::vector<int32_t> scratch;
};

inline float area(const float lo[3], const float hi[3]) {
  float dx = std::max(0.f, hi[0] - lo[0]);
  float dy = std::max(0.f, hi[1] - lo[1]);
  float dz = std::max(0.f, hi[2] - lo[2]);
  return 2.f * (dx * dy + dx * dz + dy * dz);
}

int new_node(BuildCtx& c, int i0, int i1) {
  int idx = c.n_nodes++;
  float lo[3] = {1e30f, 1e30f, 1e30f};
  float hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = i0; i < i1; i++) {
    const int t = c.order[i];
    for (int k = 0; k < 3; k++) {
      lo[k] = std::min(lo[k], c.lo[t * 3 + k]);
      hi[k] = std::max(hi[k], c.hi[t * 3 + k]);
    }
  }
  std::memcpy(c.node_lo + idx * 3, lo, 12);
  std::memcpy(c.node_hi + idx * 3, hi, 12);
  c.node_a[idx] = i0;
  c.node_b[idx] = i1;
  c.node_leaf[idx] = 1;
  return idx;
}

void build_recur(BuildCtx& c, int node, int i0, int i1, int depth) {
  c.depth = std::max(c.depth, depth);

  // centroid bbox + split axis (largest extent, x-ties-win order,
  // TriangleMesh.cpp:1043-1055)
  float clo[3] = {1e30f, 1e30f, 1e30f};
  float chi[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = i0; i < i1; i++) {
    const float* cen = c.centers + c.order[i] * 3;
    for (int k = 0; k < 3; k++) {
      clo[k] = std::min(clo[k], cen[k]);
      chi[k] = std::max(chi[k], cen[k]);
    }
  }
  float diag[3] = {chi[0] - clo[0], chi[1] - clo[1], chi[2] - clo[2]};
  int axis;
  if (diag[0] >= diag[1] && diag[0] >= diag[2]) axis = 0;
  else if (diag[1] >= diag[0] && diag[1] >= diag[2]) axis = 1;
  else axis = 2;

  // score candidate planes by area*count (TriangleMesh.cpp:1066-1099)
  float best_score = 1e38f;
  float best_split = clo[axis] + diag[axis] * 0.5f;
  for (int s = 0; s < c.n_split_tests; s++) {
    const float frac = (s + 1) / (float)(c.n_split_tests + 1);
    const float split = clo[axis] + diag[axis] * frac;
    float llo[3] = {1e30f, 1e30f, 1e30f}, lhi[3] = {-1e30f, -1e30f, -1e30f};
    float rlo[3] = {1e30f, 1e30f, 1e30f}, rhi[3] = {-1e30f, -1e30f, -1e30f};
    int nl = 0, nr = 0;
    for (int i = i0; i < i1; i++) {
      const int t = c.order[i];
      const bool left = c.centers[t * 3 + axis] <= split;
      float* blo = left ? llo : rlo;
      float* bhi = left ? lhi : rhi;
      for (int k = 0; k < 3; k++) {
        blo[k] = std::min(blo[k], c.lo[t * 3 + k]);
        bhi[k] = std::max(bhi[k], c.hi[t * 3 + k]);
      }
      (left ? nl : nr)++;
    }
    const float score = (nl ? area(llo, lhi) * nl : 0.f)
                      + (nr ? area(rlo, rhi) * nr : 0.f);
    if (score < best_score) {
      best_score = score;
      best_split = split;
    }
  }

  // stable partition (matches the numpy builder's concatenate order)
  c.scratch.clear();
  int nl = 0;
  for (int i = i0; i < i1; i++)
    if (c.centers[c.order[i] * 3 + axis] <= best_split)
      c.scratch.push_back(c.order[i]);
  nl = (int)c.scratch.size();
  for (int i = i0; i < i1; i++)
    if (!(c.centers[c.order[i] * 3 + axis] <= best_split))
      c.scratch.push_back(c.order[i]);
  std::memcpy(c.order + i0, c.scratch.data(),
              sizeof(int32_t) * (i1 - i0));
  const int pivot = i0 + nl - 1;

  if (pivot < i0 || pivot >= i1 - 1 || i1 <= i0 + c.max_leaf) {
    c.max_leaf_seen = std::max(c.max_leaf_seen, i1 - i0);
    return;  // stays leaf
  }

  c.node_leaf[node] = 0;
  const int fg = new_node(c, i0, pivot + 1);
  c.node_a[node] = fg;
  build_recur(c, fg, i0, pivot + 1, depth + 1);
  const int fd = new_node(c, pivot + 1, i1);
  c.node_b[node] = fd;
  build_recur(c, fd, pivot + 1, i1, depth + 1);
}

}  // namespace

extern "C" int pt_build_bvh(const float* tri_lo, const float* tri_hi,
                            const float* centers, int n, int max_leaf,
                            int n_split_tests, float* node_lo, float* node_hi,
                            int32_t* node_a, int32_t* node_b,
                            uint8_t* node_leaf, int32_t* order,
                            int32_t* out_stats) {
  if (n <= 0) return -1;
  BuildCtx c;
  c.lo = tri_lo;
  c.hi = tri_hi;
  c.centers = centers;
  c.n = n;
  c.max_leaf = max_leaf;
  c.n_split_tests = n_split_tests;
  c.node_lo = node_lo;
  c.node_hi = node_hi;
  c.node_a = node_a;
  c.node_b = node_b;
  c.node_leaf = node_leaf;
  c.order = order;
  c.scratch.reserve(n);
  for (int i = 0; i < n; i++) order[i] = i;

  const int root = new_node(c, 0, n);
  build_recur(c, root, 0, n, 0);

  out_stats[0] = c.n_nodes;
  out_stats[1] = c.depth;
  out_stats[2] = c.max_leaf_seen ? c.max_leaf_seen : max_leaf;
  return 0;
}
