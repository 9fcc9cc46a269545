// Median-split BVH build on the host, for render/bvh.py.
//
// The port's own copy of the JAX package's native builder
// (native/mesh_ops.cpp `bvh_build`), built with g++ at first use by
// cuda_build.py and called through ctypes.  Its output must equal that
// builder's array for array: DFS pre-order nodes, split axis = first axis of
// max centroid extent, split point = count/2 by centroid order (ties broken
// by triangle index, so the median SET is unique), leaves of <= leaf_size
// triangles, miss links = next sibling of the nearest ancestor (root miss =
// node count).  Inner node i's children are i+1 and node_miss[i+1].
//
// lo/hi/cent: (T, 3) float64.  node_* arrays have capacity node_cap;
// perm_out (T,) int64 receives the leaf-order triangle permutation.
// Returns the node count, or -1 if node_cap would overflow.

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

struct BvhBuilder {
    const double *lo, *hi, *cent;
    int32_t leaf_size;
    int64_t node_cap;
    float *node_min, *node_max;
    int32_t *node_first, *node_count;
    int64_t *idx;
    std::vector<int64_t> subtree;  // per-node subtree size (for miss links)
    int64_t n_nodes = 0;
    bool overflow = false;

    // Builds [b, e) of idx; returns this subtree's node count.
    int64_t build(int64_t b, int64_t e) {
        if (n_nodes >= node_cap) {
            overflow = true;
            return 0;
        }
        const int64_t my = n_nodes++;
        subtree.push_back(0);
        double bb_lo[3] = {1e300, 1e300, 1e300};
        double bb_hi[3] = {-1e300, -1e300, -1e300};
        double c_lo[3] = {1e300, 1e300, 1e300};
        double c_hi[3] = {-1e300, -1e300, -1e300};
        for (int64_t i = b; i < e; ++i) {
            const int64_t t = idx[i];
            for (int k = 0; k < 3; ++k) {
                const double l = lo[t * 3 + k], h = hi[t * 3 + k];
                if (l < bb_lo[k]) bb_lo[k] = l;
                if (h > bb_hi[k]) bb_hi[k] = h;
                const double c = cent[t * 3 + k];
                if (c < c_lo[k]) c_lo[k] = c;
                if (c > c_hi[k]) c_hi[k] = c;
            }
        }
        for (int k = 0; k < 3; ++k) {
            node_min[my * 3 + k] = (float)bb_lo[k];
            node_max[my * 3 + k] = (float)bb_hi[k];
        }
        const int64_t count = e - b;
        if (count <= leaf_size) {
            node_first[my] = (int32_t)b;  // leaves fill idx left to right
            node_count[my] = (int32_t)count;
            subtree[my] = 1;
            return 1;
        }
        node_first[my] = -1;
        node_count[my] = 0;
        int axis = 0;
        double best = c_hi[0] - c_lo[0];
        for (int k = 1; k < 3; ++k) {  // strict >: first max, like np.argmax
            const double ext = c_hi[k] - c_lo[k];
            if (ext > best) { best = ext; axis = k; }
        }
        const double* cv = cent;
        std::nth_element(idx + b, idx + b + count / 2, idx + e,
                         [cv, axis](int64_t a, int64_t c) {
                             const double va = cv[a * 3 + axis];
                             const double vb = cv[c * 3 + axis];
                             return va < vb || (va == vb && a < c);
                         });
        const int64_t ls = build(b, b + count / 2);
        const int64_t rs = build(b + count / 2, e);
        subtree[my] = 1 + ls + rs;
        return subtree[my];
    }
};

}  // namespace

extern "C" int64_t bvh_build(const double* lo, const double* hi,
                             const double* cent, int64_t num_tris,
                             int32_t leaf_size, int64_t node_cap,
                             float* node_min, float* node_max,
                             int32_t* node_first, int32_t* node_count,
                             int32_t* node_miss, int64_t* perm_out) {
    if (num_tris <= 0 || leaf_size <= 0) return -1;
    for (int64_t i = 0; i < num_tris; ++i) perm_out[i] = i;
    BvhBuilder bld{lo, hi, cent, leaf_size, node_cap,
                   node_min, node_max, node_first, node_count, perm_out};
    bld.subtree.reserve((size_t)(2 * num_tris / leaf_size + 16));
    bld.build(0, num_tris);
    if (bld.overflow) return -1;
    const int64_t n = bld.n_nodes;
    std::vector<std::pair<int64_t, int64_t>> stack;
    stack.emplace_back(0, n);
    while (!stack.empty()) {
        const auto [i, m] = stack.back();
        stack.pop_back();
        node_miss[i] = (int32_t)m;
        if (node_count[i] == 0) {
            const int64_t left = i + 1;
            const int64_t right = left + bld.subtree[left];
            stack.emplace_back(left, right);
            stack.emplace_back(right, m);
        }
    }
    return n;
}
