// Native BVH builder: binned SAH over triangles -> threaded (skip-link) flat
// layout, bit-matching the Python reference in gltf_renderer/ops/bvh.py.
//
// This is the framework's native "graph builder" analogue of the reference's
// D3D12 BLAS/TLAS build path (RayTracingAccelerationStructure.cpp): the
// traversal structure is produced on host and shipped to the device as
// flat arrays. C API, loaded via ctypes (no pybind11 in this environment).
//
// Layout invariants (see ops/bvh.py FlatBVH):
//   - DFS order, left child == parent + 1
//   - leaf: count > 0, first = slot offset into tri_order
//   - internal: count == 0, first = node + 1, right = right child
//   - skip: next node on AABB miss / after leaf; root subtree end == n_nodes

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kSahBins = 16;

struct Vec3 {
    float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
    Vec3 lo{std::numeric_limits<float>::infinity(),
            std::numeric_limits<float>::infinity(),
            std::numeric_limits<float>::infinity()};
    Vec3 hi{-std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity()};
    void grow(const Box& b) {
        lo = vmin(lo, b.lo);
        hi = vmax(hi, b.hi);
    }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    const Box* boxes;
    const Vec3* centroids;
    int32_t* order;
    int leaf_size;

    std::vector<float> n_min, n_max;
    std::vector<int32_t> n_first, n_count, n_right, n_level;

    int new_node(int level) {
        n_min.insert(n_min.end(), 3, 0.f);
        n_max.insert(n_max.end(), 3, 0.f);
        n_first.push_back(0);
        n_count.push_back(0);
        n_right.push_back(-1);
        n_level.push_back(level);
        return (int)n_first.size() - 1;
    }

    int build(int begin, int end, int level) {
        int node = new_node(level);
        Box bb;
        Box cb_box;
        for (int i = begin; i < end; i++) {
            bb.grow(boxes[order[i]]);
            const Vec3& c = centroids[order[i]];
            cb_box.lo = vmin(cb_box.lo, c);
            cb_box.hi = vmax(cb_box.hi, c);
        }
        std::memcpy(&n_min[node * 3], &bb.lo, 12);
        std::memcpy(&n_max[node * 3], &bb.hi, 12);
        int count = end - begin;
        if (count <= leaf_size) {
            n_first[node] = begin;
            n_count[node] = count;
            return node;
        }

        // Binned SAH over ALL 3 axes: fewer node visits than
        // largest-extent-only splits (tools/bvh_union_sim.py), and an
        // exhaustive sweep gained no more than the binned all-axes search.
        float ext[3] = {cb_box.hi.x - cb_box.lo.x, cb_box.hi.y - cb_box.lo.y,
                        cb_box.hi.z - cb_box.lo.z};
        int axis = 0;  // largest extent: the median-split fallback axis
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int best_axis = -1, best_bin = -1;
        float best_cost = std::numeric_limits<float>::infinity();
        float best_scale = 0.f, best_clo = 0.f;
        for (int ax = 0; ax < 3; ax++) {
            if (ext[ax] <= 1e-12f) continue;
            float c_lo = ax == 0 ? cb_box.lo.x : (ax == 1 ? cb_box.lo.y : cb_box.lo.z);
            float scale = kSahBins * (1.0f - 1e-6f) / ext[ax];
            Box bin_box[kSahBins];
            int bin_count[kSahBins] = {};
            auto bin_of = [&](int tri) {
                const Vec3& c = centroids[tri];
                float cv = ax == 0 ? c.x : (ax == 1 ? c.y : c.z);
                int b = (int)((cv - c_lo) * scale);
                return std::min(b, kSahBins - 1);
            };
            for (int i = begin; i < end; i++) {
                int b = bin_of(order[i]);
                bin_count[b]++;
                bin_box[b].grow(boxes[order[i]]);
            }
            // Sweep SAH.
            float l_area[kSahBins - 1], r_area[kSahBins - 1];
            int l_cnt[kSahBins - 1], r_cnt[kSahBins - 1];
            Box acc;
            int cnt = 0;
            for (int b = 0; b < kSahBins - 1; b++) {
                acc.grow(bin_box[b]);
                cnt += bin_count[b];
                l_area[b] = acc.area();
                l_cnt[b] = cnt;
            }
            acc = Box();
            cnt = 0;
            for (int b = kSahBins - 1; b >= 1; b--) {
                acc.grow(bin_box[b]);
                cnt += bin_count[b];
                r_area[b - 1] = acc.area();
                r_cnt[b - 1] = cnt;
            }
            for (int b = 0; b < kSahBins - 1; b++) {
                if (l_cnt[b] == 0 || r_cnt[b] == 0) continue;
                float cost = l_area[b] * l_cnt[b] + r_area[b] * r_cnt[b];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = ax;
                    best_bin = b;
                    best_scale = scale;
                    best_clo = c_lo;
                }
            }
        }
        int mid = -1;
        if (best_axis >= 0) {
            auto bin_of = [&](int tri) {
                const Vec3& c = centroids[tri];
                float cv = best_axis == 0 ? c.x : (best_axis == 1 ? c.y : c.z);
                int b = (int)((cv - best_clo) * best_scale);
                return std::min(b, kSahBins - 1);
            };
            // Stable partition (keeps Python-build-compatible ordering).
            std::stable_partition(order + begin, order + end,
                                  [&](int tri) { return bin_of(tri) <= best_bin; });
            int m = begin;
            while (m < end && bin_of(order[m]) <= best_bin) m++;
            mid = m;
        }
        if (mid <= begin || mid >= end) {
            // Median split on the axis (stable sort for determinism).
            mid = begin + count / 2;
            std::stable_sort(order + begin, order + end, [&](int a, int b) {
                const Vec3& ca = centroids[a];
                const Vec3& cb = centroids[b];
                float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                float vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
                return va < vb;
            });
        }

        build(begin, mid, level + 1);
        int right = build(mid, end, level + 1);
        n_first[node] = node + 1;
        n_right[node] = right;
        return node;
    }
};

}  // namespace

extern "C" {

// Returns the node count. Output arrays must have capacity for 2*T nodes
// (aabb_* 3 floats per node). tri_order length T (filled with permutation).
int bvh_build(const float* v0, const float* v1, const float* v2, int t,
              int leaf_size, float* aabb_min, float* aabb_max, int32_t* first,
              int32_t* count, int32_t* skip, int32_t* right, int32_t* levels,
              int32_t* tri_order) {
    if (t <= 0) return 0;
    std::vector<Box> boxes(t);
    std::vector<Vec3> centroids(t);
    for (int i = 0; i < t; i++) {
        Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
        Vec3 b{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
        Vec3 c{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
        boxes[i].lo = vmin(vmin(a, b), c);
        boxes[i].hi = vmax(vmax(a, b), c);
        centroids[i] = {0.5f * (boxes[i].lo.x + boxes[i].hi.x),
                        0.5f * (boxes[i].lo.y + boxes[i].hi.y),
                        0.5f * (boxes[i].lo.z + boxes[i].hi.z)};
        tri_order[i] = i;
    }
    Builder builder{boxes.data(), centroids.data(), tri_order, leaf_size};
    builder.n_min.reserve(6 * t);
    builder.build(0, t, 0);
    int n = (int)builder.n_first.size();

    std::memcpy(aabb_min, builder.n_min.data(), sizeof(float) * 3 * n);
    std::memcpy(aabb_max, builder.n_max.data(), sizeof(float) * 3 * n);
    std::memcpy(first, builder.n_first.data(), sizeof(int32_t) * n);
    std::memcpy(count, builder.n_count.data(), sizeof(int32_t) * n);
    std::memcpy(right, builder.n_right.data(), sizeof(int32_t) * n);
    std::memcpy(levels, builder.n_level.data(), sizeof(int32_t) * n);

    // Skip links (iterative DFS).
    std::vector<std::pair<int, int>> stack;
    stack.emplace_back(0, n);
    while (!stack.empty()) {
        auto [nd, sv] = stack.back();
        stack.pop_back();
        skip[nd] = sv;
        if (count[nd] == 0) {
            int left = nd + 1;
            int r = right[nd];
            stack.emplace_back(left, r);
            stack.emplace_back(r, sv);
        }
    }
    return n;
}

}  // extern "C"
