// BVH-accelerated first-hit ray/triangle-mesh intersection — the native
// replacement for the reference's pyembree dependency
// (utils/clean_mesh.py:40, evaluation/clean_mesh.py:205), used by the mesh
// cleaning passes to keep only faces visible from the capture frusta.
//
// Median-split BVH + Moller-Trumbore. C ABI for ctypes:
//   bvh_build(verts, nv, tris, nt) -> handle
//   bvh_first_hit(handle, origins, dirs, n, out_tri_idx, out_t)  (multi-threaded)
//   bvh_free(handle)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
    V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    V3 cross(const V3& o) const {
        return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
    }
    float dot(const V3& o) const { return x * o.x + y * o.y + z * o.z; }
    float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

struct AABB {
    V3 lo{1e30f, 1e30f, 1e30f}, hi{-1e30f, -1e30f, -1e30f};
    void grow(const V3& p) {
        lo = {std::min(lo.x, p.x), std::min(lo.y, p.y), std::min(lo.z, p.z)};
        hi = {std::max(hi.x, p.x), std::max(hi.y, p.y), std::max(hi.z, p.z)};
    }
    void grow(const AABB& b) { grow(b.lo); grow(b.hi); }
};

struct Node {
    AABB box;
    int left = -1, right = -1;   // internal
    int start = 0, count = 0;    // leaf triangle range
};

struct BVH {
    std::vector<V3> v0, e1, e2;      // per-triangle precomputed
    std::vector<AABB> tri_box;
    std::vector<V3> tri_centroid;
    std::vector<int> order;          // triangle permutation
    std::vector<Node> nodes;

    int build_node(int start, int count) {
        Node node;
        for (int i = 0; i < count; ++i) node.box.grow(tri_box[order[start + i]]);
        int idx = (int)nodes.size();
        nodes.push_back(node);
        if (count <= 4) {
            nodes[idx].start = start;
            nodes[idx].count = count;
            return idx;
        }
        V3 ext = node.box.hi - node.box.lo;
        int axis = (ext.x > ext.y && ext.x > ext.z) ? 0 : (ext.y > ext.z ? 1 : 2);
        int mid = count / 2;
        std::nth_element(
            order.begin() + start, order.begin() + start + mid,
            order.begin() + start + count,
            [&](int a, int b) { return tri_centroid[a][axis] < tri_centroid[b][axis]; });
        int l = build_node(start, mid);
        int r = build_node(start + mid, count - mid);
        nodes[idx].left = l;
        nodes[idx].right = r;
        nodes[idx].count = 0;
        return idx;
    }
};

inline bool box_hit(const AABB& b, const V3& o, const V3& inv_d, float tmax) {
    float t0 = 1e-6f, t1 = tmax;
    for (int a = 0; a < 3; ++a) {
        float lo = (b.lo[a] - o[a]) * inv_d[a];
        float hi = (b.hi[a] - o[a]) * inv_d[a];
        if (lo > hi) std::swap(lo, hi);
        t0 = std::max(t0, lo);
        t1 = std::min(t1, hi);
        if (t0 > t1) return false;
    }
    return true;
}

inline bool tri_hit(const V3& v0, const V3& e1, const V3& e2,
                    const V3& o, const V3& d, float& t_out) {
    V3 p = d.cross(e2);
    float det = e1.dot(p);
    if (std::abs(det) < 1e-12f) return false;
    float inv = 1.0f / det;
    V3 s = o - v0;
    float u = s.dot(p) * inv;
    if (u < -1e-7f || u > 1.0f + 1e-7f) return false;
    V3 q = s.cross(e1);
    float v = d.dot(q) * inv;
    if (v < -1e-7f || u + v > 1.0f + 1e-7f) return false;
    float t = e2.dot(q) * inv;
    if (t <= 1e-6f) return false;
    t_out = t;
    return true;
}

// first hits of rays [begin, end)
void cast_range(const BVH* bvh, const float* origins, const float* dirs, int64_t begin,
                int64_t end, int64_t* out_tri, float* out_t) {
    std::vector<int> stack(128);
    for (int64_t r = begin; r < end; ++r) {
        V3 o = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
        V3 d = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
        V3 inv_d = {1.0f / (d.x == 0 ? 1e-12f : d.x),
                    1.0f / (d.y == 0 ? 1e-12f : d.y),
                    1.0f / (d.z == 0 ? 1e-12f : d.z)};
        float best_t = 1e30f;
        int64_t best = -1;
        if (!bvh->nodes.empty()) {
            int sp = 0;
            stack[sp++] = 0;
            while (sp > 0) {
                const Node& node = bvh->nodes[stack[--sp]];
                if (!box_hit(node.box, o, inv_d, best_t)) continue;
                if (node.count > 0) {
                    for (int i = 0; i < node.count; ++i) {
                        int tri = bvh->order[node.start + i];
                        float t;
                        if (tri_hit(bvh->v0[tri], bvh->e1[tri], bvh->e2[tri], o, d, t)
                            && t < best_t) {
                            best_t = t;
                            best = tri;
                        }
                    }
                } else {
                    if (sp + 2 > (int)stack.size()) stack.resize(stack.size() * 2);
                    stack[sp++] = node.left;
                    stack[sp++] = node.right;
                }
            }
        }
        out_tri[r] = best;
        out_t[r] = best < 0 ? -1.0f : best_t;
    }
}

}  // namespace

extern "C" {

void* bvh_build(const float* verts, int64_t nv, const int64_t* tris, int64_t nt) {
    BVH* bvh = new BVH();
    bvh->v0.resize(nt);
    bvh->e1.resize(nt);
    bvh->e2.resize(nt);
    bvh->tri_box.resize(nt);
    bvh->tri_centroid.resize(nt);
    bvh->order.resize(nt);
    for (int64_t i = 0; i < nt; ++i) {
        V3 a = {verts[3 * tris[3 * i] + 0], verts[3 * tris[3 * i] + 1], verts[3 * tris[3 * i] + 2]};
        V3 b = {verts[3 * tris[3 * i + 1]], verts[3 * tris[3 * i + 1] + 1], verts[3 * tris[3 * i + 1] + 2]};
        V3 c = {verts[3 * tris[3 * i + 2]], verts[3 * tris[3 * i + 2] + 1], verts[3 * tris[3 * i + 2] + 2]};
        bvh->v0[i] = a;
        bvh->e1[i] = b - a;
        bvh->e2[i] = c - a;
        bvh->tri_box[i].grow(a);
        bvh->tri_box[i].grow(b);
        bvh->tri_box[i].grow(c);
        bvh->tri_centroid[i] = {(a.x + b.x + c.x) / 3, (a.y + b.y + c.y) / 3,
                                (a.z + b.z + c.z) / 3};
        bvh->order[i] = (int)i;
    }
    if (nt > 0) {
        bvh->nodes.reserve(2 * nt);
        bvh->build_node(0, (int)nt);
    }
    return bvh;
}

void bvh_first_hit(void* handle, const float* origins, const float* dirs,
                   int64_t n, int64_t* out_tri, float* out_t) {
    // the rays are independent: contiguous ranges on the host's threads
    // (the same hits as one thread)
    const BVH* bvh = (const BVH*)handle;
    const int64_t per = 1 << 14;
    const int64_t hw = std::max<int64_t>(1, std::thread::hardware_concurrency());
    const int64_t nt = std::min<int64_t>(hw, (n + per - 1) / per);
    if (nt <= 1) {
        cast_range(bvh, origins, dirs, 0, n, out_tri, out_t);
        return;
    }
    std::vector<std::thread> workers;
    for (int64_t k = 0; k < nt; ++k)
        workers.emplace_back(cast_range, bvh, origins, dirs, n * k / nt, n * (k + 1) / nt,
                             out_tri, out_t);
    for (std::thread& w : workers) w.join();
}

void bvh_free(void* handle) { delete (BVH*)handle; }

}  // extern "C"
