// Host-side mesh import helpers, for assets/native.py: vertex welding by
// grid hashing, area-weighted vertex normals and a two-pass OBJ geometry
// scan.
//
// The port's own copy of the JAX package's native/mesh_ops.cpp (its
// weld_vertices, generate_normals, obj_count and obj_parse; the BVH builder
// is csrc/bvh_build.cpp), built with g++ at first use by cuda_build.py into
// the host library and called through ctypes.  Built with -std=c++17, which
// turns off floating-point contraction: the normals are summed and divided
// as written.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Vertex welding: merge vertices closer than `tolerance` (grid hashing).
// Returns the number of unique vertices; fills remap[i] = new index of old i.
// ---------------------------------------------------------------------------

struct CellKey {
    int64_t x, y, z;
    bool operator==(const CellKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct CellHash {
    size_t operator()(const CellKey& k) const {
        // Large-prime mix (same spirit as the reference's spatial hashing).
        return (size_t)(k.x * 73856093LL ^ k.y * 19349669LL ^ k.z * 83492791LL);
    }
};

int64_t weld_vertices(const float* positions, int64_t num_vertices,
                      float tolerance, int32_t* remap_out) {
    const double inv = 1.0 / (double)tolerance;
    std::unordered_map<CellKey, int32_t, CellHash> grid;
    grid.reserve((size_t)num_vertices);
    int64_t unique = 0;
    for (int64_t i = 0; i < num_vertices; ++i) {
        CellKey key{
            (int64_t)llround(positions[i * 3 + 0] * inv),
            (int64_t)llround(positions[i * 3 + 1] * inv),
            (int64_t)llround(positions[i * 3 + 2] * inv),
        };
        auto it = grid.find(key);
        if (it == grid.end()) {
            grid.emplace(key, (int32_t)unique);
            remap_out[i] = (int32_t)unique;
            ++unique;
        } else {
            remap_out[i] = it->second;
        }
    }
    return unique;
}

// ---------------------------------------------------------------------------
// Area-weighted vertex normals.
// ---------------------------------------------------------------------------

void generate_normals(const float* positions, int64_t num_vertices,
                      const int32_t* indices, int64_t num_triangles,
                      float* normals_out) {
    memset(normals_out, 0, sizeof(float) * (size_t)num_vertices * 3);
    for (int64_t t = 0; t < num_triangles; ++t) {
        const int32_t a = indices[t * 3], b = indices[t * 3 + 1],
                      c = indices[t * 3 + 2];
        const float* pa = positions + (int64_t)a * 3;
        const float* pb = positions + (int64_t)b * 3;
        const float* pc = positions + (int64_t)c * 3;
        const float e1x = pb[0] - pa[0], e1y = pb[1] - pa[1], e1z = pb[2] - pa[2];
        const float e2x = pc[0] - pa[0], e2y = pc[1] - pa[1], e2z = pc[2] - pa[2];
        const float nx = e1y * e2z - e1z * e2y;
        const float ny = e1z * e2x - e1x * e2z;
        const float nz = e1x * e2y - e1y * e2x;
        for (int32_t v : {a, b, c}) {
            normals_out[(int64_t)v * 3 + 0] += nx;
            normals_out[(int64_t)v * 3 + 1] += ny;
            normals_out[(int64_t)v * 3 + 2] += nz;
        }
    }
    for (int64_t i = 0; i < num_vertices; ++i) {
        float* n = normals_out + i * 3;
        const float len = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
        if (len > 1e-12f) {
            n[0] /= len;
            n[1] /= len;
            n[2] /= len;
        }
    }
}

// ---------------------------------------------------------------------------
// Fast OBJ geometry scan: positions + triangulated faces (v//n and v/t/n
// forms; materials handled by the Python layer).  Two-pass: count, then fill.
// Returns 0 on success.
// ---------------------------------------------------------------------------

int64_t obj_count(const char* text, int64_t length,
                  int64_t* out_vertices, int64_t* out_triangles) {
    int64_t nv = 0, nt = 0;
    const char* p = text;
    const char* end = text + length;
    while (p < end) {
        if (p[0] == 'v' && p + 1 < end && p[1] == ' ') {
            ++nv;
        } else if (p[0] == 'f' && p + 1 < end && p[1] == ' ') {
            int corners = 0;
            const char* q = p + 1;
            while (q < end && *q != '\n') {
                while (q < end && *q == ' ') ++q;
                if (q < end && *q != '\n' && *q != ' ') {
                    ++corners;
                    while (q < end && *q != ' ' && *q != '\n') ++q;
                }
            }
            if (corners >= 3) nt += corners - 2;
        }
        while (p < end && *p != '\n') ++p;
        ++p;
    }
    *out_vertices = nv;
    *out_triangles = nt;
    return 0;
}

int64_t obj_parse(const char* text, int64_t length,
                  float* positions_out, int32_t* indices_out) {
    int64_t nv = 0, nt = 0;
    const char* p = text;
    const char* end = text + length;
    std::vector<int64_t> corner_buf;
    while (p < end) {
        if (p[0] == 'v' && p + 1 < end && p[1] == ' ') {
            char* q = nullptr;
            positions_out[nv * 3 + 0] = strtof(p + 2, &q);
            positions_out[nv * 3 + 1] = strtof(q, &q);
            positions_out[nv * 3 + 2] = strtof(q, &q);
            ++nv;
        } else if (p[0] == 'f' && p + 1 < end && p[1] == ' ') {
            corner_buf.clear();
            const char* q = p + 1;
            while (q < end && *q != '\n') {
                while (q < end && *q == ' ') ++q;
                if (q >= end || *q == '\n') break;
                char* r = nullptr;
                long idx = strtol(q, &r, 10);
                if (r == q) break;
                int64_t vi = idx > 0 ? idx - 1 : nv + idx;
                corner_buf.push_back(vi);
                q = r;
                while (q < end && *q != ' ' && *q != '\n') ++q;  // skip /t/n
            }
            for (size_t k = 1; k + 1 < corner_buf.size(); ++k) {
                indices_out[nt * 3 + 0] = (int32_t)corner_buf[0];
                indices_out[nt * 3 + 1] = (int32_t)corner_buf[k];
                indices_out[nt * 3 + 2] = (int32_t)corner_buf[k + 1];
                ++nt;
            }
        }
        while (p < end && *p != '\n') ++p;
        ++p;
    }
    return nt;
}

}  // extern "C"
