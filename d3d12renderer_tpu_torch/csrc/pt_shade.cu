// The path tracer's shading of one bounce in two kernels, one thread per
// ray: pt_shade_hit before the bounce's shadow queries, pt_shade_next after
// them (render/pathtracer.py `trace_sample`, ops/pt_shade.py).
//
// * pt_shade_hit: the sky on a miss; the hit's row of the (T, 28) shading
//   table (render/bvh.py `build_shading_table`), its interpolated normal;
//   two-sided normals and the offset hit point p; emission; the sun's
//   direction in its cone and the sun shadow query's t_max (1e30 where the
//   hit faces the sun, else 0); with point lights, the light pick, the
//   direction to a point on the light and that query's t_max.
// * pt_shade_next: the sun's NEE term with MIS, the point light's, then
//   the BRDF sample (its eval_brdf included), the throughput, the live
//   mask, the roulette, the next ray and the next closest-hit t_max.  At
//   the last bounce only the NEE terms.
//
// Replaces no Pallas kernel: the JAX package leaves this shading to XLA,
// which fuses it (d3d12renderer_tpu/render/pathtracer.py `trace_sample`).
// The port ran it eagerly, some 330 PyTorch kernels a bounce, each reading
// and writing (R, 3) tensors in device memory.  Both kernels do a few
// hundred float operations a ray and move a few hundred bytes (the ray, the
// hit record, the path state and the draws; the 28.8 MB table of the atrium
// stays in the 50 MB L2), so they are bound by bytes: 3.35 TB/s on the
// H100.  Each thread keeps every intermediate (normals, the BRDF's terms,
// the light sample) in registers and writes only what the shadow queries
// and the next bounce read; the material is gathered again by pt_shade_next
// from the table (20 bytes of L2) instead of being written and read back
// (40 bytes of device memory).  The live-ray counts go to an int64 counter,
// one atomic per block.
//
// Every operation rounds as the eager PyTorch code it replaces does on the
// card, in the same order (rn_math.cuh keeps nvcc from contracting a * b + c
// into an FMA): a sum over the last axis of 3 is (x0 + x2) + x1 and
// linalg.norm is sqrt((x0^2 + x2^2) + x1^2), as PyTorch's reduction kernel
// splits 3 elements over 2 lanes; a division by a Python float is a product
// with its float reciprocal (`inv_*` below), a Python float divided by a
// tensor the tensor's reciprocal times it; the matmul of Preetham's
// XYZ -> RGB is a chain of FMAs, as cuBLAS computes it.  clamp and max keep
// NaN as PyTorch's do.  So the kernels equal their plain versions
// (render/pathtracer.py) on the card bit for bit, up to the libm calls (cosf,
// sinf, expf, acosf, powf), which are CUDA's own on both sides.
//
// Both launch through cudaLaunchKernel (not <<<>>>), so that g++ can compile
// this file as host C++ for the CPU tests.

#include <cuda_runtime.h>
#include <math.h>

#include "rn_math.cuh"

// Mirrored by ops/pt_shade.py.
constexpr int PT_SHADE_THREADS = 256;
constexpr int PT_TABLE_COLS = 28;
constexpr int PT_SKY_GRADIENT = 0;
constexpr int PT_SKY_PREETHAM = 1;
constexpr int PT_SKY_CUBEMAP = 2;

// One launch of either kernel.  Pointers are device pointers of contiguous
// tensors (float32 unless noted; bool as bytes).  Outside the anonymous
// namespace: it is part of the extern "C" interface.
struct ShadeArgs {
  // The bounce's rays and its closest-hit answer.
  const float* t;                 // (R,)
  const int* tri;                 // (R,) int32, -1 on a miss
  const float* uv;                // (R, 2)
  unsigned char* alive;           // (R,) bool, not read at bounce 0 (all alive)
  const float* origin;            // (R, 3)
  const float* direction;         // (R, 3)
  float* throughput;              // (R, 3), not read at bounce 0 (ones)
  float* radiance;                // (R, 3), added to; pt_shade_hit writes it whole
  // The scene.
  const float* table;             // (T, 28) shading rows
  const float* sky;               // (PT_SKY_COLS,) render/pathtracer.py `sky_table`
  const float* cubemap;           // (6, C, C, 3) or null
  const float* atlas;             // (K, A, A, 3) or null
  const float* light_position;    // (L, 3)
  const float* light_color;       // (L, 3)
  const float* light_radius;      // (L,)
  const unsigned char* light_valid;  // (L,)
  const long long* light_count;   // () int64: the valid lights, at least 1
  // The bounce's draws.
  const float* sun_u1;            // ()
  const float* sun_u2;            // ()
  const long long* light_rank;    // (R,) int64
  const float* light_normal;      // (R, 3)
  const float* brdf_u1;           // (R,)
  const float* brdf_u2;           // (R,)
  const float* brdf_pick;         // (R,)
  const float* roulette;          // (R,), or null: no roulette this bounce
  // Written by pt_shade_hit, read by the shadow queries and pt_shade_next.
  float* normal;                  // (R, 3) the two-sided shading normal
  float* point;                   // (R, 3) p, the shadow rays' and next ray's origin
  float* sun_dir;                 // (R, 3)
  float* sun_t_max;               // (R,)
  float* light_dir;               // (R, 3)
  float* light_t_max;             // (R,)
  const unsigned char* sun_shadowed;    // (R,) the sun query's hit
  const unsigned char* light_shadowed;  // (R,) the point light query's hit
  // Written by pt_shade_next for the next bounce (alive and throughput in
  // place, except at the last bounce).
  float* direction_out;           // (R, 3)
  float* t_max_out;               // (R,)
  unsigned long long* counts;     // (>= live_slot + 1,) int64: [0] += rays traced
  // Python floats as PyTorch rounds them to float32.
  float sun_cone;                 // 1 - SUN_COS_CONE
  float sun_cos;                  // SUN_COS_CONE, the sun disc's test
  float two_pi;                   // 2 pi
  float pi;
  float inv_pi;                   // float(1 / float(pi))
  float sun_pdf;
  float inv_sun_pdf;              // float(1 / float(SUN_PDF))
  float inv_fade;                 // float(1 / float(0.02)), Preetham's horizon fade
  float light_size;               // settings.point_light_radius
  float intensity;                // settings.light_intensity_scale
  int num_rays;
  int num_lights;
  int cube_res;                   // C
  int atlas_res;                  // A
  int sky_kind;                   // PT_SKY_*
  int has_lights;
  int has_atlas;
  int first;                      // bounce 0: every ray alive, throughput 1, radiance 0
  int direct;                     // settings.enable_direct_lighting
  int mis;                        // settings.multiple_importance_sampling
  int last;                       // the last bounce: NEE only
  int live_slot;                  // counts[live_slot] += the next query's live rays
};

namespace {

// The packed sky (render/pathtracer.py `sky_table`).
constexpr int SKY_SUN = 0, SKY_SUN_RADIANCE = 3, SKY_ZENITH = 6, SKY_HORIZON = 9,
              SKY_GROUND = 12, SKY_SCALE = 15, SKY_COEFF = 16, SKY_ZEN = 31, SKY_DEN = 34;
constexpr float T_FAR = 1e30f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {rn_add(a.x, b.x), rn_add(a.y, b.y), rn_add(a.z, b.z)};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {rn_sub(a.x, b.x), rn_sub(a.y, b.y), rn_sub(a.z, b.z)};
}

__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {rn_mul(a.x, b.x), rn_mul(a.y, b.y), rn_mul(a.z, b.z)};
}

__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {rn_mul(a.x, s), rn_mul(a.y, s), rn_mul(a.z, s)};
}

__device__ __forceinline__ V3 divide(V3 a, float s) {
  return {rn_div(a.x, s), rn_div(a.y, s), rn_div(a.z, s)};
}

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V3 zero3() { return {0.0f, 0.0f, 0.0f}; }

// torch.clamp and its min / max forms: NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// x.max(-1).values over 3: NaN if any is.
__device__ __forceinline__ float max3(V3 a) {
  if (isnan(a.x) || isnan(a.y) || isnan(a.z)) return a.x + a.y + a.z;
  return fmaxf(fmaxf(a.x, a.y), a.z);
}

// torch.sum(a * b, -1) on the card.
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return rn_add(rn_add(rn_mul(a.x, b.x), rn_mul(a.z, b.z)), rn_mul(a.y, b.y));
}

// torch.linalg.norm(a, dim=-1) on the card.
__device__ __forceinline__ float norm(V3 a) {
  return sqrtf(rn_add(rn_add(rn_mul(a.x, a.x), rn_mul(a.z, a.z)), rn_mul(a.y, a.y)));
}

// core/maths.py `noz`.
__device__ __forceinline__ V3 noz(V3 a) {
  const float sl = dot(a, a);
  if (sl < 1e-8f) return zero3();
  return divide(a, sqrtf(clamp_min(sl, 1e-8f)));
}

// core/maths.py `orthonormal_basis` (a Python float over a tensor is the
// tensor's reciprocal times the float).
__device__ __forceinline__ void basis(V3 n, V3& t1, V3& t2) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = rn_mul(rn_div(1.0f, rn_add(sign, n.z)), -1.0f);
  const float b = rn_mul(rn_mul(n.x, n.y), a);
  t1 = {rn_add(rn_mul(rn_mul(rn_mul(sign, n.x), n.x), a), 1.0f), rn_mul(sign, b),
        rn_mul(-sign, n.x)};
  t2 = {b, rn_add(sign, rn_mul(rn_mul(n.y, n.y), a)), -n.y};
}

// ---------------------------------------------------------------------------
// The sky (render/pathtracer.py `sky_radiance`)
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 sky_vec(const float* s, int at) { return {s[at], s[at + 1], s[at + 2]}; }

// `_perez` at one direction; c = (a, b, c, e, f).
__device__ __forceinline__ float perez(float cos_t, float gamma, float cos_g, const float* c) {
  const float first = rn_add(rn_mul(c[0], expf(rn_div(c[1], clamp_min(cos_t, 0.01f)))), 1.0f);
  const float second = rn_add(rn_add(rn_mul(c[2], expf(rn_mul(c[3], gamma))), 1.0f),
                              rn_mul(c[4], rn_mul(cos_g, cos_g)));
  return rn_mul(first, second);
}

// `_preetham_radiance` at one direction from the sky's per-scene terms.
__device__ V3 preetham(const float* s, V3 d) {
  const float cos_t = clamp(d.y, 0.01f, 1.0f);
  const float cos_g = clamp(dot(d, sky_vec(s, SKY_SUN)), -1.0f, 1.0f);
  const float gamma = acosf(cos_g);
  float r[3];
  for (int k = 0; k < 3; ++k)
    r[k] = rn_mul(s[SKY_ZEN + k],
                  rn_div(perez(cos_t, gamma, cos_g, s + SKY_COEFF + 5 * k), s[SKY_DEN + k]));
  const float lum = rn_mul(r[0], s[SKY_SCALE]);
  const float x = r[1];
  const float ys = clamp_min(r[2], 1e-4f);
  const float X = rn_div(rn_mul(x, lum), ys);
  const float Z = rn_div(rn_mul(rn_sub(rn_sub(1.0f, x), ys), lum), ys);
  // xyz @ M.T, the (R, 3) x (3, 3) product as cuBLAS chains it.
  const float M[3][3] = {{3.2406f, -1.5372f, -0.4986f},
                         {-0.9689f, 1.8758f, 0.0415f},
                         {0.0557f, -0.2040f, 1.0570f}};
  float rgb[3];
  for (int j = 0; j < 3; ++j)
    rgb[j] = clamp_min(fmaf(Z, M[j][2], fmaf(lum, M[j][1], rn_mul(X, M[j][0]))), 0.0f);
  return {rgb[0], rgb[1], rgb[2]};
}

__device__ __forceinline__ float sign_of(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// `sample_cubemap`: bilinear over a (6, C, C, 3) cubemap.
__device__ V3 cubemap(const ShadeArgs& A, V3 d) {
  const int res = A.cube_res;
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const bool is_x = ax >= ay && ax >= az;
  const bool is_y = !is_x && ay >= az;
  const int face = is_x ? (d.x > 0.0f ? 0 : 1) : is_y ? (d.y > 0.0f ? 2 : 3) : (d.z > 0.0f ? 4 : 5);
  const float major = is_x ? d.x : (is_y ? d.y : d.z);
  const float sc = is_x ? rn_mul(-sign_of(d.x), d.z) : (is_y ? d.x : rn_mul(sign_of(d.z), d.x));
  const float tc = is_y ? rn_mul(sign_of(d.y), d.z) : -d.y;
  const float inv = rn_div(1.0f, clamp_min(fabsf(major), 1e-9f));
  const float top = (float)(res - 1);
  const float u = clamp(rn_mul(rn_add(rn_mul(rn_mul(sc, inv), 0.5f), 0.5f), top), 0.0f, top);
  const float v = clamp(rn_mul(rn_add(rn_mul(rn_mul(tc, inv), 0.5f), 0.5f), top), 0.0f, top);
  long long u0 = (long long)floorf(u), v0 = (long long)floorf(v);
  u0 = u0 < 0 ? 0 : (u0 > res - 2 ? res - 2 : u0);
  v0 = v0 < 0 ? 0 : (v0 > res - 2 ? res - 2 : v0);
  const float fu = rn_sub(u, (float)u0), fv = rn_sub(v, (float)v0);
  const long long base = ((long long)face * res + v0) * res + u0;
  const V3 c00 = load3(A.cubemap, base), c01 = load3(A.cubemap, base + 1);
  const V3 c10 = load3(A.cubemap, base + res), c11 = load3(A.cubemap, base + res + 1);
  const float gu = rn_sub(1.0f, fu), gv = rn_sub(1.0f, fv);
  return add(scale(add(scale(c00, gu), scale(c01, fu)), gv),
             scale(add(scale(c10, gu), scale(c11, fu)), fv));
}

template <int SKY>
__device__ V3 sky_radiance(const ShadeArgs& A, V3 d) {
  const float* s = A.sky;
  const float cos_sun = dot(d, sky_vec(s, SKY_SUN));
  const V3 sun = cos_sun > A.sun_cos ? sky_vec(s, SKY_SUN_RADIANCE) : zero3();
  if (SKY == PT_SKY_CUBEMAP) return add(cubemap(A, d), sun);
  const float y = d.y;
  const V3 ground = sky_vec(s, SKY_GROUND);
  if (SKY == PT_SKY_PREETHAM) {
    const float fade = clamp(rn_mul(y, A.inv_fade), 0.0f, 1.0f);
    return add(add(scale(preetham(s, d), fade), scale(ground, rn_sub(1.0f, fade))), sun);
  }
  const float t = powf(clamp(y, 0.0f, 1.0f), 0.6f);
  const V3 col = y < 0.0f ? ground
                          : add(scale(sky_vec(s, SKY_HORIZON), rn_sub(1.0f, t)),
                                scale(sky_vec(s, SKY_ZENITH), t));
  return add(col, sun);
}

// ---------------------------------------------------------------------------
// Lights and the BRDF
// ---------------------------------------------------------------------------

// `_sample_sun`: the bounce's one direction in the sun's cone.
__device__ V3 sun_sample(const ShadeArgs& A) {
  const float u1 = *A.sun_u1, u2 = *A.sun_u2;
  const float cos_t = rn_sub(1.0f, rn_mul(u1, A.sun_cone));
  const float sin_t = sqrtf(clamp_min(rn_sub(1.0f, rn_mul(cos_t, cos_t)), 0.0f));
  const float phi = rn_mul(u2, A.two_pi);
  const V3 sd = sky_vec(A.sky, SKY_SUN);
  V3 t1, t2;
  basis(sd, t1, t2);
  return add(add(scale(scale(t1, sin_t), cosf(phi)), scale(scale(t2, sin_t), sinf(phi))),
             scale(sd, cos_t));
}

struct LightSample {
  V3 l;          // unit direction to the sampled point
  float dist;
  float att;
  float pdf;     // pdf_l
  int li;
  bool valid;
};

// The point-light pick and its sphere sample (trace_sample's point-light
// block up to pdf_l).
__device__ LightSample light_sample(const ShadeArgs& A, long long r, V3 p) {
  // searchsorted(cumsum(valid), rank + 1): the first light whose running
  // count of valid lights reaches rank + 1, clamped to the last.
  const long long want = A.light_rank[r] + 1;
  int li = A.num_lights;
  long long seen = 0;
  for (int i = 0; i < A.num_lights; ++i) {
    seen += A.light_valid[i] ? 1 : 0;
    if (seen >= want) {
      li = i;
      break;
    }
  }
  li = li < 0 ? 0 : (li > A.num_lights - 1 ? A.num_lights - 1 : li);
  const V3 sp = noz(load3(A.light_normal, r));
  const V3 lp = add(load3(A.light_position, li), scale(sp, A.light_size));
  const V3 to_l = sub(lp, p);
  LightSample s;
  s.li = li;
  s.valid = A.light_valid[li] != 0;
  s.dist = clamp_min(norm(to_l), 1e-5f);
  s.l = divide(to_l, s.dist);
  const float rel = clamp_max(rn_div(s.dist, clamp_min(A.light_radius[li], 1e-5f)), 1.0f);
  const float dd = rn_div(s.dist, clamp_min(rn_sub(1.0f, rn_mul(rel, rel)), 1e-6f));
  s.att = rn_div(1.0f, rn_add(rn_mul(dd, dd), 1.0f));
  const float sz = clamp_max(rn_mul(rn_div(1.0f, s.dist), A.light_size), 1.0f);
  const float omega =
      rn_mul(rn_sub(1.0f, sqrtf(clamp_min(rn_sub(1.0f, rn_mul(sz, sz)), 0.0f))), A.two_pi);
  s.pdf = rn_div(1.0f, clamp_min(rn_mul(rn_mul(omega, 0.5f), (float)*A.light_count), 1e-8f));
  return s;
}

struct Material {
  V3 albedo;
  float rough, metal;
};

// `eval_brdf`: Cook-Torrance GGX + Lambert, and the mixed pdf.
__device__ V3 eval_brdf(const ShadeArgs& A, V3 n, V3 v, V3 l, const Material& m, float& pdf) {
  const float alpha = clamp_min(rn_mul(m.rough, m.rough), 1e-3f);
  const V3 h = noz(add(v, l));
  const float n_dot_v = clamp_min(dot(n, v), 1e-4f);
  const float n_dot_l = clamp_min(dot(n, l), 0.0f);
  const float n_dot_h = clamp(dot(n, h), 0.0f, 1.0f);
  const float v_dot_h = clamp_min(dot(v, h), 1e-4f);
  const float om = rn_sub(1.0f, m.metal);
  const float f0_base = rn_mul(om, 0.04f);
  const float x5 = powf(clamp(rn_sub(1.0f, v_dot_h), 0.0f, 1.0f), 5.0f);
  const float a2 = rn_mul(alpha, alpha);
  const float den = rn_add(rn_mul(rn_mul(n_dot_h, n_dot_h), rn_sub(a2, 1.0f)), 1.0f);
  const float D = rn_div(a2, clamp_min(rn_mul(rn_mul(den, A.pi), den), 1e-8f));
  const float k = rn_mul(rn_mul(alpha, alpha), 0.5f);
  const float omk = rn_sub(1.0f, k);
  const float gv = rn_div(n_dot_v, clamp_min(rn_add(rn_mul(n_dot_v, omk), k), 1e-8f));
  const float gl = rn_div(n_dot_l, clamp_min(rn_add(rn_mul(n_dot_l, omk), k), 1e-8f));
  const float G = rn_mul(gv, gl);
  const float spec = rn_div(rn_mul(D, G), clamp_min(rn_mul(rn_mul(n_dot_v, 4.0f), n_dot_l), 1e-8f));
  const float alb[3] = {m.albedo.x, m.albedo.y, m.albedo.z};
  float f[3];
  for (int i = 0; i < 3; ++i) {
    const float f0 = rn_add(f0_base, rn_mul(alb[i], m.metal));
    const float F = rn_add(f0, rn_mul(rn_sub(1.0f, f0), x5));
    const float diff = rn_mul(rn_mul(rn_mul(alb[i], om), rn_sub(1.0f, F)), A.inv_pi);
    f[i] = rn_mul(rn_add(diff, rn_mul(F, spec)), n_dot_l);
  }
  const float pdf_diff = rn_mul(n_dot_l, A.inv_pi);
  const float pdf_spec = rn_div(rn_mul(D, n_dot_h), clamp_min(rn_mul(v_dot_h, 4.0f), 1e-8f));
  pdf = rn_add(rn_mul(pdf_diff, 0.5f), rn_mul(pdf_spec, 0.5f));
  return {f[0], f[1], f[2]};
}

// `brdf_sample` from its three uniforms: the direction, and f / pdf (zero
// below the surface or where the pdf vanishes) in `w`.
__device__ V3 sample_brdf(const ShadeArgs& A, float u1, float u2, float u3, V3 n, V3 v,
                          const Material& m, V3& w) {
  V3 t1, t2;
  basis(n, t1, t2);
  const float alpha = clamp_min(rn_mul(m.rough, m.rough), 1e-3f);
  const float rad = sqrtf(u1);
  const float phi = rn_mul(u2, A.two_pi);
  const float c = cosf(phi), s = sinf(phi);
  const V3 ld = add(add(scale(t1, rn_mul(rad, c)), scale(t2, rn_mul(rad, s))),
                    scale(n, sqrtf(clamp_min(rn_sub(1.0f, u1), 0.0f))));
  const float cos_t = sqrtf(rn_div(
      rn_sub(1.0f, u1), rn_add(rn_mul(rn_sub(rn_mul(alpha, alpha), 1.0f), u1), 1.0f)));
  const float sin_t = sqrtf(clamp_min(rn_sub(1.0f, rn_mul(cos_t, cos_t)), 0.0f));
  const V3 h = add(add(scale(t1, rn_mul(sin_t, c)), scale(t2, rn_mul(sin_t, s))), scale(n, cos_t));
  const V3 ls = sub(scale(h, rn_mul(dot(v, h), 2.0f)), v);
  const V3 l = noz(u3 < 0.5f ? ls : ld);
  float pdf;
  const V3 f = eval_brdf(A, n, v, l, m, pdf);
  w = pdf > 1e-8f && dot(l, n) > 0.0f ? divide(f, clamp_min(pdf, 1e-8f)) : zero3();
  return l;
}

// ---------------------------------------------------------------------------
// The hit's table row (render/bvh.py `hit_attributes_shaded`)
// ---------------------------------------------------------------------------

__device__ __forceinline__ const float* table_row(const ShadeArgs& A, long long r) {
  const int tri = A.tri[r];
  return A.table + (long long)(tri < 0 ? 0 : tri) * PT_TABLE_COLS;
}

// The barycentric weights (w, u, v) of the hit.
__device__ __forceinline__ V3 weights(const ShadeArgs& A, long long r) {
  const float u = A.uv[2 * r], v = A.uv[2 * r + 1];
  return {rn_sub(rn_sub(1.0f, u), v), u, v};
}

// torch.remainder(x, 1.0).
__device__ __forceinline__ float wrap1(float x) {
  float m = fmodf(x, 1.0f);
  if (m != 0.0f && m < 0.0f) m = rn_add(m, 1.0f);
  return m;
}

// The material at the hit: the table's albedo times the atlas texel (nearest,
// wrapped) where the material has a texture, roughness and metallic.
template <bool ATLAS>
__device__ Material material(const ShadeArgs& A, const float* row, V3 w) {
  Material m;
  m.albedo = {row[19], row[20], row[21]};
  m.rough = row[22];
  m.metal = row[23];
  if (ATLAS) {
    const int tix = (int)row[27];
    if (tix >= 0) {
      const float uu = wrap1(rn_add(rn_add(rn_mul(w.x, row[9]), rn_mul(w.y, row[11])),
                                    rn_mul(w.z, row[13])));
      const float vv = wrap1(rn_add(rn_add(rn_mul(w.x, row[10]), rn_mul(w.y, row[12])),
                                    rn_mul(w.z, row[14])));
      const int res = A.atlas_res;
      int px = (int)rn_mul(uu, (float)(res - 1));
      int py = (int)rn_mul(vv, (float)(res - 1));
      px = px < 0 ? 0 : (px > res - 1 ? res - 1 : px);
      py = py < 0 ? 0 : (py > res - 1 ? res - 1 : py);
      m.albedo = mul(m.albedo, load3(A.atlas, ((long long)tix * res + py) * res + px));
    }
  }
  return m;
}

// Adds a block's count to counts[slot]: on the card `n` is the block's sum
// (__syncthreads_count) and thread 0 adds it; compiled as host code each
// thread runs alone and adds its own.
__device__ __forceinline__ void count_rows(const ShadeArgs& A, int slot, int n) {
#ifdef __CUDA_ARCH__
  if (threadIdx.x != 0) return;
#endif
  if (n > 0) atomicAdd(A.counts + slot, (unsigned long long)n);
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

template <int SKY, bool LIGHTS>
__global__ void __launch_bounds__(PT_SHADE_THREADS) pt_shade_hit(const ShadeArgs A) {
  const long long r = (long long)blockIdx.x * PT_SHADE_THREADS + threadIdx.x;
  const bool in = r < A.num_rays;
  bool need_sun = false, need_light = false;
  if (in) {
    const bool alive = A.first || A.alive[r];
    const bool hit = A.tri[r] >= 0 && alive;
    const V3 o = load3(A.origin, r), d = load3(A.direction, r);
    const V3 thr = A.first ? V3{1.0f, 1.0f, 1.0f} : load3(A.throughput, r);
    V3 rad = A.first ? zero3() : load3(A.radiance, r);
    if (alive && !hit) rad = add(rad, mul(thr, sky_radiance<SKY>(A, d)));
    // The shading normal from the table row, normalised.
    const float* row = table_row(A, r);
    const V3 w = weights(A, r);
    V3 n = add(add(scale(V3{row[0], row[1], row[2]}, w.x), scale(V3{row[3], row[4], row[5]}, w.y)),
               scale(V3{row[6], row[7], row[8]}, w.z));
    n = divide(n, clamp_min(norm(n), 1e-9f));
    // Two-sided: the geometric normal faces the ray, the shading normal
    // follows it.
    V3 gn = {row[15], row[16], row[17]};
    if (dot(gn, d) > 0.0f) gn = neg(gn);
    if (dot(n, gn) < 0.0f) n = neg(n);
    const V3 p = add(add(o, scale(d, A.t[r])), scale(gn, 1e-3f));
    if (hit) rad = add(rad, mul(thr, V3{row[24], row[25], row[26]}));
    store3(A.radiance, r, rad);
    store3(A.normal, r, n);
    store3(A.point, r, p);
    if (A.direct) {
      const V3 l_sun = sun_sample(A);
      need_sun = hit && dot(n, l_sun) > 0.0f;
      store3(A.sun_dir, r, l_sun);
      A.sun_t_max[r] = need_sun ? T_FAR : 0.0f;
      if (LIGHTS) {
        const LightSample ls = light_sample(A, r, p);
        need_light = hit && dot(n, ls.l) > 0.0f && ls.valid;
        store3(A.light_dir, r, ls.l);
        A.light_t_max[r] = need_light ? clamp_min(rn_sub(ls.dist, 1e-3f), 1e-4f) : 0.0f;
      }
    }
  }
  // The rays this bounce asks for: every primary ray at bounce 0, and the
  // unmasked shadow rays.
  const int rays = __syncthreads_count(in && A.first) + __syncthreads_count(need_sun) +
                   __syncthreads_count(need_light);
  count_rows(A, 0, rays);
}

template <bool ATLAS, bool LIGHTS>
__global__ void __launch_bounds__(PT_SHADE_THREADS) pt_shade_next(const ShadeArgs A) {
  const long long r = (long long)blockIdx.x * PT_SHADE_THREADS + threadIdx.x;
  const bool in = r < A.num_rays;
  bool alive_next = false;
  if (in) {
    const bool alive = A.first || A.alive[r];
    const bool hit = A.tri[r] >= 0 && alive;
    const V3 n = load3(A.normal, r);
    const V3 v = neg(load3(A.direction, r));
    const V3 thr = A.first ? V3{1.0f, 1.0f, 1.0f} : load3(A.throughput, r);
    const float* row = table_row(A, r);
    const Material m = material<ATLAS>(A, row, weights(A, r));
    if (A.direct) {
      V3 rad = load3(A.radiance, r);
      bool added = false;
      // Sun NEE with MIS.
      const V3 l_sun = sun_sample(A);
      if (hit && dot(n, l_sun) > 0.0f && !A.sun_shadowed[r]) {
        float pdf_b;
        const V3 f = eval_brdf(A, n, v, l_sun, m, pdf_b);
        const float w_mis = A.mis ? rn_mul(rn_div(1.0f, rn_add(pdf_b, A.sun_pdf)), A.sun_pdf) : 1.0f;
        const V3 contrib = scale(scale(mul(mul(thr, f), sky_vec(A.sky, SKY_SUN_RADIANCE)),
                                       rn_mul(w_mis, A.inv_sun_pdf)),
                                 A.intensity);
        rad = add(rad, contrib);
        added = true;
      }
      if (LIGHTS) {
        const LightSample ls = light_sample(A, r, load3(A.point, r));
        if (hit && dot(n, ls.l) > 0.0f && !A.light_shadowed[r] && ls.valid) {
          float pdf_b;
          const V3 f = eval_brdf(A, n, v, ls.l, m, pdf_b);
          const float w_mis = A.mis ? rn_div(ls.pdf, rn_add(ls.pdf, pdf_b)) : 1.0f;
          const V3 contrib =
              scale(scale(mul(mul(thr, f), load3(A.light_color, ls.li)),
                          rn_div(rn_mul(ls.att, w_mis), ls.pdf)),
                    A.intensity);
          rad = add(rad, contrib);
          added = true;
        }
      }
      if (added) store3(A.radiance, r, rad);
    }
    if (!A.last) {
      V3 w;
      const V3 l = sample_brdf(A, A.brdf_u1[r], A.brdf_u2[r], A.brdf_pick[r], n, v, m, w);
      V3 thr_next = mul(thr, w);
      const float wmax = max3(w);
      alive_next = hit && wmax > 0.0f;
      if (A.roulette != nullptr) {
        const float q = clamp(max3(thr_next), 0.05f, 1.0f);
        thr_next = divide(thr_next, q);
        alive_next = alive_next && A.roulette[r] < q;
      }
      store3(A.throughput, r, thr_next);
      store3(A.direction_out, r, l);
      A.alive[r] = alive_next;
      A.t_max_out[r] = alive_next ? T_FAR : 0.0f;
    }
  }
  if (!A.last) {
    const int live = __syncthreads_count(alive_next);
    count_rows(A, 0, live);
    count_rows(A, A.live_slot, live);
  }
}

template <int SKY, bool LIGHTS>
const void* hit_kernel() {
  return (const void*)pt_shade_hit<SKY, LIGHTS>;
}

const void* pick_hit(const ShadeArgs& a) {
  const bool lights = a.has_lights != 0;
  switch (a.sky_kind) {
    case PT_SKY_GRADIENT: return lights ? hit_kernel<PT_SKY_GRADIENT, true>() : hit_kernel<PT_SKY_GRADIENT, false>();
    case PT_SKY_PREETHAM: return lights ? hit_kernel<PT_SKY_PREETHAM, true>() : hit_kernel<PT_SKY_PREETHAM, false>();
    case PT_SKY_CUBEMAP: return lights ? hit_kernel<PT_SKY_CUBEMAP, true>() : hit_kernel<PT_SKY_CUBEMAP, false>();
  }
  return nullptr;
}

const void* pick_next(const ShadeArgs& a) {
  if (a.has_atlas) return a.has_lights ? (const void*)pt_shade_next<true, true> : (const void*)pt_shade_next<true, false>;
  return a.has_lights ? (const void*)pt_shade_next<false, true> : (const void*)pt_shade_next<false, false>;
}

int launch(const void* kernel, const ShadeArgs* args, int device, void* stream) {
  if (kernel == nullptr) return -1;
  if (args->num_rays == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {(void*)args};
  const dim3 blocks((args->num_rays + PT_SHADE_THREADS - 1) / PT_SHADE_THREADS);
  err = cudaLaunchKernel(kernel, blocks, dim3(PT_SHADE_THREADS), params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pt_shade_args_size() { return (int)sizeof(ShadeArgs); }

// Both launch on `stream` and return cudaGetLastError() after the launch (0
// = ok), or -1 for a sky kind they do not know.
extern "C" int pt_shade_hit_launch(const ShadeArgs* args, int device, void* stream) {
  return launch(pick_hit(*args), args, device, stream);
}

extern "C" int pt_shade_next_launch(const ShadeArgs* args, int device, void* stream) {
  return launch(pick_next(*args), args, device, stream);
}
