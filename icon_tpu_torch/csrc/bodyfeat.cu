// SMPL-local body features at query points on sm_90a: a thread per point.
//
// Stands for icon_tpu/ops/sdf_fast.py:point_body_features (l.792-969), the
// JAX package's XLA formulation: per point, the k x deg candidate faces of
// its k nearest vertices (vert_face_table rows, kNN rank first, then table
// slot), the exact squared point-triangle distance to each (the plane
// projection where its barycentrics all lie in [0, 1], else the least of
// the three clamped segment distances), the FIRST minimum (argmin), the
// winning face's vertex normals, cmap and visibility interpolated at the
// unclamped barycentrics of the point's plane projection, the (-1, 1, -1)
// normal flip, vis = (sum w vis >= 0.1), dist = sqrt(max(d2, 0)) / sqrt(3),
// and the sign: a known inside mask, or the parity of the crossings above
// the point in its lattice column (column_parity_inside: x, y snapped to a
// column with round-half-even, clamped to W - 1 and H - 1 read from meta,
// then the count of the column's C depths > z). Without either it writes
// the unsigned distance; the wrapper signs it (ray bins, winding clusters,
// pseudo-normal) from the winning face it writes too.
//
// Bound: what the function needs, counted from these inputs (chip_smoke.py
// phase 20, bodyfeat_work and bodyfeat_bound). Of a point's k x deg
// candidates only the distinct faces count: the table's pad repeats and
// the faces its k vertices share cannot change a first-minimum pick (on
// the subdiv-5 body about 10 of 16). A distinct face costs 63 float32
// operations (the plane test and its compare in the pick) and then the one
// branch it takes: 20 for the plane projection, 104 for the three clamped
// segments and their least (about 9 in 10 near the body). A point adds 80
// (weights, interpolation, distance, sign) and the weights' 18 double
// operations, each counted twice (the float64 peak is half the float32
// one), and, with the columns, 6 for the snap and a compare a crossing. Its bytes: the point, its k ids and
// 40 bytes of output a point, the body's tables and the columns it reads
// once. At the frame's 232,974-point cap the operations bound it, 0.0060
// ms at 67 TFLOP/s, the bytes a little less at 3.35 TB/s; at the level-0
// lattice and the level-1 bucket the bytes do (phase 20 prints which).
//
// Design: one thread a point, blocks of 128, no shared memory and no
// scratch: the body does not fit in shared memory at SMPL-X size (its
// table 10,475 x 8 ids, 20,908 triangles, and cross_z at 257^2 columns is
// 8.5 MB), so the faces, vertices, attributes and columns are read through
// the read-only path and stay in the 50 MB L2. The candidate loop walks the
// plain version's order and keeps a candidate only if it is strictly
// smaller (a NaN wins over a number, as torch.argmin's), so exact ties keep
// the first candidate.
//
// Every operation is its own rounded float32 instruction (__fmul_rn and
// friends: nvcc would contract a * b + c into an FMA), in the order of the
// plain version's separate tensor operations: the distance as
// kernels/bodyfeat.py:candidate_distances, the weights as
// projection_weights (its crosses fused through double, as the CPU's and
// XLA's crosses are), each interpolation as x0 w0 + x1 w1 + x2 w2 summed
// left to right, and dist as a true division by float32(sqrt 3). So each
// d2, the pick and every output are the plain version's bit for bit on the
// card.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kClamp = 1e-12f;
constexpr float kDegenerate = 1e-6f;     // barycentric s == 0 -> 1e-6
constexpr float kVisThreshold = 0.1f;
constexpr float kSqrt3 = 1.7320508075688772f;

enum Sign { kUnsigned = 0, kKnown = 1, kColumns = 2 };

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float sq(float a) { return __fmul_rn(a, a); }

// torch.clamp(x, min=lo), torch.clamp(x, 0, 1) and torch.minimum on the
// card: a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)};
}
// _dot and _cross of the plain version: each product and sum rounded
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)),
          sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}
// _cross_fused of the plain version: each a1 b2 - a2 b1 as a1 b2 exact in
// double, less the rounded float product a2 b1, rounded once more to float
__device__ __forceinline__ float fused(float a1, float b2, float a2,
                                       float b1) {
  return __double2float_rn(
      __dsub_rn(__dmul_rn(a1, b2), static_cast<double>(mul(a2, b1))));
}
__device__ __forceinline__ V3 cross_fused(V3 a, V3 b) {
  return {fused(a.y, b.z, a.z, b.y), fused(a.z, b.x, a.x, b.z),
          fused(a.x, b.y, a.y, b.x)};
}
// x0 w0 + x1 w1 + x2 w2, left to right
__device__ __forceinline__ float interp(float x0, float x1, float x2,
                                        const float* w) {
  return add(add(mul(x0, w[0]), mul(x1, w[1])), mul(x2, w[2]));
}

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
__device__ __forceinline__ long long load_id(const void* p, long long i,
                                             int is64) {
  return is64 ? __ldg(static_cast<const long long*>(p) + i)
              : static_cast<long long>(__ldg(static_cast<const int*>(p) + i));
}

// the squared distance from p to the segment a-b (the plain version's seg)
__device__ __forceinline__ float seg_d2(V3 p, V3 a, V3 b) {
  const V3 e = vsub(b, a);
  const V3 s = vsub(p, a);
  const float tt = clamp01(dvd(dot(s, e), clamp_min(dot(e, e), kClamp)));
  const V3 q = {add(a.x, mul(tt, e.x)), add(a.y, mul(tt, e.y)),
                add(a.z, mul(tt, e.z))};
  const V3 g = vsub(p, q);
  return add(add(sq(g.x), sq(g.y)), sq(g.z));
}

// the squared distance from p to the triangle (v0, v1, v2), in the order
// of kernels/bodyfeat.py:candidate_distances
__device__ __forceinline__ float tri_d2(V3 p, V3 v0, V3 v1, V3 v2) {
  const V3 u = vsub(v1, v0);
  const V3 v = vsub(v2, v0);
  const V3 n = cross(u, v);
  const float n2 = clamp_min(dot(n, n), kClamp);
  const V3 w = vsub(p, v0);
  const float b2 = dvd(dot(cross(u, w), n), n2);
  const float b1 = dvd(dot(cross(w, v), n), n2);
  const float b0 = sub(sub(1.0f, b1), b2);
  const bool inside = b0 >= 0.0f && b0 <= 1.0f && b1 >= 0.0f &&
                      b1 <= 1.0f && b2 >= 0.0f && b2 <= 1.0f;
  if (inside) {
    const float pn = dvd(dot(w, n), n2);
    const V3 pr = {sub(p.x, mul(pn, n.x)), sub(p.y, mul(pn, n.y)),
                   sub(p.z, mul(pn, n.z))};
    const V3 g = vsub(p, pr);
    return add(add(sq(g.x), sq(g.y)), sq(g.z));
  }
  return tmin(tmin(seg_d2(p, v0, v1), seg_d2(p, v1, v2)), seg_d2(p, v2, v0));
}

struct Args {
  const float* pts;
  const int* nn;
  const float* verts;
  const long long* faces;
  const void* table;
  const float* normals;
  const float* cmaps;
  const float* vis;
  const unsigned char* known;
  const float* cross_z;
  const float* meta;
  float* sdf;
  float* normal;
  float* cmap;
  float* vis_out;
  long long* best_face;
  int n, k, deg, n_cross, sign, table64;
};

__device__ __forceinline__ V3 corner(const Args& a, long long f, int j,
                                     const float* attr) {
  return load3(attr, __ldg(a.faces + 3 * f + j));
}

__global__ void __launch_bounds__(kThreads)
body_features_kernel(const Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const V3 p = load3(a.pts, i);

  // the candidates in the plain version's order: kNN rank, then table slot
  float best = 0.0f;
  long long best_f = 0;
  for (int r = 0; r < a.k; ++r) {
    const long long vid = __ldg(a.nn + static_cast<long long>(i) * a.k + r);
    for (int s = 0; s < a.deg; ++s) {
      const long long f = load_id(a.table, vid * a.deg + s, a.table64);
      const float d = tri_d2(p, corner(a, f, 0, a.verts),
                             corner(a, f, 1, a.verts),
                             corner(a, f, 2, a.verts));
      const bool first = r == 0 && s == 0;
      if (first || d < best || (isnan(d) && !isnan(best))) {
        best = d;
        best_f = f;
      }
    }
  }

  // the winning face's attributes at the unclamped plane-projection
  // barycentrics (kernels/bodyfeat.py:projection_weights)
  const V3 v0 = corner(a, best_f, 0, a.verts);
  const V3 u = vsub(corner(a, best_f, 1, a.verts), v0);
  const V3 v = vsub(corner(a, best_f, 2, a.verts), v0);
  const V3 n = cross_fused(u, v);
  float s = dot(n, n);
  if (s == 0.0f) s = kDegenerate;
  const V3 w = vsub(p, v0);
  const float b2 = dvd(dot(cross_fused(u, w), n), s);
  const float b1 = dvd(dot(cross_fused(w, v), n), s);
  const float wt[3] = {sub(sub(1.0f, b1), b2), b1, b2};

  V3 cn[3], cc[3];
  float cv[3];
  for (int j = 0; j < 3; ++j) {
    const long long c = __ldg(a.faces + 3 * best_f + j);
    cn[j] = load3(a.normals, c);
    cc[j] = load3(a.cmaps, c);
    cv[j] = __ldg(a.vis + c);
  }
  const V3 nq = {interp(cn[0].x, cn[1].x, cn[2].x, wt),
                 interp(cn[0].y, cn[1].y, cn[2].y, wt),
                 interp(cn[0].z, cn[1].z, cn[2].z, wt)};
  const V3 cq = {interp(cc[0].x, cc[1].x, cc[2].x, wt),
                 interp(cc[0].y, cc[1].y, cc[2].y, wt),
                 interp(cc[0].z, cc[1].z, cc[2].z, wt)};
  const float vsum = interp(cv[0], cv[1], cv[2], wt);
  const float dist = dvd(__fsqrt_rn(clamp_min(best, 0.0f)), kSqrt3);
  bool inside = true;
  if (a.sign == kKnown) {
    inside = a.known[i] != 0;
  } else if (a.sign == kColumns) {
    const float* m = a.meta;
    const long long W = static_cast<long long>(__ldg(m + 4));
    const long long H = static_cast<long long>(__ldg(m + 5));
    long long ix = static_cast<long long>(
        rintf(mul(sub(p.x, __ldg(m + 0)), __ldg(m + 2))));
    long long iy = static_cast<long long>(
        rintf(mul(sub(p.y, __ldg(m + 1)), __ldg(m + 3))));
    ix = min(max(ix, 0ll), W - 1);
    iy = min(max(iy, 0ll), H - 1);
    const float* col = a.cross_z + (iy * W + ix) * a.n_cross;
    int above = 0;
    for (int c = 0; c < a.n_cross; ++c) above += __ldg(col + c) > p.z;
    inside = (above & 1) != 0;
  }
  a.sdf[i] = inside ? dist : -dist;
  a.normal[3 * i] = -nq.x;
  a.normal[3 * i + 1] = nq.y;
  a.normal[3 * i + 2] = -nq.z;
  a.cmap[3 * i] = cq.x;
  a.cmap[3 * i + 1] = cq.y;
  a.cmap[3 * i + 2] = cq.z;
  a.vis_out[i] = vsum >= kVisThreshold ? 1.0f : 0.0f;
  a.best_face[i] = best_f;
}

}  // namespace

extern "C" {

// pts [n, 3] f32; nn [n, k] int32: the points' k nearest vertices; verts,
// normals, cmaps [V, 3] f32, vis [V] f32; faces [F, 3] int64; table [V,
// deg] (int64 if table64, else int32); every id in range. sign 0: the
// distance unsigned; 1: signed by known [n] (bool bytes); 2: by the parity
// of cross_z [H * W, n_cross] f32 above each point in its column, meta [6]
// f32 = (x0, y0, inv_dx, inv_dy, W, H) on the card.
// Writes sdf [n], normal [n, 3], cmap [n, 3], vis_out [n] f32 and
// best_face [n] int64. Returns a cudaError_t.
int icon_body_features(const float* pts, int n, const int* nn, int k,
                       const float* verts, const long long* faces,
                       const void* table, int deg, int table64,
                       const float* normals, const float* cmaps,
                       const float* vis, int sign, const unsigned char* known,
                       const float* cross_z, int n_cross, const float* meta,
                       float* sdf, float* normal, float* cmap, float* vis_out,
                       long long* best_face, void* stream) {
  if (n < 0 || k < 1 || deg < 1 || sign < 0 ||
      sign > kColumns || (sign == kKnown && known == nullptr) ||
      (sign == kColumns && (cross_z == nullptr || meta == nullptr ||
                            n_cross < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  Args a{pts,    nn,   verts,  faces,     table,  normals, cmaps,
         vis,    known, cross_z, meta,     sdf,    normal,  cmap,
         vis_out, best_face, n,  k,        deg,    n_cross, sign,
         table64};
  const int grid = (n + kThreads - 1) / kThreads;
  body_features_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* icon_bodyfeat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
