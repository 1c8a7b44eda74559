// SMPL-local body features at query points on sm_90a: a lane group a
// point, its candidate faces in parallel.
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
// one), and, with the columns, 6 for the snap and a compare a crossing. Its
// bytes: the point, its k ids and 40 bytes of output a point, the body's
// tables and the columns it reads once. At the frame's 232,974-point cap
// the operations bound it, 0.0061 ms at 67 TFLOP/s; at the level-0 lattice
// and the level-1 bucket the bytes do (phase 20 prints which).
//
// Design. The body does not fit in shared memory at SMPL-X size (20,908
// triangles; cross_z at 257^2 columns is 8.5 MB), so everything is read
// through the read-only path and stays in the 50 MB L2. A thread a point
// (the previous design) walked its 16 candidates one after the other, each
// a chain of three dependent gathers (table row, the face's ids, its
// corners), 13 scalar loads a candidate. Here:
//
// 1. Per-face records, built once a call by face_records_kernel into a
//    buffer the call owns: the corners, the clamped squared normal n2 and
//    the three clamped squared edge lengths, as kernels/bodyfeat.py:
//    candidate_distances rounds them, and the corner ids, 64 bytes, four
//    16-byte loads. A candidate costs table -> record. The edges, u, v and
//    the cross n are not stored: they are single subtractions and products
//    of the stored corners, recomputed with the same bits, and 64 bytes is
//    what two 32-byte sectors hold (corners alone would still take two).
// 2. A group of G lanes a point, G the power of two at or above k x deg,
//    at most 4 (the frame's k = 2, deg = 8: G = 4, eight points a warp,
//    four candidates a lane). Lane l takes candidates l, l + G, ... in the
//    twin's order and keeps the first minimum with a strict < (a NaN wins
//    over a number, the first NaN over a later one). Four and not 16 or 32
//    lanes (kernels/profile_bodyfeat.py --groups on the H100, PERF.md §6):
//    what a point costs besides its candidates (its loads, the pick, the
//    winner, the column) is paid by every lane of its group; 16 lanes took
//    1.5x as long at the cap, one lane a point 1.7x, 8 lanes 1.1x.
// 3. The pick: a butterfly of shuffles over (NaN first, d2, candidate
//    index), compared as floats (-0 == +0, though d2, a sum of squares,
//    is never -0), with the index breaking ties: the lexicographic least,
//    which is what the walk of every candidate in order with a strict <
//    keeps, and what torch.argmin's comparator picks.
// 4. The winner over the group: its record gives the corners and ids;
//    the nine fused cross terms of the weights (their float64
//    conversions are among the card's slowest instructions) a lane each,
//    then every lane the same weights, and lane t interpolates and writes
//    output t (normal x, y, z, cmap x, y, z, vis, sdf, best_face). The
//    column sign: the column's depths a lane each, the counts summed by
//    shuffles.
//
// Every buffer is the call's (the records allocated by the wrapper on the
// current stream); nothing is read back to the host, so a call can be
// captured in a CUDA graph.
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

constexpr int kThreads = 256;
constexpr int kMaxGroup = 4;             // lanes a point at most
constexpr int kRecordThreads = 256;
constexpr int kRecordVec = 4;            // float4s a record: 64 bytes
constexpr int kOutputs = 9;              // normal 3, cmap 3, vis, sdf, face
constexpr unsigned kFull = 0xffffffffu;
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
// clamp(e . e, 1e-12): a segment's squared length, or the squared normal
__device__ __forceinline__ float clamped_sq(V3 e) {
  return clamp_min(dot(e, e), kClamp);
}

// One face's record: (v0, v1.x) (v1.yz, v2.xy) (v2.z, n2, l01, l12)
// (l20, c0, c1, c2), the ids' int32 bits in float words
struct Record {
  V3 v0, v1, v2;
  float n2, l01, l12, l20;
  int c0, c1, c2;
};

__device__ __forceinline__ Record load_record(const float4* rec,
                                              long long f) {
  const float4 q0 = __ldg(rec + kRecordVec * f);
  const float4 q1 = __ldg(rec + kRecordVec * f + 1);
  const float4 q2 = __ldg(rec + kRecordVec * f + 2);
  const float4 q3 = __ldg(rec + kRecordVec * f + 3);
  return {{q0.x, q0.y, q0.z}, {q0.w, q1.x, q1.y}, {q1.z, q1.w, q2.x},
          q2.y, q2.z, q2.w, q3.x,
          __float_as_int(q3.y), __float_as_int(q3.z), __float_as_int(q3.w)};
}

// the records of faces [F, 3] on verts [V, 3]: a thread a face
__global__ void __launch_bounds__(kRecordThreads)
face_records_kernel(const float* verts, const long long* faces, int F,
                    float4* rec) {
  const int f = blockIdx.x * kRecordThreads + threadIdx.x;
  if (f >= F) return;
  const long long c0 = __ldg(faces + 3ll * f);
  const long long c1 = __ldg(faces + 3ll * f + 1);
  const long long c2 = __ldg(faces + 3ll * f + 2);
  const V3 v0 = load3(verts, c0), v1 = load3(verts, c1),
           v2 = load3(verts, c2);
  const V3 u = vsub(v1, v0);
  const float n2 = clamped_sq(cross(u, vsub(v2, v0)));
  const float l01 = clamped_sq(u);
  const float l12 = clamped_sq(vsub(v2, v1));
  const float l20 = clamped_sq(vsub(v0, v2));
  float4* r = rec + kRecordVec * static_cast<long long>(f);
  r[0] = make_float4(v0.x, v0.y, v0.z, v1.x);
  r[1] = make_float4(v1.y, v1.z, v2.x, v2.y);
  r[2] = make_float4(v2.z, n2, l01, l12);
  r[3] = make_float4(l20, __int_as_float(static_cast<int>(c0)),
                     __int_as_float(static_cast<int>(c1)),
                     __int_as_float(static_cast<int>(c2)));
}

// the squared distance from p to the segment from a along e, whose
// clamped squared length is l (the plain version's seg)
__device__ __forceinline__ float seg_d2(V3 p, V3 a, V3 e, float l) {
  const V3 s = vsub(p, a);
  const float tt = clamp01(dvd(dot(s, e), l));
  const V3 q = {add(a.x, mul(tt, e.x)), add(a.y, mul(tt, e.y)),
                add(a.z, mul(tt, e.z))};
  const V3 g = vsub(p, q);
  return add(add(sq(g.x), sq(g.y)), sq(g.z));
}

// the squared distance from p to a record's triangle, in the order of
// kernels/bodyfeat.py:candidate_distances
__device__ __forceinline__ float record_d2(V3 p, const Record& r) {
  const V3 u = vsub(r.v1, r.v0);
  const V3 v = vsub(r.v2, r.v0);
  const V3 n = cross(u, v);
  const V3 w = vsub(p, r.v0);
  const float b2 = dvd(dot(cross(u, w), n), r.n2);
  const float b1 = dvd(dot(cross(w, v), n), r.n2);
  const float b0 = sub(sub(1.0f, b1), b2);
  const bool inside = b0 >= 0.0f && b0 <= 1.0f && b1 >= 0.0f &&
                      b1 <= 1.0f && b2 >= 0.0f && b2 <= 1.0f;
  if (inside) {
    const float pn = dvd(dot(w, n), r.n2);
    const V3 pr = {sub(p.x, mul(pn, n.x)), sub(p.y, mul(pn, n.y)),
                   sub(p.z, mul(pn, n.z))};
    const V3 g = vsub(p, pr);
    return add(add(sq(g.x), sq(g.y)), sq(g.z));
  }
  return tmin(tmin(seg_d2(p, r.v0, u, r.l01),
                   seg_d2(p, r.v1, vsub(r.v2, r.v1), r.l12)),
              seg_d2(p, r.v2, vsub(r.v0, r.v2), r.l20));
}

// whether candidate (d, j) comes before (e, m) in the pick's order: a NaN
// first, then the lesser distance, then the lower index
__device__ __forceinline__ bool before(float d, int j, float e, int m) {
  const bool dn = isnan(d), en = isnan(e);
  if (dn != en) return dn;
  if (!dn && d != e) return d < e;
  return j < m;
}

struct Args {
  const float* pts;
  const int* nn;
  const float4* rec;
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

template <int G>
__global__ void __launch_bounds__(kThreads)
body_features_kernel(const Args a) {
  const int lane_w = threadIdx.x & 31;
  const int lane = lane_w & (G - 1);
  const int base = lane_w & ~(G - 1);       // the group's first warp lane
  const long long gi =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  // a group past the end repeats the last point and writes nothing, so
  // that every lane of the warp takes part in each shuffle
  const bool live = gi < a.n;
  const long long i = live ? gi : a.n - 1;
  const V3 p = load3(a.pts, i);

  // the crossings above the point in its column, a lane's share of the
  // column's depths (summed over the group after the pick)
  int above = 0;
  if (a.sign == kColumns) {
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
    for (int c = lane; c < a.n_cross; c += G) above += __ldg(col + c) > p.z;
  }

  // this lane's candidates in the plain version's order (kNN rank, then
  // table slot): the first minimum by a strict <
  const int n_cand = a.k * a.deg;
  float best = INFINITY;
  int best_j = n_cand;                  // a lane without a candidate
  long long best_f = 0;
  for (int j = lane; j < n_cand; j += G) {
    const int r = j / a.deg;
    const long long vid = __ldg(a.nn + i * a.k + r);
    const long long f = load_id(a.table, vid * a.deg + (j - r * a.deg),
                                a.table64);
    const float d = record_d2(p, load_record(a.rec, f));
    if (j == lane || d < best || (isnan(d) && !isnan(best))) {
      best = d;
      best_j = j;
      best_f = f;
    }
  }
  // the group's first minimum: every lane ends with the same (d2, index)
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    const float d = __shfl_xor_sync(kFull, best, off);
    const int j = __shfl_xor_sync(kFull, best_j, off);
    if (before(d, j, best, best_j)) {
      best = d;
      best_j = j;
    }
  }
  const long long face =
      __shfl_sync(kFull, best_f, base + (best_j & (G - 1)));

#pragma unroll
  for (int off = G / 2; off > 0; off /= 2)
    above += __shfl_xor_sync(kFull, above, off);
  const bool inside = a.sign == kKnown ? a.known[i] != 0
                      : a.sign == kColumns ? (above & 1) != 0 : true;

  // the winning face's attributes at the unclamped plane-projection
  // barycentrics (kernels/bodyfeat.py:projection_weights). The nine fused
  // cross terms (n = u x v, u x w, w x v) a lane each, gathered by
  // shuffles; then every lane the same weights, and lane t the output t
  const Record r = load_record(a.rec, face);
  const V3 u = vsub(r.v1, r.v0);
  const V3 v = vsub(r.v2, r.v0);
  const V3 w = vsub(p, r.v0);
  constexpr int kTerms = 9;
  constexpr int kRounds = (kTerms + G - 1) / G;
  float term[kRounds];
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int t = (lane + q * G) % kTerms;   // lanes past 8: a spare term
    const V3 x = t < 6 ? u : w;              // cross(x, y)
    const V3 y = t < 3 ? v : t < 6 ? w : v;
    const int c = t % 3;
    term[q] = c == 0 ? fused(x.y, y.z, x.z, y.y)
                     : c == 1 ? fused(x.z, y.x, x.x, y.z)
                              : fused(x.x, y.y, x.y, y.x);
  }
  float tm[kTerms];
#pragma unroll
  for (int t = 0; t < kTerms; ++t)
    tm[t] = __shfl_sync(kFull, term[t / G], base + t % G);
  if (!live) return;
  const V3 n = {tm[0], tm[1], tm[2]};
  float s = dot(n, n);
  if (s == 0.0f) s = kDegenerate;
  const float b2 = dvd(dot({tm[3], tm[4], tm[5]}, n), s);
  const float b1 = dvd(dot({tm[6], tm[7], tm[8]}, n), s);
  const float wt[3] = {sub(sub(1.0f, b1), b2), b1, b2};
  for (int t = lane; t < kOutputs; t += G) {
    if (t < 7) {
      // normal x, y, z, cmap x, y, z, vis: corner values at stride 3, 3, 1
      const float* src = t < 3 ? a.normals + t
                               : t < 6 ? a.cmaps + (t - 3) : a.vis;
      const int stride = t < 6 ? 3 : 1;
      const float x = interp(__ldg(src + stride * r.c0),
                             __ldg(src + stride * r.c1),
                             __ldg(src + stride * r.c2), wt);
      if (t < 3)
        a.normal[3 * i + t] = t == 1 ? x : -x;       // flip (-1, 1, -1)
      else if (t < 6)
        a.cmap[3 * i + (t - 3)] = x;
      else
        a.vis_out[i] = x >= kVisThreshold ? 1.0f : 0.0f;
    } else if (t == 7) {
      const float dist = dvd(__fsqrt_rn(clamp_min(best, 0.0f)), kSqrt3);
      a.sdf[i] = inside ? dist : -dist;
    } else {
      a.best_face[i] = face;
    }
  }
}

using KernelFn = void (*)(const Args);

// G for k x deg candidates: the power of two at or above it, at most
// kMaxGroup
int group_for(int n_cand) {
  int g = 1;
  while (g < n_cand && g < kMaxGroup) g *= 2;
  return g;
}

// the instance for a group of g lanes (a power of two, at most G)
template <int G>
KernelFn kernel_for(int g) {
  if constexpr (G == 1) {
    return body_features_kernel<1>;
  } else {
    return g >= G ? body_features_kernel<G> : kernel_for<G / 2>(g);
  }
}

}  // namespace

extern "C" {

// verts [V, 3] f32, faces [F, 3] int64 (every id in range, V < 2^31);
// writes rec [F, 16] f32 (16-byte aligned), each face's record. Returns a
// cudaError_t.
int icon_bodyfeat_records(const float* verts, const long long* faces,
                          int F, float* rec, void* stream) {
  if (F < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0) return static_cast<int>(cudaSuccess);
  face_records_kernel<<<(F + kRecordThreads - 1) / kRecordThreads,
                        kRecordThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      verts, faces, F, reinterpret_cast<float4*>(rec));
  return static_cast<int>(cudaGetLastError());
}

// pts [n, 3] f32; nn [n, k] int32: the points' k nearest vertices; rec:
// the body's face records (icon_bodyfeat_records); normals, cmaps [V, 3]
// f32, vis [V] f32; table [V, deg] (int64 if table64, else int32); every
// id in range. sign 0: the distance unsigned; 1: signed by known [n] (bool
// bytes); 2: by the parity of cross_z [H * W, n_cross] f32 above each
// point in its column, meta [6] f32 = (x0, y0, inv_dx, inv_dy, W, H) on
// the card. Writes sdf [n], normal [n, 3], cmap [n, 3], vis_out [n] f32
// and best_face [n] int64. Returns a cudaError_t.
int icon_body_features(const float* pts, int n, const int* nn, int k,
                       const float* rec, const void* table, int deg,
                       int table64, const float* normals, const float* cmaps,
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
  Args a{pts,   nn,    reinterpret_cast<const float4*>(rec), table,
         normals, cmaps, vis, known, cross_z, meta, sdf, normal, cmap,
         vis_out, best_face, n, k, deg, n_cross, sign, table64};
  const int g = group_for(k * deg);
  const long long threads = static_cast<long long>(n) * g;
  const long long grid = (threads + kThreads - 1) / kThreads;
  kernel_for<kMaxGroup>(g)<<<static_cast<unsigned>(grid), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The kernel that k x deg candidates launch (which 0), or the record
// builder (which 1), on the current card: registers and local memory bytes
// a thread, threads a block, lanes a point, resident blocks an SM (the
// occupancy calculator's) and SMs. Returns a cudaError_t.
int icon_bodyfeat_kernel_info(int which, int n_cand, int* regs,
                              int* local_bytes, int* threads, int* group,
                              int* blocks_per_sm, int* sms) {
  if ((which != 0 && which != 1) || n_cand < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = nullptr;
  if (which == 0) {
    *group = group_for(n_cand);
    *threads = kThreads;
    fn = reinterpret_cast<const void*>(kernel_for<kMaxGroup>(*group));
  } else {
    *group = 1;
    *threads = kRecordThreads;
    fn = reinterpret_cast<const void*>(face_records_kernel);
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                        *threads, 0);
  return static_cast<int>(err);
}

const char* icon_bodyfeat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
