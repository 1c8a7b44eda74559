// Clustered fast winding numbers on sm_90a.
//
// Stands for icon_tpu/ops/sdf_fast.py:fast_winding (l.183-242), the JAX
// package's dense [chunk, m, M] VPU formulation of generalized winding
// numbers (Barill et al. 2018) over balanced k-d face clusters. The
// winding number of a point p is the dipole sum over all K clusters,
//   A_k . (c_k - p) / (4 pi |c_k - p|^3),  |c_k - p|^2 clamped to 1e-12,
// plus, for the m clusters with the smallest gap |c_k - p| - r_k (ties to
// the lower cluster index, as lax.top_k of -gap orders them), the exact
// van Oosterom-Strackee solid angles of their M faces (masked slots left
// out) over 2 pi minus their dipoles.
//
// Design: a thread per point, 128 a block. The block copies the cluster
// table (centroid, bounding radius, dipole: 8 floats a cluster, 8 KB at K =
// 256) into shared memory; every thread walks it in order (a broadcast
// read), sums the dipoles and keeps its m best (gap, index) pairs sorted in
// registers (an insertion chain unrolled over kMaxNear slots, strict <, so
// an equal gap keeps the lower index ahead). The m indices go to shared
// memory (slot-major: no bank conflict), then the thread reads those
// clusters' packed triangles [M, 9] (the whole table is 737 KB at K = 256,
// M = 80, so it lives in L2) and sums atan2(num, den) per cluster.
//
// Every product, sum and quotient of a term is rounded as its own float32
// operation (__fmul_rn and friends: nvcc would contract a * b + c into an
// FMA), in the plain version's order (kernels/winding.py:
// fast_winding_plain), so each dipole, gap and solid angle is the plain
// version's bit for bit and both pick the same clusters. The terms are
// summed in float64, as the plain version sums them: near the surface a
// cluster's 80 solid angles of up to +-pi cancel, and float32 sums in
// PyTorch's order and in this loop's differed by 1.3e-5 (one H100); in
// float64 the two orders differ by far less than the float32 result's
// last bit. The float64 adds are ~1,500 a point, noise beside the atan2s.
//
// Bound: operations. At the frame's shapes (N = 232,974 points, K = 256,
// m = 16, M = 80) a point does ~15 operations a cluster and ~50 plus an
// atan2 a face: ~2.6e10 operations, 0.4 ms at the float32 peak; the bytes
// (12 in and 4 out a point, the tables once) are ~4 MB, ~1 us.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxNear = 16;
constexpr int kMaxClusters = 1024;       // 32 KB of table in shared memory
constexpr float kFourPi = 12.566370614359172f;
constexpr double kInvTwoPi = 1.0 / 6.283185307179586;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// The dipole term of cluster c (table row) at p, and its gap.
__device__ __forceinline__ float dipole(const float* c, float px, float py,
                                        float pz, float* gap) {
  const float rx = sub(c[0], px), ry = sub(c[1], py), rz = sub(c[2], pz);
  const float d2 = fmaxf(dot3(rx, ry, rz, rx, ry, rz), 1e-12f);
  const float sq = sqrtf(d2);
  *gap = sub(sq, c[3]);
  return __fdiv_rn(dot3(rx, ry, rz, c[4], c[5], c[6]),
                   mul(mul(kFourPi, d2), sq));
}

__global__ void __launch_bounds__(kThreads)
fast_winding_kernel(const float* __restrict__ pts, int n,
                    const float* __restrict__ table, int K,
                    const float* __restrict__ ctri,
                    const unsigned char* __restrict__ cmask, int M, int m,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  float* tab = smem;                                   // [K, 8]
  int* near = reinterpret_cast<int*>(smem + 8 * K);    // [kMaxNear, kThreads]
  for (int i = threadIdx.x; i < 8 * K; i += kThreads) tab[i] = table[i];
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const float px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];

  float bg[kMaxNear];
  int bi[kMaxNear];
#pragma unroll
  for (int j = 0; j < kMaxNear; ++j) {
    bg[j] = INFINITY;
    bi[j] = 0;
  }
  double sum_dip = 0.0;
  for (int k = 0; k < K; ++k) {
    float gap;
    sum_dip += dipole(tab + 8 * k, px, py, pz, &gap);
    if (gap < bg[kMaxNear - 1]) {
      bg[kMaxNear - 1] = gap;
      bi[kMaxNear - 1] = k;
#pragma unroll
      for (int j = kMaxNear - 1; j > 0; --j) {
        if (bg[j] < bg[j - 1]) {
          const float g = bg[j];
          bg[j] = bg[j - 1];
          bg[j - 1] = g;
          const int t = bi[j];
          bi[j] = bi[j - 1];
          bi[j - 1] = t;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxNear; ++j) near[j * kThreads + threadIdx.x] = bi[j];

  double corr = 0.0;
  for (int j = 0; j < m; ++j) {
    const int k = near[j * kThreads + threadIdx.x];
    const float* tri = ctri + static_cast<size_t>(k) * M * 9;
    const unsigned char* msk = cmask + static_cast<size_t>(k) * M;
    double om = 0.0;
    for (int f = 0; f < M; ++f) {
      if (!msk[f]) continue;
      const float* t = tri + 9 * f;
      const float ax = sub(t[0], px), ay = sub(t[1], py), az = sub(t[2], pz);
      const float bx = sub(t[3], px), by = sub(t[4], py), bz = sub(t[5], pz);
      const float cx = sub(t[6], px), cy = sub(t[7], py), cz = sub(t[8], pz);
      const float la = sqrtf(dot3(ax, ay, az, ax, ay, az));
      const float lb = sqrtf(dot3(bx, by, bz, bx, by, bz));
      const float lc = sqrtf(dot3(cx, cy, cz, cx, cy, cz));
      const float kx = sub(mul(by, cz), mul(bz, cy));
      const float ky = sub(mul(bz, cx), mul(bx, cz));
      const float kz = sub(mul(bx, cy), mul(by, cx));
      const float num = dot3(ax, ay, az, kx, ky, kz);
      const float den =
          add(add(add(mul(mul(la, lb), lc), mul(dot3(ax, ay, az, bx, by, bz),
                                                lc)),
                  mul(dot3(bx, by, bz, cx, cy, cz), la)),
              mul(dot3(cx, cy, cz, ax, ay, az), lb));
      om += atan2f(num, den);
    }
    float gap;
    const float dip = dipole(tab + 8 * k, px, py, pz, &gap);
    corr += om * kInvTwoPi - dip;
  }
  out[p] = static_cast<float>(sum_dip + corr);
}

}  // namespace

extern "C" {

// pts [n, 3] f32; table [K, 8] f32 (centroid xyz, radius, dipole xyz, 0);
// ctri [K, M, 9] f32 (each slot's three corners); cmask [K, M] u8; writes
// out [n] f32, the winding numbers with exact solid angles for each
// point's m nearest clusters. K <= 1024, 1 <= m <= min(16, K). Returns a
// cudaError_t.
int icon_fast_winding(const float* pts, int n, const float* table, int K,
                      const float* ctri, const unsigned char* cmask, int M,
                      int m, float* out, void* stream) {
  if (n < 0 || K < 1 || K > kMaxClusters || M < 1 || m < 1 ||
      m > kMaxNear || m > K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * 8 * K + sizeof(int) * kMaxNear *
                      kThreads;
  fast_winding_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      pts, n, table, K, ctri, cmask, M, m, out);
  return static_cast<int>(cudaGetLastError());
}

const char* icon_winding_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
