// Exact k-nearest body vertices per query point, for sm_90a.
//
// Replaces icon_tpu/ops/pallas/knn.py:_knn_kernel (launched by
// nearest_vertices_pallas). That kernel keeps one (min, argmin) per
// 512-vertex tile and then retires the best k tiles, so two true neighbours
// in one tile collide (the approx_max_k class). This kernel computes the
// function exactly: every point keeps its own k best (key, index) pairs.
//
// Ranking key: |v|^2 - 2 p.v (the |p|^2 term is constant per point and is
// dropped, as in the JAX package). Ties go to the lowest vertex index:
// vertices are walked in ascending order and a candidate enters the list
// only when strictly less than an entry.
//
// What bounds it on the card: FP32 ALU work, about N * V * 8 flops
// (233k points x 10,242 vertices is ~19 GFLOP, the largest call of a
// 257^3 frame). Nothing but the points, the vertices and the [N, k] output
// touch device memory: one thread per point, vertices staged through shared
// memory in tiles of (x, y, z, |v|^2) that every thread of the block reads
// as the same broadcast word, and the sorted k-list lives in registers
// (k is a template parameter so the insertion unrolls).
//
// Later work: move the distance product onto the tensor cores (it is a
// [N, 4] x [4, V] product) with a fused top-k epilogue, and fuse the
// candidate-face distance of sdf_fast.point_body_features behind it.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // vertices per shared-memory stage (16 KB)

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
           int n, int v, int* __restrict__ out_idx,
           float* __restrict__ out_d2) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < n) {
    px = pts[3 * i + 0];
    py = pts[3 * i + 1];
    pz = pts[3 * i + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }

  for (int t0 = 0; t0 < v; t0 += kTile) {
    const int m = min(kTile, v - t0);
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const float x = verts[3 * (t0 + j) + 0];
      const float y = verts[3 * (t0 + j) + 1];
      const float z = verts[3 * (t0 + j) + 2];
      tile[j] = make_float4(x, y, z, x * x + y * y + z * z);
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float4 q = tile[j];
      const float d = q.w - 2.f * (px * q.x + py * q.y + pz * q.z);
      if (d < bd[K - 1]) {
        // insert before the first strictly larger entry, shift the rest
        float cd = d;
        int ci = t0 + j;
        bool shifting = false;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          if (shifting || d < bd[s]) {
            const float td = bd[s];
            const int ti = bi[s];
            bd[s] = cd;
            bi[s] = ci;
            cd = td;
            ci = ti;
            shifting = true;
          }
        }
      }
    }
    __syncthreads();
  }

  if (i < n) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_idx[i * K + s] = bi[s];
      out_d2[i * K + s] = bd[s];
    }
  }
}

template <int K>
void launch(const float* pts, const float* verts, int n, int v, int* out_idx,
            float* out_d2, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  knn_kernel<K><<<blocks, kThreads, 0, stream>>>(pts, verts, n, v, out_idx,
                                                 out_d2);
}

}  // namespace

extern "C" {

// pts [n, 3] f32, verts [v, 3] f32 (both contiguous, on the device);
// writes out_idx [n, k] int32 and out_d2 [n, k] f32 (ranking keys, sorted
// ascending). Requires 1 <= k <= 8 and v >= k; returns a cudaError_t.
int icon_knn_f32(const float* pts, const float* verts, int n, int v, int k,
                 int* out_idx, float* out_d2, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k < 1 || k > 8 || v < k) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 2: launch<2>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 3: launch<3>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 4: launch<4>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 5: launch<5>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 6: launch<6>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 7: launch<7>(pts, verts, n, v, out_idx, out_d2, s); break;
    default: launch<8>(pts, verts, n, v, out_idx, out_d2, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* icon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
