// Semantic voxelization on sm_90a: the trilinear splat and the separable
// box smooth.
//
// Stands for icon_tpu/ops/voxelize.py:voxelize_semantic (l.43-109), the JAX
// package's XLA replacement (a scatter-add per corner and a padded
// depthwise sum per axis) for the reference's voxelize_cuda extension
// (lib/net/voxelize.py). PaMIR voxelizes the fitted body once a frame:
// 8,000 vertices into a 128^3 volume.
//
// voxel_splat: one thread per (batch, vertex). The thread maps the vertex to
// voxel coordinates as the plain version does ((v + 1) * 0.5 * (res - 1)),
// and for each of its eight trilinear corners inside the volume adds
// w * code to channels 0..2 and w to channel 3 of the voxel's float4 in
// acc [B, res^3, 4] by float atomics (a corner outside adds nothing; the
// plain version adds a zero weight at a clamped voxel, which is the same
// sum). The C entry zeroes acc first (cudaMemsetAsync). Bound: the
// accumulator, zeroed and written once (33.5 MB at res 128: ~10 us at
// 3.35 TB/s); the 8,000 vertices are noise beside it. The atomics add in
// an order that changes from run to run: every term is non-negative, so
// two orders of a voxel's m terms differ by at most 2 (m - 1) 2^-24 of its
// sum.
//
// box_smooth3d: three launches of one pass kernel, over D, then H, then W,
// of the 4-channel accumulator viewed as [outer, n, inner] float4 (n the
// smoothed axis). A block stages a tile of `to` outer rows x the whole line
// of n x `tj` inner positions (at most 2,048 float4, 32 KB) in shared
// memory, consecutive threads on consecutive addresses, then each output
// sums its k window from 0.0 in the order of the offsets (0 .. k - 1,
// entries outside the line skipped: the plain version adds its zero
// padding there, which changes no sum) and divides by k. The W pass writes
// vol / max(wsum, 1e-3) [B, D, H, W, 3] instead of the float4. Each step is
// one __fadd_rn / __fdiv_rn, the plain version's rounding order, so the
// result is bit-identical to it. Bound: the accumulator read once and the
// volume written once (58.7 MB at res 128: ~17.5 us); three passes move
// ~201 MB. Fusing the axes is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileEntries = 2048;        // float4 a block stages (32 KB)

__global__ void __launch_bounds__(kThreads)
splat_kernel(const float* __restrict__ verts, const float* __restrict__ codes,
             int B, int V, int codes_batched, int res,
             float* __restrict__ acc) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(B) * V) return;
  const long long b = i / V;
  const float* p = verts + i * 3;
  const float* c = codes + (codes_batched ? i : i - b * V) * 3;
  const float scale = static_cast<float>(res - 1);
  float base[3], frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g = __fmul_rn(__fmul_rn(__fadd_rn(p[a], 1.0f), 0.5f), scale);
    base[a] = floorf(g);
    frac[a] = __fsub_rn(g, base[a]);
  }
  const float c0 = c[0], c1 = c[1], c2 = c[2];
  const long long n = static_cast<long long>(res) * res * res;
  float* out = acc + b * n * 4;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int d[3] = {corner & 1, (corner >> 1) & 1, corner >> 2};
    float w = 1.0f;
    bool inside = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = base[a] + static_cast<float>(d[a]);
      inside = inside && x >= 0.0f && x <= scale;     // false for NaN
      const float wa = fabsf(__fsub_rn(static_cast<float>(1 - d[a]),
                                       frac[a]));
      w = a == 0 ? wa : __fmul_rn(w, wa);
    }
    if (!inside) continue;
    const long long x = static_cast<long long>(base[0]) + d[0];
    const long long y = static_cast<long long>(base[1]) + d[1];
    const long long z = static_cast<long long>(base[2]) + d[2];
    float* o = out + ((z * res + y) * res + x) * 4;
    atomicAdd(o + 0, __fmul_rn(w, c0));
    atomicAdd(o + 1, __fmul_rn(w, c1));
    atomicAdd(o + 2, __fmul_rn(w, c2));
    atomicAdd(o + 3, w);
  }
}

// One box pass along the middle axis of [outer, n, inner] float4. Writes
// out (float4), or with normalized != nullptr the normalized codes [.., 3].
__global__ void __launch_bounds__(kThreads)
smooth_pass_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                   float* __restrict__ normalized, long long outer, int n,
                   long long inner, int to, int tj, int k) {
  __shared__ float4 tile[kTileEntries];
  const long long tiles_j = (inner + tj - 1) / tj;
  const long long o0 = static_cast<long long>(blockIdx.x) / tiles_j * to;
  const long long j0 = static_cast<long long>(blockIdx.x) % tiles_j * tj;
  const int count = to * n * tj;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int j = e % tj, i = e / tj % n, oo = e / (tj * n);
    const long long o = o0 + oo, jj = j0 + j;
    tile[e] = o < outer && jj < inner ? in[(o * n + i) * inner + jj]
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  const int half = k / 2;
  const float kf = static_cast<float>(k);
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int j = e % tj, i = e / tj % n, oo = e / (tj * n);
    const long long o = o0 + oo, jj = j0 + j;
    if (o >= outer || jj >= inner) continue;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int off = 0; off < k; ++off) {
      const int src = i + off - half;
      if (src < 0 || src >= n) continue;
      const float4 t = tile[(oo * n + src) * tj + j];
      s.x = __fadd_rn(s.x, t.x);
      s.y = __fadd_rn(s.y, t.y);
      s.z = __fadd_rn(s.z, t.z);
      s.w = __fadd_rn(s.w, t.w);
    }
    s = make_float4(__fdiv_rn(s.x, kf), __fdiv_rn(s.y, kf),
                    __fdiv_rn(s.z, kf), __fdiv_rn(s.w, kf));
    const long long g = (o * n + i) * inner + jj;
    if (normalized == nullptr) {
      out[g] = s;
    } else {
      const float wsum = fmaxf(s.w, 1e-3f);
      normalized[g * 3 + 0] = __fdiv_rn(s.x, wsum);
      normalized[g * 3 + 1] = __fdiv_rn(s.y, wsum);
      normalized[g * 3 + 2] = __fdiv_rn(s.z, wsum);
    }
  }
}

cudaError_t smooth_pass(const float4* in, float4* out, float* normalized,
                        long long outer, int n, long long inner, int k,
                        cudaStream_t stream) {
  if (n > kTileEntries) return cudaErrorInvalidValue;
  const int tj = static_cast<int>(
      inner < kTileEntries / n ? inner : kTileEntries / n);
  const int to = kTileEntries / (n * tj);
  const long long blocks = (outer + to - 1) / to * ((inner + tj - 1) / tj);
  if (blocks < 1) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  smooth_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      in, out, normalized, outer, n, inner, to, tj, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// verts [B, V, 3] f32, codes [V, 3] (codes_batched 0) or [B, V, 3] f32;
// zeroes and fills acc [B, res^3, 4] f32. Returns a cudaError_t.
int icon_voxel_splat(const float* verts, const float* codes, int B, int V,
                     int codes_batched, int res, float* acc, void* stream) {
  if (B < 0 || V < 0 || res < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(B) * res * res * res * 4 *
                       sizeof(float);
  cudaError_t err = cudaMemsetAsync(acc, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * V;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  splat_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      verts, codes, B, V, codes_batched, res, acc);
  return static_cast<int>(cudaGetLastError());
}

// acc [B, D, H, W, 4] f32 (read only); tmp1, tmp2 scratch of its size;
// writes out [B, D, H, W, 3] f32. Returns a cudaError_t.
int icon_box_smooth3d(const float* acc, float* tmp1, float* tmp2, float* out,
                      int B, int D, int H, int W, int k, void* stream) {
  if (B < 0 || D < 1 || H < 1 || W < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* a = reinterpret_cast<const float4*>(acc);
  float4* t1 = reinterpret_cast<float4*>(tmp1);
  float4* t2 = reinterpret_cast<float4*>(tmp2);
  cudaError_t err = smooth_pass(a, t1, nullptr, B, D,
                                static_cast<long long>(H) * W, k, s);
  if (err == cudaSuccess)
    err = smooth_pass(t1, t2, nullptr, static_cast<long long>(B) * D, H, W,
                      k, s);
  if (err == cudaSuccess)
    err = smooth_pass(t2, nullptr, out, static_cast<long long>(B) * D * H, W,
                      1, k, s);
  return static_cast<int>(err);
}

const char* icon_voxel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
