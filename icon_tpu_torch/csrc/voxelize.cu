// Semantic voxelization on sm_90a: the trilinear splat and the fused box
// smooth.
//
// Stands for icon_tpu/ops/voxelize.py:voxelize_semantic (l.43-109), the JAX
// package's XLA replacement (a scatter-add per corner and a padded
// depthwise sum per axis) for the reference's voxelize_cuda extension
// (lib/net/voxelize.py). PaMIR voxelizes the fitted body once a frame:
// 8,000 vertices, most of them padding at the origin, into a 128^3 volume.
//
// voxel_splat: a block of eight warps takes 32 vertices of one batch entry,
// warp c their trilinear corner c, lane i vertex i: 64,000 lanes for 8,000
// vertices. Each lane maps its vertex to voxel coordinates as the plain
// version does ((v + 1) * 0.5 * (res - 1)) and keys its corner by the flat
// index of its voxel in acc [B, res^3, 4] (no key for a corner outside the
// volume or a NaN coordinate: the plain version adds a zero weight at a
// clamped voxel there, which is the same sum). __match_any_sync groups the
// lanes of equal key; when a group has two or more lanes, the warp walks
// those lanes in order and each group's lowest lane sums its members'
// (w * code, w) float4 from 0.0 by shuffles. Then one lane per group
// issues one 16-byte vector atomic (atomicAdd on a float4, compute
// capability 9.x): a warp of 32 padded vertices at one point costs one L2
// operation, not 128. The C entry zeroes acc first (cudaMemsetAsync); acc
// must be 16-byte aligned (the wrapper checks). Bound: the accumulator
// zeroed and written once (33.5 MB at res 128: ~10 us at 3.35 TB/s); the
// vertices are noise beside it. Tolerance: the voxel's m non-negative terms
// are summed by some binary tree (warp partial sums, then atomics in an
// order that changes from run to run), which is within (m - 1) 2^-24 of
// their exact sum, as the plain version's sequential sum is: the two differ
// by at most 2 m 2^-24 of the sum.
//
// box_smooth3d: two launches. A one-launch design (a ring of the last k
// planes of a tile's halo in shared memory, streamed through z) summed D
// over the whole halo and took 0.155-0.172 ms against these passes' 0.070
// (PERF.md §6). The D pass: a thread per (b, y, x) column and rz
// consecutive z, neighbouring threads on neighbouring x; it reads the rz +
// k - 1 planes of its window once each, in order, and adds each to every
// sum whose window holds it (slide), so each output still sums its k terms
// from 0.0 in the order of the offsets. It writes t1 [B, D, H, W, 4], the
// one scratch of the accumulator's size. The H and W passes: a block of
// 256 threads per (b, z) plane's tx x ty tile copies the (tx + k - 1) x
// (ty + k - 1) halo of t1 into shared memory with cp.async (16 bytes a
// thread, zero filled outside the volume: the plain version's zero
// padding), sums k rows of each halo column into T2 [ty][tx + k - 1], then
// k columns of each T2 row, and writes the codes over max(w, 1e-3) as 3
// floats. Every step is the plain version's: __fadd_rn from 0.0 in offset
// order (adding the padding's zeros changes no sum), a correctly rounded
// division by k (div_k: Markstein's correction of x * RN(1/k), held to
// __fdiv_rn for every float32 significand by icon_voxel_div_check), then
// __fdiv_rn by the weight: bit for bit. The wrapper picks rz and the tile
// (64 x 16 first) per k; shared memory is 16 (tx + k - 1) (2 ty + k - 1)
// bytes, at most 227 KB: k <= 109 (an 8 x 8 tile). Bound: the accumulator
// read once and the volume written once (58.7 MB at res 128: ~17.5 us);
// t1 adds a write and a read of 33.5 MB each, the halos mostly L2 hits.

#include <cuda_runtime.h>

namespace {

constexpr int kSplatThreads = 256;      // 8 warps: one per trilinear corner
constexpr int kHwThreads = 256;        // the H and W passes' block
constexpr int kMaxSmem = 232448;        // 227 KB of dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// x / d (d > 0) as __fdiv_rn rounds it. A zero dividend, most of a splat's
// volume, returns at once: the division's range check sends zeros to its
// slow path.
__device__ __forceinline__ float div_rn(float x, float d) {
  if (x == 0.0f) return x;
  return __fdiv_rn(x, d);
}

// x / k correctly rounded, with rk = __frcp_rn(k) hoisted out of the loops:
// RN(x rk) corrected once by its exact residual (Markstein), zero kept.
// Exact where div_k_fast(x): for 2^-64 <= |x| < 2^64 every step scales
// with x's exponent, so the check over one binade (icon_voxel_div_check:
// every float32 significand, every k the kernels take) covers them all.
__device__ __forceinline__ bool div_k_fast(float x) {
  return x == 0.0f || (__float_as_uint(x) >> 23 & 0xffu) - 63u < 128u;
}

__device__ __forceinline__ float div_k(float x, float k, float rk) {
  const float q = __fmul_rn(x, rk);
  return x == 0.0f ? x : __fmaf_rn(__fmaf_rn(-q, k, x), rk, q);
}

// s[j] / k for every j, in place: all the quotients without a branch, so
// that they overlap, then one branch, rarely taken, to div_rn for a value
// outside div_k_fast.
template <int N>
__device__ __forceinline__ void div_k_all(float4 (&s)[N], float k,
                                          float rk) {
  float4 q[N];
  bool fast = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    fast = fast & div_k_fast(s[j].x) & div_k_fast(s[j].y) &
           div_k_fast(s[j].z) & div_k_fast(s[j].w);
    q[j] = make_float4(div_k(s[j].x, k, rk), div_k(s[j].y, k, rk),
                       div_k(s[j].z, k, rk), div_k(s[j].w, k, rk));
  }
  if (!fast) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      q[j] = make_float4(div_rn(s[j].x, k), div_rn(s[j].y, k),
                         div_rn(s[j].z, k), div_rn(s[j].w, k));
  }
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] = q[j];
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(
      __shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
      __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

__global__ void __launch_bounds__(kSplatThreads)
splat_kernel(const float* __restrict__ verts, const float* __restrict__ codes,
             int V, int codes_batched, int res, float4* __restrict__ acc) {
  const int chunks = (V + 31) / 32;
  const int b = blockIdx.x / chunks;
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x % chunks * 32 + lane;
  const int corner = threadIdx.x >> 5;
  long long key = -1;                   // the voxel in acc, -1 for none
  float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (v < V) {
    const long long i = static_cast<long long>(b) * V + v;
    const float* p = verts + i * 3;
    const float* c = codes + (codes_batched ? i : v) * 3LL;
    const float scale = static_cast<float>(res - 1);
    const int d[3] = {corner & 1, (corner >> 1) & 1, corner >> 2};
    long long idx[3];
    float w = 1.0f;
    bool inside = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float g = __fmul_rn(__fmul_rn(__fadd_rn(p[a], 1.0f), 0.5f), scale);
      const float base = floorf(g);
      const float x = base + static_cast<float>(d[a]);
      inside = inside && x >= 0.0f && x <= scale;     // false for NaN
      const float wa = fabsf(__fsub_rn(static_cast<float>(1 - d[a]),
                                       __fsub_rn(g, base)));
      w = a == 0 ? wa : __fmul_rn(w, wa);
      idx[a] = inside ? static_cast<long long>(x) : 0;
    }
    if (inside) {
      key = static_cast<long long>(b) * res * res * res +
            (idx[2] * res + idx[1]) * res + idx[0];
      val = make_float4(__fmul_rn(w, c[0]), __fmul_rn(w, c[1]),
                        __fmul_rn(w, c[2]), w);
    }
  }
  const unsigned peers = __match_any_sync(
      kFull, static_cast<unsigned long long>(key));
  const unsigned grouped = __ballot_sync(kFull, key >= 0 && __popc(peers) > 1);
  if (grouped) {                        // warp-uniform
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (unsigned rest = grouped; rest; rest &= rest - 1) {
      const int src = __ffs(rest) - 1;
      const float4 t = shfl4(val, src);
      if ((peers >> src) & 1u) sum = add4(sum, t);
    }
    if ((grouped >> lane) & 1u) val = sum;
  }
  if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(acc + key, val);
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// s[j] = sum over off < k of in(j + off), j < R, each summed from 0.0 in the
// order of off: the inputs m = 0 .. R + k - 2 are read once, in order, and
// each is added to the sums whose window holds it. Needs k >= R - 1.
template <int R, typename In>
__device__ __forceinline__ void slide(int k, In in, float4 (&s)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) s[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int m = 0; m < R - 1; ++m) {                // only j <= m has begun
    const float4 t = in(m);
#pragma unroll
    for (int j = 0; j <= m; ++j) s[j] = add4(s[j], t);
  }
#pragma unroll 4
  for (int m = R - 1; m < k; ++m) {                 // every j is in window
    const float4 t = in(m);
#pragma unroll
    for (int j = 0; j < R; ++j) s[j] = add4(s[j], t);
  }
#pragma unroll
  for (int i = 0; i < R - 1; ++i) {                 // only j > i is open
    const float4 t = in(k + i);
#pragma unroll
    for (int j = i + 1; j < R; ++j) s[j] = add4(s[j], t);
  }
}

constexpr int kDThreads = 256;

// The D pass: t1[b, z, y, x] = (sum over off < k of acc[b, z + off - half,
// y, x]) / k, zero outside the volume. A thread takes RZ consecutive z of
// one (b, y, x) column, neighbouring threads neighbouring x.
template <int RZ>
__global__ void __launch_bounds__(kDThreads)
smooth_d_kernel(const float4* __restrict__ acc, float4* __restrict__ t1,
                int D, long long plane, int groups, long long total, int k) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const long long col = i % plane, rest = i / plane;
  const int z0 = static_cast<int>(rest % groups) * RZ;
  const long long first = rest / groups * D * plane + col;
  const int zs = z0 - k / 2;
  float4 s[RZ];
  slide<RZ>(k, [&](int m) {
    const int z = zs + m;
    return static_cast<unsigned>(z) < static_cast<unsigned>(D)
               ? acc[first + z * plane]
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }, s);
  div_k_all(s, static_cast<float>(k), __frcp_rn(static_cast<float>(k)));
#pragma unroll
  for (int r = 0; r < RZ; ++r)
    if (z0 + r < D) t1[first + (z0 + r) * plane] = s[r];
}

struct HwShape {
  int H, W, k;
  int tx, ty;                      // output tile
  int tiles_x, tiles_y;
};

// Walks e = threadIdx.x, + blockDim.x, ... below n * cols as (row, col) of
// a cols-wide array without a division per step.
struct Walk {
  int row, col, drow, dcol, cols;
  __device__ explicit Walk(int cols_)
      : row(threadIdx.x / cols_), col(threadIdx.x % cols_),
        drow(blockDim.x / cols_), dcol(blockDim.x % cols_), cols(cols_) {}
  __device__ void next() {
    row += drow;
    col += dcol;
    if (col >= cols) { col -= cols; ++row; }
  }
};

// The H and W passes and the normalization of one (b, z) plane's tx x ty
// tile: its (tx + k - 1) x (ty + k - 1) halo of t1 in shared memory (zero
// outside the volume), the H sums of its columns into T2 [ty][tx + k - 1],
// the W sums of T2's rows, then the codes over max(w, 1e-3) as 3 floats.
// K, TX, TY fix k and the tile at compile time (0: from sh), so that the
// sums' shared offsets are immediates.
template <int K, int TX, int TY>
__global__ void __launch_bounds__(kHwThreads)
smooth_hw_kernel(const float4* __restrict__ t1, float* __restrict__ out,
                 HwShape sh) {
  extern __shared__ float4 smem[];
  const int k = K ? K : sh.k, tx = TX ? TX : sh.tx, ty = TY ? TY : sh.ty;
  const int half = k / 2, hx = tx + k - 1, hy = ty + k - 1;
  float4* tile = smem;                           // [hy][hx]
  float4* t2 = tile + hx * hy;                   // [ty][hx]

  int blk = blockIdx.x;
  const int x0 = blk % sh.tiles_x * tx; blk /= sh.tiles_x;
  const int y0 = blk % sh.tiles_y * ty;
  const long long bz = blk / sh.tiles_y;         // b * D + z
  const float4* in = t1 + bz * sh.H * sh.W;
  for (Walk w(hx); w.row < hy; w.next()) {
    const int y = y0 - half + w.row, x = x0 - half + w.col;
    const bool ok = y >= 0 && y < sh.H && x >= 0 && x < sh.W;
    cp_async16(tile + w.row * hx + w.col,
               ok ? in + static_cast<long long>(y) * sh.W + x : in, ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const float kf = static_cast<float>(k), rk = __frcp_rn(kf);
  for (Walk w(hx); w.row < ty; w.next()) {       // H: k rows of a column
    const float4* col = tile + w.row * hx + w.col;
    float4 s[1];
    slide<1>(k, [&](int m) { return col[m * hx]; }, s);
    div_k_all(s, kf, rk);
    t2[w.row * hx + w.col] = s[0];
  }
  __syncthreads();
  for (Walk w(tx); w.row < ty; w.next()) {       // W: k columns of a row
    const int y = y0 + w.row, x = x0 + w.col;
    if (y >= sh.H || x >= sh.W) continue;
    const float4* line = t2 + w.row * hx + w.col;
    float4 s[1];
    slide<1>(k, [&](int m) { return line[m]; }, s);
    div_k_all(s, kf, rk);
    const float wsum = fmaxf(s[0].w, 1e-3f);
    float* o = out + ((bz * sh.H + y) * sh.W + x) * 3;
    o[0] = div_rn(s[0].x, wsum);
    o[1] = div_rn(s[0].y, wsum);
    o[2] = div_rn(s[0].z, wsum);
  }
}

// Counts into *bad the (k, x) of k in [1, kmax] and x in [1, 2) whose
// div_k differs from __fdiv_rn in any bit: a thread per significand.
__global__ void div_check_kernel(int kmax, unsigned long long* bad) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (1u << 23)) return;
  const float x = __uint_as_float(0x3f800000u | i);
  unsigned n = 0;
  for (int k = 1; k <= kmax; ++k) {
    const float kf = static_cast<float>(k);
    n += !div_k_fast(x) ||
         __float_as_uint(div_k(x, kf, __frcp_rn(kf))) !=
         __float_as_uint(__fdiv_rn(x, kf));
  }
  if (n) atomicAdd(bad, static_cast<unsigned long long>(n));
}

template <int RZ>
cudaError_t launch_d(const float4* acc, float4* t1, int B, int D,
                     long long plane, int k, cudaStream_t stream) {
  const int groups = (D + RZ - 1) / RZ;
  const long long total = static_cast<long long>(B) * groups * plane;
  const long long blocks = (total + kDThreads - 1) / kDThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  smooth_d_kernel<RZ><<<static_cast<unsigned>(blocks), kDThreads, 0,
                        stream>>>(acc, t1, D, plane, groups, total, k);
  return cudaGetLastError();
}

template <int K, int TX, int TY>
cudaError_t launch_hw(const float4* t1, float* out, const HwShape& sh,
                      long long blocks, int smem, cudaStream_t stream) {
  // per call: the attribute holds for the current device only
  const cudaError_t err = cudaFuncSetAttribute(
      smooth_hw_kernel<K, TX, TY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  smooth_hw_kernel<K, TX, TY><<<static_cast<unsigned>(blocks), kHwThreads,
                                smem, stream>>>(t1, out, sh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// verts [B, V, 3] f32, codes [V, 3] (codes_batched 0) or [B, V, 3] f32;
// zeroes and fills acc [B, res^3, 4] f32 (16-byte aligned). Returns a
// cudaError_t.
int icon_voxel_splat(const float* verts, const float* codes, int B, int V,
                     int codes_batched, int res, float* acc, void* stream) {
  if (B < 0 || V < 0 || res < 1 ||
      reinterpret_cast<unsigned long long>(acc) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(B) * res * res * res * 4 *
                       sizeof(float);
  cudaError_t err = cudaMemsetAsync(acc, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * ((V + 31) / 32);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  splat_kernel<<<static_cast<unsigned>(blocks), kSplatThreads, 0, s>>>(
      verts, codes, V, codes_batched, res, reinterpret_cast<float4*>(acc));
  return static_cast<int>(cudaGetLastError());
}

// acc [B, D, H, W, 4] f32 (read only, 16-byte aligned), t1 scratch of its
// size (16-byte aligned); writes out [B, D, H, W, 3] f32: the D pass with
// rz outputs a thread, then the H and W passes on (tx, ty) tiles. Returns
// a cudaError_t.
int icon_box_smooth3d(const float* acc, float* t1, float* out, int B, int D,
                      int H, int W, int k, int rz, int tx, int ty,
                      void* stream) {
  if (B < 0 || D < 1 || H < 1 || W < 1 || k < 1 || tx < 1 || ty < 1 ||
      (rz != 2 && rz != 4 && rz != 8 && rz != 16) || k < rz - 1 ||
      reinterpret_cast<unsigned long long>(acc) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(t1) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  HwShape sh;
  sh.H = H; sh.W = W; sh.k = k; sh.tx = tx; sh.ty = ty;
  sh.tiles_x = (W + tx - 1) / tx;
  sh.tiles_y = (H + ty - 1) / ty;
  const long long smem = 16LL * (tx + k - 1) * (2LL * ty + k - 1);
  const long long blocks = 1LL * B * D * sh.tiles_y * sh.tiles_x;
  if (smem > kMaxSmem || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const float4* a = reinterpret_cast<const float4*>(acc);
  float4* t = reinterpret_cast<float4*>(t1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(H) * W;
  const cudaError_t err =
      rz == 16 ? launch_d<16>(a, t, B, D, plane, k, s)
      : rz == 8 ? launch_d<8>(a, t, B, D, plane, k, s)
      : rz == 4 ? launch_d<4>(a, t, B, D, plane, k, s)
                : launch_d<2>(a, t, B, D, plane, k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = static_cast<int>(smem);
  // PaMIR's box (res 128, sigma 0.05) and its tile at compile time: its H
  // and W pass takes 0.040 ms at 128^3, the generic build 0.044 (PERF.md
  // §6)
  return static_cast<int>(
      k == 11 && tx == 64 && ty == 16
          ? launch_hw<11, 64, 16>(t, out, sh, blocks, m, s)
          : launch_hw<0, 0, 0>(t, out, sh, blocks, m, s));
}

// Adds to *bad (zeroed by the caller) the count of (k, x), k in [1, kmax],
// x in [1, 2), where the smooth's division by k differs from __fdiv_rn.
// Returns a cudaError_t.
int icon_voxel_div_check(int kmax, unsigned long long* bad, void* stream) {
  div_check_kernel<<<(1u << 23) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(kmax, bad);
  return static_cast<int>(cudaGetLastError());
}

const char* icon_voxel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
