// Clustered fast winding numbers on sm_90a: a warp per point.
//
// Stands for icon_tpu/ops/sdf_fast.py:fast_winding (l.183-242), the JAX
// package's dense [chunk, m, M] VPU formulation of generalized winding
// numbers (Barill et al. 2018) over balanced k-d face clusters. The
// winding number of a point p is the dipole sum over all K clusters,
//   A_k . (c_k - p) / (4 pi |c_k - p|^3),  |c_k - p|^2 clamped to 1e-12,
// plus, for the m clusters with the smallest gap |c_k - p| - r_k (ties to
// the lower cluster index, as lax.top_k of -gap orders them), the exact
// van Oosterom-Strackee solid angles of their M faces (masked slots add
// 0) over 2 pi minus their dipoles.
//
// Bound: operations. At the frame's shapes (N = 232,974 points, K = 256,
// m = 16, M = 80) a point does 20 float32 operations a cluster and 67 a
// face (an atan2 counted as one): 2.1e10 operations, 0.316 ms at the
// 67 TFLOP/s float32 peak (chip_smoke.py's WIND_OPS_PER_CLUSTER and
// WIND_OPS_PER_FACE). Every operation is its own rounded instruction (no
// FMA), so the issue rate of 33.5 T instructions/s caps it at twice that
// before atan2f's own instructions (kernels/profile_winding.py reads them
// from this library's SASS). The bytes (12 in and 4 out a point, the tables
// once) are ~4 MB, ~1 us.
//
// Design: a warp per point, 8 warps a block, each warp walking points with
// a grid stride; the grid is the card's resident capacity (asked of the
// runtime once a card and K). The block copies the cluster table
// transposed ([8, K]: a lane's row read is conflict-free) into shared
// memory once. Where a thread per point (this kernel's first version) read
// 32 scattered 36-byte records a warp load and left about 2 warps a
// scheduler at the level-0 lattice (1,123 warps for 35,937 points), a warp
// per point reads whole lines and has 32 times the warps to hide L2's
// latency with.
// 1. Selection. Lane l takes clusters l, l + 32, ...: their dipoles and
//    the order-preserving uint32 images of their gaps stay in registers
//    (order key = image << 32 | index, unique). m rounds of a warp-wide
//    minimum of the key (two __reduce_min_sync) each pop the global best;
//    the lane that held it rescans its few keys for its next (the
//    smallest above the popped one). So the m picks are exactly the plain
//    version's, ties included, and the dipoles summed are those above the
//    m-th pick's key.
// 2. Faces. The m * M (cluster, face) pairs are dealt to the lanes
//    flattened (40 a lane at m = 16, M = 80; no idle lane for any M), and
//    read from face tiles [K, ceil(M / 32), 10, 32]: a tile row is one
//    coordinate (or the mask) of 32 slots, so each of a warp's 10 loads is
//    one or two 128-byte lines, and a slot's 10 values lie at fixed
//    offsets from one address. The tiles (983 KB at K = 256) stay in L2.
// 3. A fixed-order float64 xor-shuffle reduction; lane 0 writes float(w).
//
// Every product, sum and quotient of a term is rounded as its own float32
// operation (__fmul_rn and friends: nvcc would contract a * b + c into an
// FMA), in the plain version's order (kernels/winding.py:
// fast_winding_plain), so each dipole, gap and solid angle is the plain
// version's bit for bit and both pick the same clusters. The terms are
// summed in float64, as the plain version sums them: near the surface a
// cluster's 80 solid angles of up to +-pi cancel, and float32 sums in two
// orders differed by 1.3e-5 (one H100); in float64 the orders differ by
// far less than the float32 result's last bit.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kWarps = 8;                // points in flight a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxNear = 16;
constexpr int kMaxClusters = 1024;       // 32 KB of table in shared memory
constexpr int kMaxDevices = 16;          // cards whose grid sizes are kept
constexpr int kTileRows = 10;            // a face tile: 9 coordinates, mask
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;
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

// The dipole term of cluster k at p, and its gap; tab is [8, K].
__device__ __forceinline__ float dipole(const float* tab, int K, int k,
                                        float px, float py, float pz,
                                        float* gap) {
  const float rx = sub(tab[k], px), ry = sub(tab[K + k], py),
              rz = sub(tab[2 * K + k], pz);
  const float d2 = fmaxf(dot3(rx, ry, rz, rx, ry, rz), 1e-12f);
  const float sq = sqrtf(d2);
  *gap = sub(sq, tab[3 * K + k]);
  return __fdiv_rn(dot3(rx, ry, rz, tab[4 * K + k], tab[5 * K + k],
                        tab[6 * K + k]),
                   mul(mul(kFourPi, d2), sq));
}

// The float's order-preserving uint32 image (kernels/winding.py:
// _order_keys' int32 image, shifted to unsigned).
__device__ __forceinline__ unsigned order_bits(float g) {
  const unsigned b = __float_as_uint(g);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long order_key(unsigned bits,
                                                        int k) {
  return (static_cast<unsigned long long>(bits) << 32) |
         static_cast<unsigned>(k);
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                      unsigned long long b) {
  return b < a ? b : a;
}

// kPerLane >= ceil(K / 32): the keys and dipoles a lane holds, in
// registers.
template <int kPerLane>
__global__ void __launch_bounds__(kThreads)
fast_winding_kernel(const float* __restrict__ pts, int n,
                    const float* __restrict__ table, int K,
                    const float* __restrict__ tiles, int M, int m,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  float* tab = smem;                                    // [8, K]
  int* near = reinterpret_cast<int*>(smem + 8 * K);     // [kWarps, kMaxNear]
  for (int i = threadIdx.x; i < 8 * K; i += kThreads)
    tab[(i & 7) * K + (i >> 3)] = table[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* sel = near + warp * kMaxNear;
  const int pairs = m * M;
  const int n_tiles = (M + 31) / 32;
  const int j0 = lane / M, f0 = lane - j0 * M;

  for (long long p = static_cast<long long>(blockIdx.x) * kWarps + warp;
       p < n; p += static_cast<long long>(gridDim.x) * kWarps) {
    const float px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];

    // 1. every cluster's dipole and key; the m nearest by (gap, index)
    float dip[kPerLane];
    unsigned bits[kPerLane];
    unsigned long long cur = kNoKey;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int k = lane + 32 * j;
      dip[j] = 0.0f;
      bits[j] = 0u;
      if (k < K) {
        float gap;
        dip[j] = dipole(tab, K, k, px, py, pz, &gap);
        bits[j] = order_bits(gap);
        cur = key_min(cur, order_key(bits[j], k));
      }
    }
    unsigned long long best = 0;
    for (int r = 0; r < m; ++r) {
      const unsigned hi = __reduce_min_sync(
          kFull, static_cast<unsigned>(cur >> 32));
      const unsigned lo = __reduce_min_sync(
          kFull, static_cast<unsigned>(cur >> 32) == hi
                     ? static_cast<unsigned>(cur) : 0xffffffffu);
      best = order_key(hi, static_cast<int>(lo));
      if (lane == 0) sel[r] = static_cast<int>(lo);
      if (cur == best) {             // this lane held it: its next key
        cur = kNoKey;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int kk = lane + 32 * j;
          const unsigned long long key = order_key(bits[j], kk);
          if (kk < K && key > best) cur = key_min(cur, key);
        }
      }
    }
    // the dipoles of the clusters not picked (keys above the m-th pick's)
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int k = lane + 32 * j;
      if (k < K && order_key(bits[j], k) > best) acc += dip[j];
    }
    __syncwarp();

    // 2. the exact solid angles of the m clusters' faces, pairs flattened
    double om = 0.0;
    int j = j0, f = f0;
    for (int i = lane; i < pairs; i += 32) {
      const float* t = tiles + (static_cast<size_t>(sel[j]) * n_tiles +
                                (f >> 5)) * (kTileRows * 32) + (f & 31);
      const float ax = sub(t[0], px), ay = sub(t[32], py),
                  az = sub(t[64], pz);
      const float bx = sub(t[96], px), by = sub(t[128], py),
                  bz = sub(t[160], pz);
      const float cx = sub(t[192], px), cy = sub(t[224], py),
                  cz = sub(t[256], pz);
      const float w = t[288];
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
      om += static_cast<double>(mul(atan2f(num, den), w));
      for (f += 32; f >= M; f -= M) ++j;
    }

    // 3. fixed-order float64 reduction over the warp
    double v = acc + om * kInvTwoPi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (lane == 0) out[p] = static_cast<float>(v);
    __syncwarp();                    // sel is the next point's
  }
}

using KernelFn = void (*)(const float*, int, const float*, int, const float*,
                          int, int, float*);

// The instance whose registers hold ceil(K / 32) keys a lane.
KernelFn pick_kernel(int K) {
  const int per_lane = (K + 31) / 32;
  if (per_lane <= 1) return fast_winding_kernel<1>;
  if (per_lane <= 2) return fast_winding_kernel<2>;
  if (per_lane <= 4) return fast_winding_kernel<4>;
  if (per_lane <= 8) return fast_winding_kernel<8>;
  if (per_lane <= 16) return fast_winding_kernel<16>;
  return fast_winding_kernel<32>;
}

size_t smem_bytes(int K) {
  return sizeof(float) * 8 * K + sizeof(int) * kMaxNear * kWarps;
}

// The blocks of K clusters' instance resident on card dev at once (its SMs
// times the occupancy calculator's blocks an SM), asked of the runtime at
// the card's first launch with K and kept; 0 until then.
std::atomic<int> g_resident[kMaxDevices][kMaxClusters];

cudaError_t resident_blocks(int dev, int K, KernelFn kernel, int* blocks) {
  std::atomic<int>* kept =
      dev < kMaxDevices ? &g_resident[dev][K - 1] : nullptr;
  if (kept && (*blocks = kept->load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads,
                                                        smem_bytes(K));
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (kept) kept->store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// pts [n, 3] f32; table [K, 8] f32 (centroid xyz, radius, dipole xyz, 0);
// tiles [K, ceil(M / 32), 10, 32] f32: each cluster's slots in tiles of
// 32, a row per corner coordinate (a0 a1 a2 b0 ... c2) and a last row of
// the slot mask as 1 or 0, zero past M (kernels/winding.py:face_tiles);
// writes out [n] f32, the winding numbers with exact solid angles for each
// point's m nearest clusters. K <= 1024, 1 <= m <= min(16, K). Returns a
// cudaError_t.
int icon_fast_winding(const float* pts, int n, const float* table, int K,
                      const float* tiles, int M, int m, float* out,
                      void* stream) {
  if (n < 0 || K < 1 || K > kMaxClusters || M < 1 || m < 1 ||
      m > kMaxNear || m > K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const KernelFn kernel = pick_kernel(K);
  int dev = 0, fit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_blocks(dev, K, kernel, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(n) + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(need < fit ? need : fit);
  kernel<<<grid, kThreads, smem_bytes(K),
           static_cast<cudaStream_t>(stream)>>>(
      pts, n, table, K, tiles, M, m, out);
  return static_cast<int>(cudaGetLastError());
}

// The instance that K clusters launch: its registers a thread, local
// memory bytes a thread, threads a block, resident blocks an SM (the
// occupancy calculator's, at its shared memory) and the card's SMs.
int icon_winding_kernel_info(int K, int* regs, int* local_bytes,
                             int* threads, int* blocks_per_sm, int* sms) {
  if (K < 1 || K > kMaxClusters)
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = pick_kernel(K);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads = kThreads;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kThreads, smem_bytes(K));
  return static_cast<int>(err);
}

const char* icon_winding_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
