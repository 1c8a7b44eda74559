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
//
// The backward (JAX's autodiff of the same function, with its rules at
// ties: d|u|/du = +1 at u = 0, and maximum(w, 1e-3) sends half of the
// gradient to w at w == 1e-3). Under a gradient the forward's H and W pass
// also writes the smoothed weight w (icon_box_smooth3d_keep: an optional
// pointer, null in icon_box_smooth3d, whose launch is unchanged).
//
// box_smooth3d_bwd: the accumulator's gradient only where the splat's
// backward reads it, at the voxels of the vertices' trilinear corners
// inside the volume (2,734 of 2,097,152 at PaMIR's 128^3 in a fit; 20,487
// for 8,000 distinct body vertices). The C entry zeroes a count and one
// mark a brick (cudaMemsetAsync of 4 (1 + bricks) bytes: 64 KB at 128^3),
// then two launches. mark_kernel: a lane per (vertex, corner), as
// voxel_splat_bwd's; lanes of one warp whose corners fall in one brick
// (bz x 8 x 8 voxels, z y x) agree by __match_any_sync, one of them claims
// the brick's mark (atomicExch) and the warp's new bricks are appended to
// a list with one atomicAdd. Then rows_kernel: persistent blocks, each
// walking the list; per brick, the gradient at its voxels from the halo of
// its window, in shared memory. The D pass: a thread per (y, x) column of
// the (8 + k - 1)^2 halo reads the column's bz + k - 1 voxels once each,
// in groups whose loads are issued together (column_sums), forms each
// voxel's gradient of the smoothed accumulator (grad_of: g_c / max(w,
// 1e-3), and -(sum_c g_c o_c) / max(w, 1e-3) for the weight where w >
// 1e-3, half of that at w == 1e-3, 0 below) and adds it to the sums whose
// window holds it, into t1 [bz][8 + k - 1][8 + k - 1]; the H sums of t1's
// columns into t2 [bz][8][8 + k - 1]; the W sums of t2's rows, written as
// float4 into g_acc. The window is the mirrored one (offsets -(k - 1 -
// k/2) .. k/2: the adjoint of the zero-padded box, the same box for odd
// k); zero outside the volume; every sum from 0.0 in the order of its
// offsets and divided by k correctly rounded: each voxel's value is bit
// for bit ops/voxelize.py:box_smooth3d_bwd_plain's. g_acc outside the
// listed bricks is left as it was. The time goes to each thread's chain
// of voxel gradients (4 divisions a voxel) with few warps a brick, not to
// bytes: a brick is two planes (one past k = 74, where two planes' halo
// outgrows shared memory), so that a thread's chain is 12 voxels at k =
// 11 and 73 bricks spread phase 18a's rows over 73 SMs (8^3 bricks,
// chains of 18 on 27 SMs, took 1.3x as long, a brick a voxel 2.1x, 6x for
// 8,000 distinct vertices; PERF.md §6). Bound: the union of the rows'
// windows read once (28 bytes a voxel) and the rows written (16 bytes):
// ~1.4 us for the 20,487 rows of 8,000 distinct vertices at 3.35 TB/s,
// below a launch's latency.
//
// voxel_splat_bwd: a lane per (vertex, corner), eight lanes a vertex of a
// batch entry (of every entry in order when the codes are shared, whose
// gradient sums the entries in order): 64,000 gathers at once for 8,000
// vertices. A lane inside the volume gathers its voxel's float4 of the
// gradient G and forms the weight's gradient sum_c G_c code_c + G_3, the
// code's w G and the product rule's terms; the group's lanes then add the
// eight corners' terms by shuffles in the plain version's corner order: no
// atomics, the same bits every run, equal to voxel_splat_bwd_plain's. It
// reads g_acc only at the voxels box_smooth3d_bwd wrote (the same corner
// arithmetic as mark_kernel's). A vertex's corners may lie in bricks of
// other blocks, so it cannot share rows_kernel's launch without a
// grid-wide wait. Bound: the vertices and codes read, the gathered voxels'
// 16 bytes once each, the gradients written (~0.5 MB for 8,000 vertices,
// well below a launch's latency).

#include <cuda_runtime.h>

namespace {

constexpr int kSplatThreads = 256;      // 8 warps: one per trilinear corner
constexpr int kHwThreads = 256;        // the H and W passes' block
constexpr int kMaxSmem = 232448;        // 227 KB of dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr float kWeightFloor = 1e-3f;   // the codes' divisor max(w, 1e-3)
constexpr int kCornerThreads = 256;     // 32 vertices x 8 corners
constexpr int kRowsThreads = 512;       // rows_kernel's largest block

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

// The D pass: t1[b, z, y, x] = (sum over off < k of acc[b, z + off - lo,
// y, x]) / k, zero outside the volume, lo = k / 2. A thread takes RZ
// consecutive z of one (b, y, x) column, neighbouring threads neighbouring
// x.
template <int RZ>
__global__ void __launch_bounds__(kDThreads)
smooth_d_kernel(const float4* __restrict__ acc, float4* __restrict__ t1,
                int D, long long plane, int groups, long long total, int k,
                int lo) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const long long col = i % plane, rest = i / plane;
  const int z0 = static_cast<int>(rest % groups) * RZ;
  const long long first = rest / groups * D * plane + col;
  const int zs = z0 - lo;
  float4 s[RZ];
  slide<RZ>(k, [&](int m) {
    const int z = zs + m;
    if (static_cast<unsigned>(z) >= static_cast<unsigned>(D))
      return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return acc[first + z * plane];
  }, s);
  div_k_all(s, static_cast<float>(k), __frcp_rn(static_cast<float>(k)));
#pragma unroll
  for (int r = 0; r < RZ; ++r)
    if (z0 + r < D) t1[first + (z0 + r) * plane] = s[r];
}

struct HwShape {
  int H, W, k;
  int lo;                          // the window's first offset is -lo
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
// the W sums of T2's rows, then the codes over max(w, 1e-3) as 3 floats
// into out (and w into weight, unless null). K, TX, TY fix k and the tile
// at compile time (0: from sh), so that the sums' shared offsets are
// immediates.
template <int K, int TX, int TY>
__global__ void __launch_bounds__(kHwThreads)
smooth_hw_kernel(const float4* __restrict__ t1, float* __restrict__ out,
                 float* __restrict__ weight, HwShape sh) {
  extern __shared__ float4 smem[];
  const int k = K ? K : sh.k, tx = TX ? TX : sh.tx, ty = TY ? TY : sh.ty;
  const int hx = tx + k - 1, hy = ty + k - 1;
  float4* tile = smem;                           // [hy][hx]
  float4* t2 = tile + hx * hy;                   // [ty][hx]

  int blk = blockIdx.x;
  const int x0 = blk % sh.tiles_x * tx; blk /= sh.tiles_x;
  const int y0 = blk % sh.tiles_y * ty;
  const long long bz = blk / sh.tiles_y;         // b * D + z
  const float4* in = t1 + bz * sh.H * sh.W;
  for (Walk w(hx); w.row < hy; w.next()) {
    const int y = y0 - sh.lo + w.row, x = x0 - sh.lo + w.col;
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
    const long long v = (bz * sh.H + y) * sh.W + x;
    if (weight) weight[v] = s[0].w;
    const float wsum = fmaxf(s[0].w, kWeightFloor);
    float* o = out + v * 3;
    o[0] = div_rn(s[0].x, wsum);
    o[1] = div_rn(s[0].y, wsum);
    o[2] = div_rn(s[0].z, wsum);
  }
}

// The backward's inputs per voxel: the output's gradient g and the output o
// ([.., 3] floats), the smoothed weight w.
struct GradIn {
  const float* g;
  const float* o;
  const float* w;
};

// One voxel's backward inputs: w, then g and o's three channels.
struct GradRaw {
  float w, g[3], o[3];
};

__device__ __forceinline__ GradRaw load_raw(const GradIn& in, long long v) {
  GradRaw r;
  r.w = in.w[v];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.g[c] = in.g[v * 3 + c];
    r.o[c] = in.o[v * 3 + c];
  }
  return r;
}

// The gradient of a voxel's smoothed accumulator (ops/voxelize.py:
// voxel_grad, the same roundings; div_rn keeps the zero dividends of the
// codes' empty voxels, where o is 0, off the division's slow path).
__device__ __forceinline__ float4 grad_of(const GradRaw& r) {
  const float m = fmaxf(r.w, kWeightFloor);
  float s = __fmul_rn(r.g[0], r.o[0]);
  s = __fadd_rn(s, __fmul_rn(r.g[1], r.o[1]));
  s = __fadd_rn(s, __fmul_rn(r.g[2], r.o[2]));
  const float gw = -div_rn(s, m);
  return make_float4(div_rn(r.g[0], m), div_rn(r.g[1], m),
                     div_rn(r.g[2], m),
                     r.w > kWeightFloor ? gw
                     : r.w == kWeightFloor ? __fmul_rn(gw, 0.5f) : 0.0f);
}

// The D sums of one (b, y, x) column for the backward: s[j] = sum over off
// < k of grad_of(voxel z0 + j - lo + off), j < R, each from 0.0 in the
// order of off (first: the column's voxel at z = 0; zs = z0 - lo). The
// column's R + k - 1 voxels are read in groups of kLoadGroup, each
// group's loads issued together before any of its divisions, so a thread
// waits on memory once a group and not once a voxel. A voxel outside the
// volume is a zero term, which changes no sum (none is -0): skipped.
constexpr int kLoadGroup = 3;

template <int R>
__device__ __forceinline__ void column_sums(const GradIn& gin,
                                            long long first,
                                            long long plane, int zs, int D,
                                            int k, float4 (&s)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) s[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int n = R + k - 1;
  for (int m0 = 0; m0 < n; m0 += kLoadGroup) {
    GradRaw raw[kLoadGroup];
    bool ok[kLoadGroup];
#pragma unroll
    for (int p = 0; p < kLoadGroup; ++p) {
      const int z = zs + m0 + p;
      ok[p] = m0 + p < n &&
              static_cast<unsigned>(z) < static_cast<unsigned>(D);
      if (ok[p]) raw[p] = load_raw(gin, first + z * plane);
    }
#pragma unroll
    for (int p = 0; p < kLoadGroup; ++p) {
      if (!ok[p]) continue;
      const float4 t = grad_of(raw[p]);
      const int m = m0 + p;                    // sums j with m - k < j <= m
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (j <= m && m - j < k) s[j] = add4(s[j], t);
    }
  }
}

// A vertex's voxel coordinates in a res^3 volume, as the splat forms them:
// g = (p + 1) * 0.5 * (res - 1), its floor and its fraction.
__device__ __forceinline__ void vertex_cell(const float* p, float scale,
                                            float (&base)[3],
                                            float (&frac)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g = __fmul_rn(__fmul_rn(__fadd_rn(p[a], 1.0f), 0.5f), scale);
    base[a] = floorf(g);
    frac[a] = __fsub_rn(g, base[a]);
  }
}

// Trilinear corner `corner` (bit a: +1 along axis a) of the cell at base:
// its voxel idx (x, y, z), and whether it lies inside the volume (false for
// NaN).
__device__ __forceinline__ bool corner_voxel(const float (&base)[3],
                                             int corner, float scale,
                                             int (&idx)[3]) {
  bool inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = base[a] + static_cast<float>((corner >> a) & 1);
    inside = inside && x >= 0.0f && x <= scale;
    idx[a] = inside ? static_cast<int>(x) : 0;
  }
  return inside;
}

// The bricks of box_smooth3d_bwd: bz x kBrick x kBrick voxels (z, y, x),
// nbz x nb x nb of them a batch entry, numbered ((b nbz + iz) nb + iy) nb
// + ix.
constexpr int kBrick = 8;
struct RowsShape {
  int res, k;
  int lo;                          // the mirrored window's first offset: -lo
  int nbz, nb;
};

// Marks the brick of every (vertex, corner) inside the volume: lane t takes
// corner t % 8 of vertex t / 8 of verts [items, 3] (b V + v). A brick's
// first claim (atomicExch of marks[brick] from 0) appends it to list,
// through one atomicAdd on *count a warp. BZ: the brick's planes.
template <int BZ>
__global__ void __launch_bounds__(kCornerThreads)
mark_kernel(const float* __restrict__ verts, long long items, int V,
            RowsShape sh, int* count, int* marks, int* __restrict__ list) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long item = t >> 3;
  const int lane = threadIdx.x & 31;
  int key = -1;
  if (item < items) {
    const float scale = static_cast<float>(sh.res - 1);
    float base[3], frac[3];
    int idx[3];
    vertex_cell(verts + item * 3, scale, base, frac);
    if (corner_voxel(base, static_cast<int>(t & 7), scale, idx)) {
      const int b = static_cast<int>(item / V);
      key = ((b * sh.nbz + idx[2] / BZ) * sh.nb + idx[1] / kBrick) * sh.nb +
            idx[0] / kBrick;
    }
  }
  const unsigned peers = __match_any_sync(kFull, key);
  const bool claim = key >= 0 && lane == __ffs(peers) - 1 &&
                     __ldcg(marks + key) == 0 &&
                     atomicExch(marks + key, 1) == 0;
  const unsigned won = __ballot_sync(kFull, claim);
  if (won) {                            // warp-uniform
    const int first = __ffs(won) - 1;
    int at = 0;
    if (lane == first) at = atomicAdd(count, __popc(won));
    at = __shfl_sync(kFull, at, first);
    if (claim) list[at + __popc(won & ((1u << lane) - 1u))] = key;
  }
}

// box_smooth3d_bwd at the listed bricks of RZ planes (see the top of the
// file): block i takes list entries i, i + gridDim.x, ... below *count.
template <int RZ>
__global__ void __launch_bounds__(kRowsThreads)
rows_kernel(GradIn gin, const int* count, const int* __restrict__ list,
            float4* __restrict__ g_acc, RowsShape sh) {
  extern __shared__ float4 smem[];
  const int k = sh.k, res = sh.res, cw = kBrick + k - 1;
  float4* t1 = smem;                             // [RZ][cw][cw]
  float4* t2 = t1 + RZ * cw * cw;                // [RZ][kBrick][cw]
  const int n_bricks = __ldcg(count);
  const float kf = static_cast<float>(k), rk = __frcp_rn(kf);
  const long long plane = static_cast<long long>(res) * res;
  for (int i = blockIdx.x; i < n_bricks; i += gridDim.x) {
    const int brick = list[i];
    int rest = brick;
    const int ix = rest % sh.nb; rest /= sh.nb;
    const int iy = rest % sh.nb; rest /= sh.nb;
    const int z0 = rest % sh.nbz * RZ;
    const long long b = rest / sh.nbz;
    const int y0 = iy * kBrick, x0 = ix * kBrick;
    for (Walk c(cw); c.row < cw; c.next()) {     // D: a halo column
      const int y = y0 - sh.lo + c.row, x = x0 - sh.lo + c.col;
      float4 s[RZ];
      if (y >= 0 && y < res && x >= 0 && x < res) {
        column_sums<RZ>(gin, b * res * plane +
                        static_cast<long long>(y) * res + x, plane,
                        z0 - sh.lo, res, k, s);
        div_k_all(s, kf, rk);
      } else {
#pragma unroll
        for (int r = 0; r < RZ; ++r)
          s[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int r = 0; r < RZ; ++r) t1[(r * cw + c.row) * cw + c.col] = s[r];
    }
    __syncthreads();
    for (Walk e(cw); e.row < RZ * kBrick; e.next()) {   // H: (z, y) rows
      const int r = e.row / kBrick, yy = e.row - r * kBrick;
      const float4* col = t1 + (r * cw + yy) * cw + e.col;
      float4 s[1];
      slide<1>(k, [&](int m) { return col[m * cw]; }, s);
      div_k_all(s, kf, rk);
      t2[e.row * cw + e.col] = s[0];
    }
    __syncthreads();
    for (Walk e(kBrick); e.row < RZ * kBrick; e.next()) {  // W: the voxels
      const int r = e.row / kBrick;
      const int z = z0 + r, y = y0 + e.row - r * kBrick, x = x0 + e.col;
      if (z >= res || y >= res || x >= res) continue;
      const float4* line = t2 + e.row * cw + e.col;
      float4 s[1];
      slide<1>(k, [&](int m) { return line[m]; }, s);
      div_k_all(s, kf, rk);
      g_acc[(b * res + z) * plane + static_cast<long long>(y) * res + x] =
          s[0];
    }
    __syncthreads();                             // t1, t2 free again
  }
}

// voxel_splat's backward (see the top of the file): lane t takes corner t %
// 8 of item t / 8, vertex item % V of batch entry item / V
// (codes_batched) or of every entry in order (shared codes). A corner
// inside the volume gathers its voxel's gradient G and forms, by the
// product rule with d|u|/du = +1 at 0, -sign(u_a) g_w times the other two
// factors for frac_a's gradient (g_w = sum_c G_c code_c + G_3), and w G for
// the code's; the eight lanes add them in corner order. Writes g_verts [B,
// V, 3] and, unless null, g_codes (the codes' shape).
__global__ void __launch_bounds__(kCornerThreads)
splat_bwd_kernel(const float* __restrict__ verts,
                 const float* __restrict__ codes,
                 const float4* __restrict__ g_acc, int B, int V,
                 int codes_batched, int res, float* __restrict__ g_verts,
                 float* __restrict__ g_codes) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long item = t >> 3;
  const int corner = static_cast<int>(t & 7);
  const int group = threadIdx.x & 24;           // the vertex's first lane
  const bool live = item < (codes_batched ? static_cast<long long>(B) * V
                                          : V);
  const int v = live ? static_cast<int>(item % V) : 0;
  const int b0 = live && codes_batched ? static_cast<int>(item / V) : 0;
  const int entries = codes_batched ? 1 : B;    // the same in every lane
  const float scale = static_cast<float>(res - 1);
  const long long n = static_cast<long long>(res) * res * res;
  float gc[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < entries; ++j) {
    const long long i = static_cast<long long>(b0 + j) * V + v;
    float st[3] = {0.0f, 0.0f, 0.0f}, lc[3] = {0.0f, 0.0f, 0.0f};
    bool inside = false;
    if (live) {
      const float* c = codes + (codes_batched ? i : v) * 3LL;
      float base[3], frac[3];
      int idx[3];
      vertex_cell(verts + i * 3, scale, base, frac);
      inside = corner_voxel(base, corner, scale, idx);
      if (inside) {
        float u[3], au[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          u[a] = __fsub_rn(static_cast<float>(1 - ((corner >> a) & 1)),
                           frac[a]);
          au[a] = fabsf(u[a]);
        }
        const float4 G = __ldg(g_acc + (b0 + j) * n +
                               (static_cast<long long>(idx[2]) * res +
                                idx[1]) * res + idx[0]);
        float gw = __fmul_rn(G.x, c[0]);
        gw = __fadd_rn(gw, __fmul_rn(G.y, c[1]));
        gw = __fadd_rn(gw, __fmul_rn(G.z, c[2]));
        gw = __fadd_rn(gw, G.w);
        const float w = __fmul_rn(__fmul_rn(au[0], au[1]), au[2]);
        lc[0] = __fmul_rn(w, G.x);
        lc[1] = __fmul_rn(w, G.y);
        lc[2] = __fmul_rn(w, G.z);
        const float q = __fmul_rn(gw, au[2]);
        const float term[3] = {__fmul_rn(q, au[1]), __fmul_rn(q, au[0]),
                               __fmul_rn(gw, __fmul_rn(au[0], au[1]))};
#pragma unroll
        for (int a = 0; a < 3; ++a) st[a] = u[a] >= 0.0f ? term[a] : -term[a];
      }
    }
    const unsigned in_mask = __ballot_sync(kFull, inside);
    float gf[3] = {0.0f, 0.0f, 0.0f}, ls[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {       // the corners in order, from 0.0
      const int src = group + c;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float sa = __shfl_sync(kFull, st[a], src);
        const float la = __shfl_sync(kFull, lc[a], src);
        if ((in_mask >> src) & 1u) {
          gf[a] = __fsub_rn(gf[a], sa);
          ls[a] = __fadd_rn(ls[a], la);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (live && corner == 0) g_verts[i * 3 + a] = __fmul_rn(gf[a],
                                                              0.5f * scale);
      gc[a] = __fadd_rn(gc[a], ls[a]);
    }
  }
  if (g_codes && live && corner == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) g_codes[item * 3 + a] = gc[a];
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
                     long long plane, int k, int lo, cudaStream_t stream) {
  const int groups = (D + RZ - 1) / RZ;
  const long long total = static_cast<long long>(B) * groups * plane;
  const long long blocks = (total + kDThreads - 1) / kDThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  smooth_d_kernel<RZ><<<static_cast<unsigned>(blocks), kDThreads, 0,
                        stream>>>(acc, t1, D, plane, groups, total, k, lo);
  return cudaGetLastError();
}

cudaError_t launch_d_rz(int rz, const float4* acc, float4* t1, int B, int D,
                        long long plane, int k, int lo, cudaStream_t s) {
  return rz == 16 ? launch_d<16>(acc, t1, B, D, plane, k, lo, s)
         : rz == 8 ? launch_d<8>(acc, t1, B, D, plane, k, lo, s)
         : rz == 4 ? launch_d<4>(acc, t1, B, D, plane, k, lo, s)
                   : launch_d<2>(acc, t1, B, D, plane, k, lo, s);
}

template <int K, int TX, int TY>
cudaError_t launch_hw(const float4* t1, float* out, float* weight,
                      const HwShape& sh, long long blocks, int smem,
                      cudaStream_t stream) {
  // per call: the attribute holds for the current device only
  const cudaError_t err = cudaFuncSetAttribute(
      smooth_hw_kernel<K, TX, TY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  smooth_hw_kernel<K, TX, TY><<<static_cast<unsigned>(blocks), kHwThreads,
                                smem, stream>>>(t1, out, weight, sh);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// Both passes of the box smooth; see icon_box_smooth3d.
int smooth(const float* acc, float* t1, float* out, float* weight, int B,
           int D, int H, int W, int k, int rz, int tx, int ty, void* stream) {
  if (B < 0 || D < 1 || H < 1 || W < 1 || k < 1 || tx < 1 || ty < 1 ||
      (rz != 2 && rz != 4 && rz != 8 && rz != 16) || k < rz - 1 ||
      !aligned16(acc) || !aligned16(t1))
    return static_cast<int>(cudaErrorInvalidValue);
  HwShape sh;
  sh.H = H; sh.W = W; sh.k = k; sh.tx = tx; sh.ty = ty;
  sh.lo = k / 2;
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
  const cudaError_t err = launch_d_rz(rz, a, t, B, D, plane, k, sh.lo, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = static_cast<int>(smem);
  // PaMIR's box (res 128, sigma 0.05) and its tile at compile time: its H
  // and W pass takes 0.040 ms at 128^3, the generic build 0.044 (PERF.md
  // §6)
  return static_cast<int>(
      k == 11 && tx == 64 && ty == 16
          ? launch_hw<11, 64, 16>(t, out, weight, sh, blocks, m, s)
          : launch_hw<0, 0, 0>(t, out, weight, sh, blocks, m, s));
}

// Shared bytes of a rows_kernel block of bricks of bz planes: t1 and t2.
long long rows_smem(int bz, int k) {
  return 16LL * bz * (kBrick + k - 1) * (2LL * kBrick + k - 1);
}

// A brick's planes for box k: two while their halo fits shared memory (k
// <= 74), else one (k <= 109, the forward's limit); 0 past that.
int brick_depth(int k) {
  if (k < 1) return 0;
  return rows_smem(2, k) <= kMaxSmem ? 2 : rows_smem(1, k) <= kMaxSmem ? 1
                                                                        : 0;
}

RowsShape rows_shape(int res, int k, int bz) {
  RowsShape sh;
  sh.res = res; sh.k = k; sh.lo = k - 1 - k / 2;
  sh.nbz = (res + bz - 1) / bz;
  sh.nb = (res + kBrick - 1) / kBrick;
  return sh;
}

// Both launches of box_smooth3d_bwd with bricks of RZ planes: mark_kernel,
// then rows_kernel on a persistent grid (as many blocks as fit on the
// card at once, at most one a possible brick).
template <int RZ>
cudaError_t launch_rows(const float* verts, long long items, int V,
                        const GradIn& gin, int* count, int* marks, int* list,
                        float4* g_acc, const RowsShape& sh, long long bricks,
                        cudaStream_t stream) {
  const long long mark_blocks = (items * 8 + kCornerThreads - 1) /
                                kCornerThreads;
  if (mark_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mark_kernel<RZ><<<static_cast<unsigned>(mark_blocks), kCornerThreads, 0,
                    stream>>>(verts, items, V, sh, count, marks, list);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(rows_smem(RZ, sh.k));
  const int columns = (kBrick + sh.k - 1) * (kBrick + sh.k - 1);
  const int threads = columns >= kRowsThreads ? kRowsThreads
                                              : (columns + 31) / 32 * 32;
  err = cudaFuncSetAttribute(
      rows_kernel<RZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rows_kernel<RZ>, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = bricks < items * 8 ? bricks : items * 8;
  const long long grid = most < 1LL * sms * per_sm ? most : 1LL * sms * per_sm;
  rows_kernel<RZ><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      gin, count, list, g_acc, sh);
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
  return smooth(acc, t1, out, nullptr, B, D, H, W, k, rz, tx, ty, stream);
}

// icon_box_smooth3d that also writes the smoothed weight (channel 3 before
// the floor) into weight [B, D, H, W] f32: the forward under a gradient.
int icon_box_smooth3d_keep(const float* acc, float* t1, float* out,
                           float* weight, int B, int D, int H, int W, int k,
                           int rz, int tx, int ty, void* stream) {
  if (weight == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return smooth(acc, t1, out, weight, B, D, H, W, k, rz, tx, ty, stream);
}

// The int32 words of icon_box_smooth3d_bwd's scratch for B volumes of
// res^3 and box k: a count, a mark a brick and a list of bricks. -1 for
// what the kernels do not take.
long long icon_box_smooth3d_bwd_scratch(int B, int res, int k) {
  const int bz = brick_depth(k);
  if (B < 0 || res < 1 || bz == 0) return -1;
  const RowsShape sh = rows_shape(res, k, bz);
  return 1 + 2LL * B * sh.nbz * sh.nb * sh.nb;
}

// box_smooth3d's backward at the voxels of the trilinear corners of verts
// [B, V, 3] f32 inside the res^3 volume: from g_out and out [B, res, res,
// res, 3] f32 and the kept weight [B, res, res, res] f32, writes the
// accumulator's gradient into g_acc [B, res, res, res, 4] f32 (16-byte
// aligned) at every voxel of the bricks that hold one; other voxels are
// left as they were. scratch: icon_box_smooth3d_bwd_scratch(B, res, k)
// int32 words, any content (the call zeroes its count and marks first).
// Returns a cudaError_t.
int icon_box_smooth3d_bwd(const float* g_out, const float* out,
                          const float* weight, const float* verts, int B,
                          int V, int res, int k, int* scratch, float* g_acc,
                          void* stream) {
  const int bz = brick_depth(k);
  if (B < 0 || V < 0 || res < 1 || bz == 0 || !aligned16(g_acc))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowsShape sh = rows_shape(res, k, bz);
  const long long bricks = 1LL * B * sh.nbz * sh.nb * sh.nb;
  const long long items = 1LL * B * V;
  if (bricks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(1 + bricks) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GradIn gin{g_out, out, weight};
  float4* g = reinterpret_cast<float4*>(g_acc);
  int* marks = scratch + 1;
  int* list = marks + bricks;
  err = bz == 2 ? launch_rows<2>(verts, items, V, gin, scratch, marks, list,
                                 g, sh, bricks, s)
                : launch_rows<1>(verts, items, V, gin, scratch, marks, list,
                                 g, sh, bricks, s);
  return static_cast<int>(err);
}

// voxel_splat's backward: verts [B, V, 3], codes [V, 3] (codes_batched 0)
// or [B, V, 3], g_acc [B, res^3, 4] (16-byte aligned; read only at the
// voxels of the vertices' trilinear corners inside the volume), all f32;
// writes g_verts [B, V, 3] and, unless g_codes is null, g_codes of the
// codes' shape. Returns a cudaError_t.
int icon_voxel_splat_bwd(const float* verts, const float* codes,
                         const float* g_acc, int B, int V, int codes_batched,
                         int res, float* g_verts, float* g_codes,
                         void* stream) {
  if (B < 0 || V < 0 || res < 1 || !aligned16(g_acc))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = codes_batched ? static_cast<long long>(B) * V
                                        : (B > 0 ? V : 0);
  const long long blocks = (items * 8 + kCornerThreads - 1) / kCornerThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  splat_bwd_kernel<<<static_cast<unsigned>(blocks), kCornerThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      verts, codes, reinterpret_cast<const float4*>(g_acc), B, V,
      codes_batched, res, g_verts, g_codes);
  return static_cast<int>(cudaGetLastError());
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
