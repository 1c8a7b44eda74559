// The tile rasterizer on sm_90a: face setup, binning, and the raster step
// forward and backward.
//
// Stands for the XLA rasterizer of icon_tpu/ops/raster.py:rasterize
// (l.87-225: the conservative face -> tile binning into a static [tiles, K]
// list, l.44-84; then, per 32x32 tile, the edge functions of every
// (pixel, face) pair, a z-buffer by argmin depth, barycentric interpolation
// of the winning face, and the SoftRas silhouette over every face of the
// tile, all differentiable). A forward call is three launches and reads
// nothing to the host:
//
// raster_setup: one thread per face. It gathers the face's vertices, maps
// them to pixel coordinates as the plain version does ((ndc + 1) * 0.5 * W),
// and writes the face's tile box (the plain binning's floor, clamp and
// offscreen rules) and its slot data once, as six float4 arrays: the
// vertices, the edge vectors, the clamped signed area and its sign, the
// depths, sign / edge length for the silhouette, and a rejection threshold
// for the inside test. Each block of 256 faces also writes the union of its
// faces' boxes (a chunk box); block 0 zeroes the overflow count and the
// per-tile completion counters (raster_fwd's last block of a tile resets
// its counter, so a forward may be launched again on the same buffers).
//
// raster_bin: one block per tile. It tests the chunk boxes 256 at a time,
// then the faces of each overlapping chunk in ascending order; a warp
// ballot and a block prefix sum rank each overlapping face, ranks below K
// are written. So each tile lists its first K faces in ascending face id,
// -1 padded, with the per-tile count (clamped to K) and the dropped pairs,
// exactly the plain binning's [tiles, K] list with no [tiles, F] matrix.
//
// raster_fwd: a grid of (tiles, S) blocks of 256 threads. Block (t, s)
// takes the tile's slots [s R, (s + 1) R) up to the tile's count and all
// 1,024 pixels, four per thread (one column, rows r, r + 8, r + 16, r + 24,
// so the x terms of the edge functions are shared by the four). Slots are
// staged 16 at a time by cp.async, double-buffered. Per (pixel, slot) pair:
// three edge functions, the silhouette's signed distance from the
// precomputed sign / length, a pre-test that rejects pairs whose rounded
// barycentric must fall below -1e-6 before the three divisions, and the
// log(1 - sigmoid) term. Where a tile takes several blocks, each writes its
// winner (depth, slot) and log-sum per pixel, and the last block to finish
// (a per-tile atomic counter) merges them in slot order: the first slot
// with the strictly smallest depth wins, as torch.argmin keeps the first
// minimum; the log-sums add. The merging block then interpolates the
// winner's attributes and writes the images, the winning slot and the
// log-sum for the backward.
//
// raster_bwd: the same grid, recomputing from the saved winner and log-sum.
// Each block sums its slots' gradients in shared memory: the winner path
// (attr and depth grads into the winner's attributes, depths and, through
// w_i = e_i / area, its vertices; area is a constant where it was clamped)
// by shared atomicAdd per pixel; the silhouette path ((1 - sil) sigmoid(z)
// through z = m |m| / (scale^2 sigma), m = min(e_i sgn / l_i), ties split
// equally at each of the two nested minima as torch.minimum does; the
// distances d_i are rounded as the plain version rounds them, (e_i / l_i)
// sgn, so the minimum and its ties are the plain version's) summed
// over a warp's 128 pixels before one shared atomicAdd per slot and
// coordinate. The block then adds each slot's sums to the face's vertices
// in [V, .] with one global atomicAdd per (slot, coordinate): no [F, 3, .]
// buffer and no separate scatter of the gathers.
//
// Bit-identical edge functions: the pixel coordinates, edge functions, the
// area, the barycentrics, the depth and the attribute interpolation are
// written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the plain
// version's order, so no multiply-add contraction moves a pixel's inside
// test or depth tie away from the plain PyTorch version. The forward's
// silhouette multiplies by the precomputed sign / length and folds
// 1 / scale^2 and 1 / sigma into one constant (a few ulps from the plain
// version's divisions); the backward divides by the length as the plain
// version does, since a minimum decided a few ulps apart sends a pair's
// whole gradient down another edge; log(1 + exp(-|z|)) runs on the SFU's
// exp and reciprocal with an atanh series (softplus_tail), a few ulps
// relative.
//
// What bounds it on the card: FP32 work, about 30 operations per
// (pixel, slot) pair forward and 60 backward, over the busy tiles' pixels
// times their face counts; device memory sees the face data and the
// images once.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kTile = 32;             // pixels per tile side
constexpr int kThreads = 256;         // 4 pixels per thread
constexpr int kPix = 4;
constexpr int kStage = 16;            // slots per cp.async stage
constexpr int kChunk = 256;           // faces per setup block / chunk box
constexpr float kBig = 1e9f;
constexpr int kMaxC = 16;

// slot data: 6 float4 per face, structure of arrays
enum { kA = 0, kB, kE, kF, kZ, kS, kFields };
//   kA (x0, y0, x1, y1)      vertices in pixels
//   kB (x2, y2, area, sgn)   area clamped to 1e-9 where |area| < 1e-9
//   kE (ex0, ey0, ex1, ey1)  v2 - v1, v0 - v2
//   kF (ex2, ey2, rej, clamped)  v1 - v0; -2e-6 |area| / min length
//   kZ (z0, z1, z2, 0)
//   kS (sgn / l0, sgn / l1, sgn / l2, 0)

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// the plain version's edge length: sqrt(dx^2 + dy^2 + 1e-12)
__device__ __forceinline__ float edge_len(float dx, float dy) {
  return __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), 1e-12f));
}

__device__ __forceinline__ int tile_of(float c, int tile, int n) {
  float t = floorf(__fdiv_rn(c, static_cast<float>(tile)));
  t = fminf(fmaxf(t, 0.f), static_cast<float>(n - 1));
  return static_cast<int>(t);
}

// log(1 + exp(-|z|)) to a few ulps, on the SFU: u = exp(-|z|) in (0, 1],
// log1p(u) = 2 atanh(t) with t = u / (2 + u) <= 1/3, by its odd series to
// t^13 (truncation below 1e-8 relative)
__device__ __forceinline__ float softplus_tail(float z) {
  const float u = __expf(-fabsf(z));
  const float t = __fdividef(u, 2.f + u);
  const float t2 = t * t;
  float r = 1.f / 13.f;
  r = fmaf(r, t2, 1.f / 11.f);
  r = fmaf(r, t2, 1.f / 9.f);
  r = fmaf(r, t2, 1.f / 7.f);
  r = fmaf(r, t2, 1.f / 5.f);
  r = fmaf(r, t2, 1.f / 3.f);
  r = fmaf(r, t2, 1.f);
  return 2.f * t * r;
}

__device__ __forceinline__ bool box_has(int4 b, int tx, int ty) {
  return b.x <= tx && tx <= b.y && b.z <= ty && ty <= b.w;
}

__global__ void __launch_bounds__(kChunk)
raster_setup_kernel(const float* __restrict__ ndc,
                    const long long* __restrict__ faces, int F, int H, int W,
                    int tile, int tiles_x, int tiles_y, int n_tiles,
                    float4* __restrict__ slot, int4* __restrict__ box,
                    int4* __restrict__ chunk_box, int* __restrict__ tile_done,
                    unsigned long long* __restrict__ overflow) {
  __shared__ int cb[4];
  if (threadIdx.x == 0) {
    cb[0] = INT_MAX; cb[1] = INT_MIN; cb[2] = INT_MAX; cb[3] = INT_MIN;
  }
  __syncthreads();
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f == 0) *overflow = 0ull;
  if (f < n_tiles) tile_done[f] = 0;
  if (f < F) {
    float x[3], y[3], z[3];
    for (int k = 0; k < 3; ++k) {
      const float* v = ndc + faces[3 * static_cast<size_t>(f) + k] * 3;
      x[k] = __fmul_rn(__fmul_rn(__fadd_rn(v[0], 1.f), 0.5f),
                       static_cast<float>(W));
      y[k] = __fmul_rn(__fmul_rn(__fadd_rn(v[1], 1.f), 0.5f),
                       static_cast<float>(H));
      z[k] = v[2];
    }
    const float x_lo = fminf(fminf(x[0], x[1]), x[2]);
    const float x_hi = fmaxf(fmaxf(x[0], x[1]), x[2]);
    const float y_lo = fminf(fminf(y[0], y[1]), y[2]);
    const float y_hi = fmaxf(fmaxf(y[0], y[1]), y[2]);
    const bool off = x_hi < 0.f || x_lo > static_cast<float>(W) ||
                     y_hi < 0.f || y_lo > static_cast<float>(H);
    int4 b = make_int4(1, 0, 1, 0);                  // empty
    if (!off) {
      b = make_int4(tile_of(x_lo, tile, tiles_x), tile_of(x_hi, tile, tiles_x),
                    tile_of(y_lo, tile, tiles_y), tile_of(y_hi, tile, tiles_y));
      atomicMin(&cb[0], b.x); atomicMax(&cb[1], b.y);
      atomicMin(&cb[2], b.z); atomicMax(&cb[3], b.w);
    }
    box[f] = b;

    const float ex0 = __fsub_rn(x[2], x[1]), ey0 = __fsub_rn(y[2], y[1]);
    const float ex1 = __fsub_rn(x[0], x[2]), ey1 = __fsub_rn(y[0], y[2]);
    const float ex2 = __fsub_rn(x[1], x[0]), ey2 = __fsub_rn(y[1], y[0]);
    // edge(v0, v1) at v2, as the plain version's area
    float area = __fsub_rn(__fmul_rn(ex2, __fsub_rn(y[2], y[0])),
                           __fmul_rn(ey2, __fsub_rn(x[2], x[0])));
    const bool clamped = fabsf(area) < 1e-9f;
    if (clamped) area = 1e-9f;
    const float sgn = sign_of(area);
    const float l0 = edge_len(ex0, ey0), l1 = edge_len(ex1, ey1),
                l2 = edge_len(ex2, ey2);
    const float rej = -2e-6f * fabsf(area) / fminf(fminf(l0, l1), l2);
    const size_t n = static_cast<size_t>(F);
    slot[kA * n + f] = make_float4(x[0], y[0], x[1], y[1]);
    slot[kB * n + f] = make_float4(x[2], y[2], area, sgn);
    slot[kE * n + f] = make_float4(ex0, ey0, ex1, ey1);
    slot[kF * n + f] = make_float4(ex2, ey2, rej, clamped ? 1.f : 0.f);
    slot[kZ * n + f] = make_float4(z[0], z[1], z[2], 0.f);
    slot[kS * n + f] = make_float4(__fdiv_rn(sgn, l0), __fdiv_rn(sgn, l1),
                                   __fdiv_rn(sgn, l2), 0.f);
  }
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x * kChunk < F) {
    chunk_box[blockIdx.x] = cb[0] <= cb[1]
        ? make_int4(cb[0], cb[1], cb[2], cb[3]) : make_int4(1, 0, 1, 0);
  }
}

// Exclusive rank of pred among the block's threads (in thread order) and
// the block's total; every thread of the block must call it.
__device__ __forceinline__ int block_rank(bool pred, int* warp_tot,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  if (lane == 0) warp_tot[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    const int c = warp_tot[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();                    // warp_tot is reused by the next call
  *total = all;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kThreads)
raster_bin_kernel(const int4* __restrict__ box,
                  const int4* __restrict__ chunk_box, int F, int n_chunks,
                  int tiles_x, int K, int* __restrict__ face_list,
                  int* __restrict__ counts,
                  unsigned long long* __restrict__ overflow) {
  __shared__ int chunks[kThreads];
  __shared__ int warp_tot[kThreads / 32];
  const int t = blockIdx.x;
  const int tx = t % tiles_x, ty = t / tiles_x;
  int* out = face_list + static_cast<size_t>(t) * K;
  int base = 0;                       // faces of the tile listed so far
  for (int c0 = 0; c0 < n_chunks; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    const bool hit = c < n_chunks && box_has(chunk_box[c], tx, ty);
    int n_hit;
    const int r = block_rank(hit, warp_tot, &n_hit);
    if (hit) chunks[r] = c;
    __syncthreads();
    for (int i = 0; i < n_hit; ++i) {
      const int f = chunks[i] * kChunk + threadIdx.x;
      const bool in = f < F && box_has(box[f], tx, ty);
      int n_in;
      const int rank = base + block_rank(in, warp_tot, &n_in);
      if (in && rank < K) out[rank] = f;
      base += n_in;
    }
    __syncthreads();                  // chunks is rewritten next round
  }
  for (int s = base + threadIdx.x; s < K; s += kThreads) out[s] = -1;
  if (threadIdx.x == 0) {
    counts[t] = min(base, K);
    if (base > K) atomicAdd(overflow, static_cast<unsigned long long>(base - K));
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The tile's pixels of this thread: column c, rows r + 8 k.
struct Pixels {
  int t, ox, oy, c, r;
  float px, py[kPix];
  __device__ Pixels(int tile_id, int tiles_x) {
    t = tile_id;
    ox = (t % tiles_x) * kTile;
    oy = (t / tiles_x) * kTile;
    c = threadIdx.x & 31;
    r = threadIdx.x >> 5;
    // pixel centres: (c + 0.5) + tile origin, as the plain version adds them
    px = __fadd_rn(static_cast<float>(c) + 0.5f, static_cast<float>(ox));
    for (int k = 0; k < kPix; ++k)
      py[k] = __fadd_rn(static_cast<float>(r + 8 * k) + 0.5f,
                        static_cast<float>(oy));
  }
  __device__ int row(int k) const { return r + 8 * k; }
  __device__ bool active(int k, int H, int W) const {
    return ox + c < W && oy + row(k) < H;
  }
  __device__ size_t image(int k, int W) const {
    return static_cast<size_t>(oy + row(k)) * W + ox + c;
  }
  __device__ int local(int k) const { return row(k) * kTile + c; }
};

// the edge functions of the three edges at (px, py); q_i = ey_i (px - a_x)
__device__ __forceinline__ void edges(float4 A, float4 B, float4 E,
                                      float4 Fv, float py, float q0,
                                      float q1, float q2, float* e) {
  e[0] = __fsub_rn(__fmul_rn(E.x, __fsub_rn(py, A.w)), q0);
  e[1] = __fsub_rn(__fmul_rn(E.z, __fsub_rn(py, B.y)), q1);
  e[2] = __fsub_rn(__fmul_rn(Fv.x, __fsub_rn(py, A.y)), q2);
}

__device__ __forceinline__ void x_terms(float4 A, float4 B, float4 E,
                                        float4 Fv, float px, float* q) {
  q[0] = __fmul_rn(E.y, __fsub_rn(px, A.z));
  q[1] = __fmul_rn(E.w, __fsub_rn(px, B.x));
  q[2] = __fmul_rn(Fv.y, __fsub_rn(px, A.x));
}

// The images of one pixel from its winner (slot or -1), depth and log-sum.
__device__ void finish_pixel(const Pixels& p, int k, int best, float bz,
                             float lsum, const int* __restrict__ list,
                             const float4* __restrict__ slot, size_t F,
                             const long long* __restrict__ faces,
                             const float* __restrict__ attrs, int C, int W,
                             float* out_attr, float* out_depth,
                             float* out_mask, float* out_sil,
                             long long* out_p2f, int* out_win,
                             float* out_logsum) {
  const size_t o = p.image(k, W);
  if (best >= 0) {
    const int f = list[best];
    const float4 A = slot[kA * F + f], B = slot[kB * F + f],
                 E = slot[kE * F + f], Fv = slot[kF * F + f];
    float q[3], e[3];
    x_terms(A, B, E, Fv, p.px, q);
    edges(A, B, E, Fv, p.py[k], q[0], q[1], q[2], e);
    const float w0 = __fdiv_rn(e[0], B.z), w1 = __fdiv_rn(e[1], B.z),
                w2 = __fdiv_rn(e[2], B.z);
    const long long* fv = faces + 3 * static_cast<size_t>(f);
    const float* a0 = attrs + fv[0] * C;
    const float* a1 = attrs + fv[1] * C;
    const float* a2 = attrs + fv[2] * C;
    for (int c = 0; c < C; ++c) {
      out_attr[o * C + c] = __fadd_rn(
          __fadd_rn(__fmul_rn(w0, a0[c]), __fmul_rn(w1, a1[c])),
          __fmul_rn(w2, a2[c]));
    }
    out_p2f[o] = f;
  } else {
    for (int c = 0; c < C; ++c) out_attr[o * C + c] = 0.f;
    out_p2f[o] = -1;
  }
  out_depth[o] = bz;
  out_mask[o] = best >= 0 ? 1.f : 0.f;
  out_sil[o] = -expm1f(lsum);
  out_win[o] = best;
  out_logsum[o] = lsum;
}

__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const int* __restrict__ face_list,
                  const int* __restrict__ counts,
                  const float4* __restrict__ slot, int F,
                  const long long* __restrict__ faces,
                  const float* __restrict__ attrs, int K, int R, int S,
                  int C, int H, int W, int tiles_x, float kz,
                  float* __restrict__ part_depth, int* __restrict__ part_win,
                  float* __restrict__ part_lsum, int* __restrict__ tile_done,
                  float* __restrict__ out_attr, float* __restrict__ out_depth,
                  float* __restrict__ out_mask, float* __restrict__ out_sil,
                  long long* __restrict__ out_p2f, int* __restrict__ out_win,
                  float* __restrict__ out_logsum) {
  __shared__ float4 sh[2][kFields][kStage];
  __shared__ int last;
  const Pixels p(blockIdx.x, tiles_x);
  const int count = counts[p.t];
  const int n_split = (count + R - 1) / R;          // blocks of this tile
  const int s = blockIdx.y;
  const int* list = face_list + static_cast<size_t>(p.t) * K;
  const size_t nF = static_cast<size_t>(F);
  if (count == 0) {                                 // background
    if (s == 0)
      for (int k = 0; k < kPix; ++k)
        if (p.active(k, H, W))
          finish_pixel(p, k, -1, kBig, 0.f, list, slot, nF, faces, attrs, C,
                       W, out_attr, out_depth, out_mask, out_sil, out_p2f,
                       out_win, out_logsum);
    return;
  }
  if (s >= n_split) return;
  const int lo = s * R, n = min(R, count - lo);
  const int n_stage = (n + kStage - 1) / kStage;

  auto stage_in = [&](int st) {
    const int i = threadIdx.x;
    if (i < kFields * kStage) {
      const int field = i / kStage, j = i % kStage;
      const int sl = lo + st * kStage + j;
      if (st * kStage + j < n) {
        const int f = list[sl];
        cp_async16(&sh[st & 1][field][j], slot + field * nF + f);
      }
    }
    cp_async_commit();
  };

  int best[kPix];
  float bz[kPix], lsum[kPix];
  for (int k = 0; k < kPix; ++k) {
    best[k] = -1; bz[k] = kBig; lsum[k] = 0.f;
  }
  stage_in(0);
  for (int st = 0; st < n_stage; ++st) {
    if (st + 1 < n_stage) {
      stage_in(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int m = min(kStage, n - st * kStage);
    const int b = st & 1;
    for (int j = 0; j < m; ++j) {
      const float4 A = sh[b][kA][j], B = sh[b][kB][j], E = sh[b][kE][j],
                   Fv = sh[b][kF][j], Sg = sh[b][kS][j];
      const int sl = lo + st * kStage + j;
      float q[3];
      x_terms(A, B, E, Fv, p.px, q);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        float e[3];
        edges(A, B, E, Fv, p.py[k], q[0], q[1], q[2], e);
        const float mn = fminf(fminf(__fmul_rn(e[0], Sg.x),
                                     __fmul_rn(e[1], Sg.y)),
                               __fmul_rn(e[2], Sg.z));
        if (mn >= Fv.z) {             // may be inside: the exact test
          const float w0 = __fdiv_rn(e[0], B.z), w1 = __fdiv_rn(e[1], B.z),
                      w2 = __fdiv_rn(e[2], B.z);
          if (w0 >= -1e-6f && w1 >= -1e-6f && w2 >= -1e-6f) {
            const float4 Z = sh[b][kZ][j];
            const float zp = __fadd_rn(
                __fadd_rn(__fmul_rn(w0, Z.x), __fmul_rn(w1, Z.y)),
                __fmul_rn(w2, Z.z));
            if (zp < bz[k]) {
              bz[k] = zp;
              best[k] = sl;
            }
          }
        }
        const float z = __fmul_rn(__fmul_rn(mn, fabsf(mn)), kz);
        // log(1 - sigmoid(z)) = -logaddexp(z, 0)
        lsum[k] -= fmaxf(z, 0.f) + softplus_tail(z);
      }
    }
    __syncthreads();                  // the buffer is refilled next stage
  }

  if (n_split > 1) {
    const size_t base = (static_cast<size_t>(p.t) * S + s) * kTile * kTile;
    for (int k = 0; k < kPix; ++k) {
      part_depth[base + p.local(k)] = bz[k];
      part_win[base + p.local(k)] = best[k];
      part_lsum[base + p.local(k)] = lsum[k];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(tile_done + p.t, 1) == n_split - 1;
      if (last) tile_done[p.t] = 0;   // every split has counted: reusable
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int k = 0; k < kPix; ++k) {
      best[k] = -1; bz[k] = kBig; lsum[k] = 0.f;
      for (int q = 0; q < n_split; ++q) {       // in slot order
        const size_t i = (static_cast<size_t>(p.t) * S + q) * kTile * kTile +
                         p.local(k);
        const float d = __ldcg(part_depth + i);
        if (d < bz[k]) {
          bz[k] = d;
          best[k] = __ldcg(part_win + i);
        }
        lsum[k] += __ldcg(part_lsum + i);
      }
    }
  }
  for (int k = 0; k < kPix; ++k)
    if (p.active(k, H, W))
      finish_pixel(p, k, best[k], bz[k], lsum[k], list, slot, nF, faces,
                   attrs, C, W, out_attr, out_depth, out_mask, out_sil,
                   out_p2f, out_win, out_logsum);
}

// A slot of the backward, in shared memory.
struct BSlot {
  float x[3], y[3];
  float ex[3], ey[3];                 // edge j runs from (j + 1) % 3 to (j + 2) % 3
  float z[3], il2[3], s[3];           // 1 / l^2, s = sgn / l
  float l[3];                         // edge lengths, as the plain version's
  float area, sgn;
  int clamped;
  int face;
};

// g * d(edge(a, b, p)) into the six vertex coordinates gv of the face
__device__ __forceinline__ void add_edge_grad(float g, int ia, int ib,
                                              float ax, float ay, float bx,
                                              float by, float px, float py,
                                              float* gv) {
  gv[2 * ia + 0] += g * (by - py);
  gv[2 * ia + 1] += g * (px - bx);
  gv[2 * ib + 0] += g * (py - ay);
  gv[2 * ib + 1] += g * (ax - px);
}

// The silhouette grad gc of one edge's distance d = e s (s = sgn / l) into
// the edge's two vertices a, b: through the edge function e and through
// the length l = |b - a| (dd/dl = -d / l)
__device__ __forceinline__ void sil_edge_grad(float gc, float s, float d,
                                              float il2, float ex, float ey,
                                              float ax, float ay, float bx,
                                              float by, float px, float py,
                                              float& gax, float& gay,
                                              float& gbx, float& gby) {
  const float g = gc * s, gl = -gc * d * il2;
  gax += g * (by - py) - gl * ex;
  gay += g * (px - bx) - gl * ey;
  gbx += g * (py - ay) + gl * ex;
  gby += g * (ax - px) + gl * ey;
}

__global__ void __launch_bounds__(kThreads)
raster_bwd_kernel(const int* __restrict__ face_list,
                  const int* __restrict__ counts,
                  const float4* __restrict__ slot, int F,
                  const long long* __restrict__ faces,
                  const float* __restrict__ attrs, int K, int R, int C,
                  int H, int W, int tiles_x, float kz,
                  const float* __restrict__ g_attr,
                  const float* __restrict__ g_depth,
                  const float* __restrict__ g_sil,
                  const int* __restrict__ win,
                  const float* __restrict__ logsum,
                  float* __restrict__ g_verts, float* __restrict__ g_attrs) {
  extern __shared__ float smem[];
  const Pixels p(blockIdx.x, tiles_x);
  const int count = counts[p.t];
  const int lo = blockIdx.y * R;
  if (lo >= count) return;
  const int n = min(R, count - lo);
  const int n_acc = 9 + 3 * C;        // xy (6), z (3), attr (3 C) per slot
  BSlot* sl = reinterpret_cast<BSlot*>(smem);
  float* acc = reinterpret_cast<float*>(sl + R);
  const int* list = face_list + static_cast<size_t>(p.t) * K;
  const size_t nF = static_cast<size_t>(F);

  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int f = list[lo + j];
    const float4 A = slot[kA * nF + f], B = slot[kB * nF + f],
                 E = slot[kE * nF + f], Fv = slot[kF * nF + f],
                 Z = slot[kZ * nF + f], Sg = slot[kS * nF + f];
    BSlot q;
    q.x[0] = A.x; q.y[0] = A.y; q.x[1] = A.z; q.y[1] = A.w;
    q.x[2] = B.x; q.y[2] = B.y;
    q.ex[0] = E.x; q.ey[0] = E.y; q.ex[1] = E.z; q.ey[1] = E.w;
    q.ex[2] = Fv.x; q.ey[2] = Fv.y;
    q.z[0] = Z.x; q.z[1] = Z.y; q.z[2] = Z.z;
    q.s[0] = Sg.x; q.s[1] = Sg.y; q.s[2] = Sg.z;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      q.l[i] = edge_len(q.ex[i], q.ey[i]);
      q.il2[i] = 1.f / (q.l[i] * q.l[i]);
    }
    q.area = B.z;
    q.sgn = B.w;
    q.clamped = Fv.w != 0.f;
    q.face = f;
    sl[j] = q;
  }
  for (int i = threadIdx.x; i < n * n_acc; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  // the winner path: pixels whose winning slot is one of this block's
  if (g_attr != nullptr || g_depth != nullptr) {
    for (int k = 0; k < kPix; ++k) {
      if (!p.active(k, H, W)) continue;
      const size_t o = p.image(k, W);
      const int j = win[o] - lo;
      if (j < 0 || j >= n) continue;
      const BSlot& q = sl[j];
      float* a = acc + j * n_acc;
      float e[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int ia = (i + 1) % 3;
        e[i] = __fsub_rn(__fmul_rn(q.ex[i], __fsub_rn(p.py[k], q.y[ia])),
                         __fmul_rn(q.ey[i], __fsub_rn(p.px, q.x[ia])));
      }
      const float w[3] = {__fdiv_rn(e[0], q.area), __fdiv_rn(e[1], q.area),
                          __fdiv_rn(e[2], q.area)};
      const float gd = g_depth != nullptr ? g_depth[o] : 0.f;
      float G[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        G[i] = gd * q.z[i];
        if (gd != 0.f) atomicAdd(a + 6 + i, gd * w[i]);
      }
      if (g_attr != nullptr) {
        const long long* fv = faces + 3 * static_cast<size_t>(q.face);
        for (int c = 0; c < C; ++c) {
          const float ga = g_attr[o * C + c];
          if (ga == 0.f) continue;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            G[i] += ga * attrs[fv[i] * C + c];
            atomicAdd(a + 9 + i * C + c, ga * w[i]);
          }
        }
      }
      // w_i = e_i / area
      float gv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int ia = (i + 1) % 3, ib = (i + 2) % 3;
        add_edge_grad(G[i] / q.area, ia, ib, q.x[ia], q.y[ia], q.x[ib],
                      q.y[ib], p.px, p.py[k], gv);
      }
      if (!q.clamped) {
        // area = edge(v0, v1) at v2
        const float ga = -(G[0] * w[0] + G[1] * w[1] + G[2] * w[2]) / q.area;
        add_edge_grad(ga, 0, 1, q.x[0], q.y[0], q.x[1], q.y[1], q.x[2],
                      q.y[2], gv);
        gv[4] += ga * (q.y[0] - q.y[1]);
        gv[5] += ga * (q.x[1] - q.x[0]);
      }
#pragma unroll
      for (int i = 0; i < 6; ++i)
        if (gv[i] != 0.f) atomicAdd(a + i, gv[i]);
    }
  }

  if (g_sil != nullptr) {             // uniform over the grid
    // d sil / d z_s = (1 - sil) sigmoid(z_s), 1 - sil = exp(log-sum)
    float gs[kPix];
    for (int k = 0; k < kPix; ++k) {
      const size_t o = p.image(k, W);
      gs[k] = p.active(k, H, W) ? g_sil[o] * expf(logsum[o]) : 0.f;
    }
    const unsigned full = 0xffffffffu;
    for (int j = 0; j < n; ++j) {
      const BSlot& q = sl[j];
      const float x0 = q.x[0], y0 = q.y[0], x1 = q.x[1], y1 = q.y[1],
                  x2 = q.x[2], y2 = q.y[2];
      const float q0 = __fmul_rn(q.ey[0], __fsub_rn(p.px, x1)),
                  q1 = __fmul_rn(q.ey[1], __fsub_rn(p.px, x2)),
                  q2 = __fmul_rn(q.ey[2], __fsub_rn(p.px, x0));
      float gv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (gs[k] != 0.f) {
          const float py = p.py[k];
          // d_i = (e_i / l_i) sgn, rounded as the plain version rounds it:
          // which edge is the minimum, and where two tie, decides the
          // gradient's path, so it must be decided on the same floats
          const float d0 = __fmul_rn(__fdiv_rn(__fsub_rn(
              __fmul_rn(q.ex[0], __fsub_rn(py, y1)), q0), q.l[0]), q.sgn);
          const float d1 = __fmul_rn(__fdiv_rn(__fsub_rn(
              __fmul_rn(q.ex[1], __fsub_rn(py, y2)), q1), q.l[1]), q.sgn);
          const float d2 = __fmul_rn(__fdiv_rn(__fsub_rn(
              __fmul_rn(q.ex[2], __fsub_rn(py, y0)), q2), q.l[2]), q.sgn);
          const float m1 = fminf(d0, d1);
          const float mn = fminf(m1, d2);
          const float z = __fmul_rn(__fmul_rn(mn, fabsf(mn)), kz);
          const float sig = __frcp_rn(1.f + __expf(-z));
          // dz/dm = 2 |m| kz; ties split in half at each nested minimum
          const float gmin = gs[k] * sig * 2.f * fabsf(mn) * kz;
          const float cm1 = m1 < d2 ? 1.f : (m1 == d2 ? 0.5f : 0.f);
          const float cc = d2 < m1 ? 1.f : (m1 == d2 ? 0.5f : 0.f);
          const float ca = d0 < d1 ? 1.f : (d0 == d1 ? 0.5f : 0.f);
          const float cb = d1 < d0 ? 1.f : (d0 == d1 ? 0.5f : 0.f);
          // edge i runs from vertex (i + 1) % 3 to (i + 2) % 3
          sil_edge_grad(gmin * cm1 * ca, q.s[0], d0, q.il2[0], q.ex[0],
                        q.ey[0], x1, y1, x2, y2, p.px, py, gv[2], gv[3],
                        gv[4], gv[5]);
          sil_edge_grad(gmin * cm1 * cb, q.s[1], d1, q.il2[1], q.ex[1],
                        q.ey[1], x2, y2, x0, y0, p.px, py, gv[4], gv[5],
                        gv[0], gv[1]);
          sil_edge_grad(gmin * cc, q.s[2], d2, q.il2[2], q.ex[2], q.ey[2],
                        x0, y0, x1, y1, p.px, py, gv[0], gv[1], gv[2],
                        gv[3]);
        }
      }
      bool any = false;
#pragma unroll
      for (int i = 0; i < 6; ++i) any |= gv[i] != 0.f;
      if (!__any_sync(full, any)) continue;       // uniform over the warp
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float v = gv[i];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(full, v, off);
        gv[i] = v;
      }
      if ((threadIdx.x & 31) == 0)
#pragma unroll
        for (int i = 0; i < 6; ++i)
          if (gv[i] != 0.f) atomicAdd(acc + j * n_acc + i, gv[i]);
    }
  }
  __syncthreads();

  // one global atomicAdd per (slot, coordinate), into [V, .]; pixel
  // coordinates are (ndc + 1) * 0.5 * W (x) and * H (y)
  const float sx = 0.5f * static_cast<float>(W),
              sy = 0.5f * static_cast<float>(H);
  for (int i = threadIdx.x; i < n * n_acc; i += kThreads) {
    const float v = acc[i];
    if (v == 0.f) continue;
    const int j = i / n_acc, c = i % n_acc;
    const long long* fv = faces + 3 * static_cast<size_t>(sl[j].face);
    if (c < 6) {
      atomicAdd(g_verts + fv[c >> 1] * 3 + (c & 1), v * ((c & 1) ? sy : sx));
    } else if (c < 9) {
      atomicAdd(g_verts + fv[c - 6] * 3 + 2, v);
    } else {
      const int vi = (c - 9) / C, ch = (c - 9) % C;
      atomicAdd(g_attrs + fv[vi] * C + ch, v);
    }
  }
}

size_t bwd_smem(int R, int C) {
  return static_cast<size_t>(R) * (sizeof(BSlot) + (9 + 3 * C) * sizeof(float));
}

}  // namespace

extern "C" {

// ndc [V, 3] f32, faces [F, 3] int64 (vertex ids), on the device. Writes
// slot [6, F] float4, box [F] int4 and chunk_box [ceil(F / 256)] int4, and
// zeroes tile_done [n_tiles] and overflow. Returns a cudaError_t.
int icon_raster_setup(const float* ndc, const long long* faces, int F, int H,
                      int W, float4* slot, int4* box, int4* chunk_box,
                      int* tile_done, unsigned long long* overflow,
                      void* stream) {
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const int n_tiles = tiles_x * tiles_y;
  if (F < 0 || H < 1 || W < 1 || n_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = max(1, (max(F, n_tiles) + kChunk - 1) / kChunk);
  raster_setup_kernel<<<blocks, kChunk, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      ndc, faces, F, H, W, kTile, tiles_x, tiles_y, n_tiles, slot, box,
      chunk_box, tile_done, overflow);
  return static_cast<int>(cudaGetLastError());
}

// The setup's boxes -> face_list [n_tiles, K] int32 (-1 padded), counts
// [n_tiles] int32, and the dropped pairs added to overflow. Returns a
// cudaError_t.
int icon_raster_bin(const int4* box, const int4* chunk_box, int F, int H,
                    int W, int K, int* face_list, int* counts,
                    unsigned long long* overflow, void* stream) {
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const int n_tiles = tiles_x * tiles_y;
  if (F < 0 || H < 1 || W < 1 || K < 1 || n_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  raster_bin_kernel<<<n_tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      box, chunk_box, F, (F + kChunk - 1) / kChunk, tiles_x, K, face_list,
      counts, overflow);
  return static_cast<int>(cudaGetLastError());
}

// The raster step's forward over the binned slots: S blocks per tile, each
// taking R slots (R a multiple of 32); part_* [n_tiles, S, 1024] scratch
// (unused when S == 1). Writes attr [H, W, C], depth, mask, sil [H, W] f32,
// p2f [H, W] int64, win [H, W] int32 (the winning slot) and logsum [H, W]
// f32. kz = 1 / (scale^2 sigma). Returns a cudaError_t.
int icon_raster_fwd(const int* face_list, const int* counts,
                    const float4* slot, int F, const long long* faces,
                    const float* attrs, int K, int R, int S, int C, int H,
                    int W, float kz, float* part_depth, int* part_win,
                    float* part_lsum, int* tile_done, float* out_attr,
                    float* out_depth, float* out_mask, float* out_sil,
                    long long* out_p2f, int* out_win, float* out_logsum,
                    void* stream) {
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles > 65535 || K < 1 || R < 1 || R % kStage || S < 1 ||
      S * R < K || C < 1 || C > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  raster_fwd_kernel<<<dim3(n_tiles, S), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      face_list, counts, slot, F, faces, attrs, K, R, S, C, H, W, tiles_x, kz,
      part_depth, part_win, part_lsum, tile_done, out_attr, out_depth,
      out_mask, out_sil, out_p2f, out_win, out_logsum);
  return static_cast<int>(cudaGetLastError());
}

// The backward of icon_raster_fwd: g_attr [H, W, C], g_depth and g_sil
// [H, W] (each may be null: no grad), win and logsum as the forward wrote
// them. Adds into g_verts [V, 3] (the ndc coordinates) and g_attrs [V, C],
// which the caller zeroes. Returns a cudaError_t.
int icon_raster_bwd(const int* face_list, const int* counts,
                    const float4* slot, int F, const long long* faces,
                    const float* attrs, int K, int R, int S, int C, int H,
                    int W, float kz, const float* g_attr,
                    const float* g_depth, const float* g_sil, const int* win,
                    const float* logsum, float* g_verts, float* g_attrs,
                    void* stream) {
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles > 65535 || K < 1 || R < 1 || S < 1 || S * R < K || C < 1 ||
      C > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(R, C);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  raster_bwd_kernel<<<dim3(n_tiles, S), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      face_list, counts, slot, F, faces, attrs, K, R, C, H, W, tiles_x, kz,
      g_attr, g_depth, g_sil, win, logsum, g_verts, g_attrs);
  return static_cast<int>(cudaGetLastError());
}

const char* icon_raster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
