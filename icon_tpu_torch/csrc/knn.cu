// Exact k-nearest body vertices per query point, for sm_90a: the ranking
// key's product on the tensor cores as a filter, an exact float32 rescoring
// of the few pairs that pass it, and the top-k kept in registers.
//
// Replaces icon_tpu/ops/pallas/knn.py:_knn_kernel (:60, launched by
// nearest_vertices_pallas). That kernel keeps one (min, argmin) per
// 512-vertex tile and then retires the best k tiles, so two true neighbours
// in one tile collide (the approx_max_k class). This kernel computes the
// function exactly: every point gets its k best (key, index) pairs in
// lexicographic order, so exact key ties go to the lowest vertex index
// (the mirror-symmetric body ties exactly on its symmetry plane).
//
// Ranking key of point p and vertex v: |v|^2 - 2 p.v (the |p|^2 term is
// constant per point and dropped, as in the JAX package), in float32 as
//   w   = (x*x + y*y) + z*z                  (each step rounded)
//   key = w + fma(pz, -2z, fma(py, -2y, px * -2x))
// which is fma(-2, px*x + py*y + pz*z, w) bit for bit (scaling by -2 is
// exact), the order the scalar kernel before it compiled its chain to,
// and the plain version's `vn - 2 * (p @ v.T)` with its products summed in
// order.
//
// Design. The key is a dot product of A = [px, py, pz, 1] and
// B = [-2x, -2y, -2z, w]. Each operand is split into TF32 parts, a = ah +
// al, and three mma.sync.m16n8k4 (ah.bl, al.bh, ah.bh, in that order)
// give 128 filter keys k_tc (16 points x 8 vertices). A block of 8 warps
// takes 128 * MT points (16 * MT per warp; MT falls for small N so that
// the card gets two blocks per SM, and for large k to keep the lists in
// registers) and streams the vertices through shared memory in stages of
// 512, copied from [V, 3] with cp.async into a 2-deep ring while the warps
// work on the stage before; each stage is turned in shared memory into
// the TF32 parts of B and the exact [-2x, -2y, -2z, w] for rescoring.
// In the accumulator layout a lane holds rows g and g + 8 and columns
// 2t, 2t + 1 of each n8 tile (g = lane / 4, t = lane % 4), so each lane
// keeps its own (key, index)-sorted k-list per row over a quarter of the
// columns; at the end the four lists of a row (one quad) are merged by
// shuffles, again by (key, index).
//   Two walks. The seed pass takes every 8th n8 tile (gathered into full
// stages) and keeps, without branches, each lane's ceil(k/4) least filter
// keys per row; the k-th least of them over the quad, plus the largest
// margin met, bounds the row's k-th exact key before the exact pass
// starts, so its lists do not warm up from +inf (tens of insertions a
// row, each one a divergent branch). The exact pass walks
// every tile: per tile the MT x 3 MMAs, then per row pair one compare of
// the least filter key with the row's threshold, no branch taken in the
// common case; a lane whose rows pass queues the tile (its index and a bit
// per row) in shared memory, and the queue is rescored at the end of the
// stage (or when a lane's six slots fill): each queued column of each
// flagged row in float32 by the chain above, inserted by (key, index).
// The thresholds are shared over the quad after each rescore.
//
// Why the outputs are exact. The filter key is only a filter. With
// T = 2 (|px x| + |py y| + |pz z|) + w,
//   |k_tc - key| <= margin(p, v) = C * T + A_ABS,  C = 2^-15, A_ABS = 2^-96.
// Splitting by truncation (the worse case; cvt.rna halves each term) leaves
// |a - ah| < 2^-10 |a| and a residual under 2^-20 |a|, so the dropped
// terms ah.eb + al.bl + al.eb + ea.b stay under (3 * 2^-20 + 2^-30) |a b|
// per product (2^-20 w for the w term, whose A factor 1 is exact);
// products of TF32 values are exact in float32, and three MMAs that each
// sum five terms (aligned to the largest and truncated, even) add at most
// 36 * 2^-23 T; the rescoring chain's own four roundings add 2^-22 T. That
// is under 7.5e-6 T, against C = 3.05e-5. A_ABS covers subnormal parts
// flushed to zero for coordinates below 2^20 in magnitude. So a pair whose
// k_tc exceeds a row's threshold, which is at least the row's k-th exact
// key plus the margin, has an exact key above that k-th key and cannot be
// among the row's k (the thresholds only fall). The kernel bounds the
// margin per row and stage from above, rounding every step up:
// C * (2 |p| R + W) + A_ABS with W the largest upward-rounded |v|^2 of the
// stage and R = sqrt(W), since |px x| + |py y| + |pz z| <= |p| |v|
// (Cauchy-Schwarz). kernels/knn.py:key_margin restates margin(p, v); the
// CPU tests hold emulated split TF32 keys to it.
//
// What bounds it on the card: the larger of its bytes over 3.35 TB/s, its
// 8 N V flops over the tensor cores' 495 TF32 TFLOP/s and its N V
// compares over 33.5 T float32 instructions/s; the compares bound it: at
// N = 232,974, V = 10,242 about 0.071 ms. Device memory holds only the
// points, the vertices and the [N, k] outputs.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 512;       // vertices per shared-memory stage
constexpr int kRing = 2;          // cp.async stages: one lands, one is used
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQueue = 6;         // queued tiles per lane before a rescore
constexpr int kSeedStride = 8;    // the seed pass takes every 8th n8 tile
// margin(p, v) = kMarginC * T + kMarginAbs (see the note above;
// kernels/knn.py:MARGIN_C and MARGIN_ABS restate them)
constexpr float kMarginC = 0x1.0p-15f;
constexpr float kMarginAbs = 0x1.0p-96f;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += A (16 x 4, rows g and g + 8, column t) x B (4 x 8, row t, column g);
// c holds rows g, g + 8 by columns 2t, 2t + 1
__device__ __forceinline__ void mma_tf32(uint32_t a0, uint32_t a1,
                                         uint32_t b, float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// 128 filter keys of the split operands: ah.bl + al.bh + ah.bh
__device__ __forceinline__ void split_keys(const uint32_t (&ah)[2],
                                           const uint32_t (&al)[2],
                                           uint32_t bh, uint32_t bl,
                                           float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  mma_tf32(ah[0], ah[1], bl, c);
  mma_tf32(al[0], al[1], bh, c);
  mma_tf32(ah[0], ah[1], bh, c);
}

// each row's threshold: the least over its quad (every lane's k-th exact
// key bounds the row's k-th from above)
template <int R>
__device__ __forceinline__ void share_lim(float (&lim)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lim[r] = fminf(lim[r], __shfl_xor_sync(kFull, lim[r], 1));
    lim[r] = fminf(lim[r], __shfl_xor_sync(kFull, lim[r], 2));
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// a value the compiler must keep in a register and may not recompute
__device__ __forceinline__ uint32_t pinned(uint32_t x) {
  uint32_t y;
  asm volatile("mov.u32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// one 32-bit word of shared memory at a 32-bit shared address
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(x) : "r"(addr));
  return x;
}

__device__ __forceinline__ bool before(float d, int j, float e, int i) {
  return d < e || (d == e && j < i);
}

// insert (d, j) into the (key, index)-sorted list, dropping the last
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int j) {
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    if (before(d, j, bd[s], bi[s])) {
      if (s > 0 && before(d, j, bd[s - 1], bi[s - 1])) {
        bd[s] = bd[s - 1];
        bi[s] = bi[s - 1];
      } else {
        bd[s] = d;
        bi[s] = j;
      }
    }
  }
}

// the J least of a lane's seed keys, kept sorted without branches
template <int J>
__device__ __forceinline__ void seed_keys(float (&sk)[J], float c) {
#pragma unroll
  for (int q = 0; q < J; ++q) {
    const float lo = fminf(sk[q], c);
    c = fmaxf(sk[q], c);
    sk[q] = lo;
  }
}

// every lane of a quad ends with the best k of its four (key,
// index)-sorted lists; entries that two lanes both hold (after the seed)
// count once
template <int K>
__device__ __forceinline__ void merge_quad(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
  for (int step = 1; step <= 2; step <<= 1) {
    float od[K];
    int oi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      od[s] = __shfl_xor_sync(kFull, bd[s], step);
      oi[s] = __shfl_xor_sync(kFull, bi[s], step);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bool held = false;
#pragma unroll
      for (int q = 0; q < K; ++q) held |= bi[q] == oi[s];
      if (!held) insert<K>(bd, bi, od[s], oi[s]);
    }
  }
}

template <int K, int MT>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
           int n, int v, int* __restrict__ out_idx,
           float* __restrict__ out_d2) {
  constexpr int kRows = 16 * MT;               // points per warp
  constexpr int R = 2 * MT;                    // rows per lane
  constexpr int J = (K + 3) / 4;               // seed keys per lane and row
  __shared__ float raw[kRing][3 * kStage];     // [x, y, z] as in device memory
  __shared__ float4 bex[kStage];               // exact [-2x, -2y, -2z, w]
  __shared__ uint4 btf[kStage];                // its TF32 part
  __shared__ uint4 btl[kStage];                // and the TF32 remainder
  __shared__ float sp[kWarps][kRows][3];       // the warp's points
  __shared__ unsigned wred[kWarps];
  // per lane, the n8 tiles of this stage with rows to rescore: the tile in
  // the low byte, a bit per row (2 * m + h) above it
  __shared__ uint16_t queue[kWarps][kQueue][32];
  // the seed pass's bound on each row's k-th exact key (one per quad)
  __shared__ float sbase[kWarps][8][R];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x * kWarps + warp) * kRows;
  const int n_stages = (v + kStage - 1) / kStage;
  // the seed pass walks every kSeedStride-th n8 tile, gathered into stages
  const int n_seeded = ((v + 7) / 8 + kSeedStride - 1) / kSeedStride;
  const int n_seed = (n_seeded + kStage / 8 - 1) / (kStage / 8);
  const int n_walk = n_seed + n_stages;
  // vertex of column c of logical stage ls (either pass)
  auto vertex = [&](int ls, int c) {
    return ls < n_seed
               ? 8 * kSeedStride * ((kStage / 8) * ls + (c >> 3)) + (c & 7)
               : (ls - n_seed) * kStage + c;
  };

  // two walks over the vertices: the seed pass, then the exact pass
  auto issue = [&](int ls) {
    if (ls < n_walk) {
      for (int e = threadIdx.x; e < 3 * kStage; e += kThreads) {
        const int u = vertex(ls, e / 3);
        const bool ok = u < v;
        cp_async4(&raw[ls % kRing][e], verts + (ok ? 3 * u + e % 3 : 0), ok);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);

  for (int e = lane; e < 3 * kRows; e += 32) {
    const int i = 3 * row0 + e;
    sp[warp][e / 3][e % 3] = i < 3 * n ? pts[i] : 0.f;
  }
  __syncwarp();
  auto point = [&](int row) {
    return make_float3(sp[warp][row][0], sp[warp][row][1], sp[warp][row][2]);
  };

  // A fragments (column t of rows g and g + 8), split into TF32 parts
  uint32_t a[MT][2], al[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float3 p = point(16 * m + 8 * h + g);
      const float c = t == 0 ? p.x : t == 1 ? p.y : t == 2 ? p.z : 1.f;
      a[m][h] = to_tf32(c);
      al[m][h] = to_tf32(c - __uint_as_float(a[m][h]));
    }
  }

  // seed pass: each lane's J least filter keys per row (branch-free), and
  // the largest margin met; exact pass: the (key, index)-sorted lists
  float sk[R][J], mmax[R];
  float bd[R][K], lim[R], mr[R];
  int bi[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mmax[r] = 0.f;
#pragma unroll
    for (int q = 0; q < J; ++q) sk[r][q] = CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[r][s] = CUDART_INF_F;
      bi[r][s] = 0x7fffffff;
    }
  }
  uint16_t* my_queue = &queue[warp][0][lane];
  // this lane's B word of n8 tile 0 (column g, row t); tile nt is 128 B on
  const uint32_t b_addr = pinned(static_cast<uint32_t>(
      __cvta_generic_to_shared(reinterpret_cast<const uint32_t*>(btf) +
                               4 * g + t)));
  const uint32_t bl_addr = pinned(static_cast<uint32_t>(
      __cvta_generic_to_shared(reinterpret_cast<const uint32_t*>(btl) +
                               4 * g + t)));

  // rescore the queued tiles' columns of each row exactly, insert by
  // (key, index), and lower the rows' thresholds over the quad
  int n_queued = 0;
  auto rescore = [&](int t0) {
    for (int qi = 0; qi < n_queued; ++qi) {
      const unsigned e = my_queue[32 * qi];
      const int col = 8 * (e & 0xffu) + 2 * t;
      const float4 q0 = bex[col], q1 = bex[col + 1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!((e >> (8 + r)) & 1u)) continue;
        const float3 p = point(16 * (r >> 1) + 8 * (r & 1) + g);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 q = h ? q1 : q0;
          const int j = t0 + col + h;
          const float d = __fadd_rn(
              q.w, __fmaf_rn(p.z, q.z,
                             __fmaf_rn(p.y, q.y, __fmul_rn(p.x, q.x))));
          if (j < v && before(d, j, bd[r][K - 1], bi[r][K - 1]))
            insert<K>(bd[r], bi[r], d, j);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      lim[r] = fminf(lim[r], __fadd_ru(bd[r][K - 1], mr[r]));
    share_lim<R>(lim);
    n_queued = 0;
  };

  for (int ls = 0; ls < n_walk; ++ls) {
    const bool seed = ls < n_seed;
    const int s = seed ? ls : ls - n_seed;
    asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 2) : "memory");
    __syncthreads();                 // stage s landed; the last one is used
    issue(ls + kRing - 1);

    // B operand of this stage, and the largest |v|^2 rounded up
    const float* rs = raw[ls % kRing];
    unsigned wmax = 0;
    for (int c = threadIdx.x; c < kStage; c += kThreads) {
      const float x = rs[3 * c], y = rs[3 * c + 1], z = rs[3 * c + 2];
      const float w = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                __fmul_rn(z, z));
      const float4 q = make_float4(-2.f * x, -2.f * y, -2.f * z, w);
      bex[c] = q;
      const uint4 hi = make_uint4(to_tf32(q.x), to_tf32(q.y), to_tf32(q.z),
                                  to_tf32(q.w));
      btf[c] = hi;
      btl[c] = make_uint4(to_tf32(q.x - __uint_as_float(hi.x)),
                          to_tf32(q.y - __uint_as_float(hi.y)),
                          to_tf32(q.z - __uint_as_float(hi.z)),
                          to_tf32(q.w - __uint_as_float(hi.w)));
      const float wr = __fmaf_ru(z, z, __fmaf_ru(y, y, __fmul_ru(x, x)));
      wmax = max(wmax, __float_as_uint(wr));      // wr >= 0: bit order
    }
    wmax = __reduce_max_sync(kFull, wmax);
    if (lane == 0) wred[warp] = wmax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wmax = max(wmax, wred[w]);
    const float W = __uint_as_float(wmax), Rv = __fsqrt_ru(W);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float3 p = point(16 * (r >> 1) + 8 * (r & 1) + g);
      const float np = __fsqrt_ru(__fmaf_ru(
          p.z, p.z, __fmaf_ru(p.y, p.y, __fmul_ru(p.x, p.x))));
      mr[r] = __fmaf_ru(kMarginC, __fmaf_ru(__fmul_ru(2.f, np), Rv, W),
                        kMarginAbs);
      if (seed) mmax[r] = fmaxf(mmax[r], mr[r]);
    }
    if (!seed) {
      if (s == 0) {
        // the seed keys' k-th least over the quad (distinct pairs: the
        // lanes' columns are disjoint) is a filter key of k pairs, so the
        // row's k-th exact key is at most it plus the largest margin
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float qd[K];
          int qi[K];
#pragma unroll
          for (int q = 0; q < K; ++q) {
            qd[q] = q < J ? sk[r][q] : CUDART_INF_F;
            qi[q] = q < J ? 8 * t + q : 0x7fffffff;
          }
          merge_quad<K>(qd, qi);
          if (t == 0) sbase[warp][g][r] = __fadd_ru(qd[K - 1], mmax[r]);
        }
        __syncwarp();
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        lim[r] = __fadd_ru(fminf(sbase[warp][g][r], bd[r][K - 1]), mr[r]);
      share_lim<R>(lim);
    }
    const int t0 = s * kStage;
    const int n_tiles =
        seed ? min(kStage / 8, n_seeded - (kStage / 8) * s)
             : (min(kStage, v - t0) + 7) >> 3;
    if (seed) {
      for (int nt = 0; nt < n_tiles; ++nt) {
        const uint32_t b = lds32(b_addr + 128 * nt);
        const uint32_t bl = lds32(bl_addr + 128 * nt);
        float c[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) split_keys(a[m], al[m], b, bl, c[m]);
        // padded columns (zero B, key 0) may raise no bound: mask them
        const bool ok0 = vertex(ls, 8 * nt + 2 * t) < v;
        const bool ok1 = vertex(ls, 8 * nt + 2 * t + 1) < v;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            seed_keys<J>(sk[2 * m + h], ok0 ? c[m][2 * h] : CUDART_INF_F);
            seed_keys<J>(sk[2 * m + h], ok1 ? c[m][2 * h + 1] : CUDART_INF_F);
          }
        }
      }
      continue;
    }
    uint32_t b = lds32(b_addr), bl = lds32(bl_addr);
    for (int nt = 0; nt < n_tiles; ++nt) {
      // the next tile's B words (tile 0 again past the stage's end)
      const uint32_t nx = 128 * ((nt + 1) & (kStage / 8 - 1));
      const uint32_t b_next = lds32(b_addr + nx);
      const uint32_t bl_next = lds32(bl_addr + nx);
      float c[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) split_keys(a[m], al[m], b, bl, c[m]);
      b = b_next;
      bl = bl_next;
      // which rows of this tile may hold a list's pair
      float lo[R];
      bool any = false;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        lo[2 * m] = fminf(c[m][0], c[m][1]);
        lo[2 * m + 1] = fminf(c[m][2], c[m][3]);
        any |= (lo[2 * m] <= lim[2 * m]) | (lo[2 * m + 1] <= lim[2 * m + 1]);
      }
      if (any) {
        unsigned rows = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) rows |= unsigned(lo[r] <= lim[r]) << r;
        my_queue[32 * n_queued++] = nt | rows << 8;
      }
      if (__any_sync(kFull, n_queued == kQueue)) rescore(t0);
    }
    rescore(t0);
  }

  asm volatile("cp.async.wait_group 0;" ::: "memory");

  // merge the four lists of each row across its quad, and write
#pragma unroll
  for (int r = 0; r < R; ++r) {
    merge_quad<K>(bd[r], bi[r]);
    const int i = row0 + 16 * (r >> 1) + 8 * (r & 1) + g;
    if (t == 0 && i < n) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        out_idx[i * K + s] = bi[r][s];
        out_d2[i * K + s] = bd[r][s];
      }
    }
  }
}

template <int K, int MT>
void launch_mt(const float* pts, const float* verts, int n, int v,
               int* out_idx, float* out_d2, cudaStream_t stream) {
  const int per_block = kWarps * 16 * MT;
  const int blocks = (n + per_block - 1) / per_block;
  knn_kernel<K, MT><<<blocks, kThreads, 0, stream>>>(pts, verts, n, v,
                                                     out_idx, out_d2);
}

// rows per lane: as many as the lists leave registers for (MT_MAX), fewer
// when the points would not give two blocks per SM
template <int K, int MT_MAX>
void launch(const float* pts, const float* verts, int n, int v, int* out_idx,
            float* out_d2, cudaStream_t stream) {
  constexpr int kMinBlocks = 2 * 132;
  auto blocks = [n](int mt) { return (n + kWarps * 16 * mt - 1) /
                                     (kWarps * 16 * mt); };
  if (MT_MAX >= 4 && blocks(4) >= kMinBlocks)
    launch_mt<K, (MT_MAX >= 4 ? 4 : 1)>(pts, verts, n, v, out_idx, out_d2,
                                        stream);
  else if (MT_MAX >= 2 && blocks(2) >= kMinBlocks)
    launch_mt<K, (MT_MAX >= 2 ? 2 : 1)>(pts, verts, n, v, out_idx, out_d2,
                                        stream);
  else
    launch_mt<K, 1>(pts, verts, n, v, out_idx, out_d2, stream);
}

}  // namespace

extern "C" {

// pts [n, 3] f32, verts [v, 3] f32 (both contiguous, on the device);
// writes out_idx [n, k] int32 and out_d2 [n, k] f32 (ranking keys, sorted
// by (key, index)). Requires 1 <= k <= 8 and v >= k; returns a cudaError_t.
int icon_knn_f32(const float* pts, const float* verts, int n, int v, int k,
                 int* out_idx, float* out_d2, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k < 1 || k > 8 || v < k) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rows per lane shrink as the lists grow, to keep them in registers
  switch (k) {
    case 1: launch<1, 4>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 2: launch<2, 4>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 3: launch<3, 2>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 4: launch<4, 2>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 5: launch<5, 1>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 6: launch<6, 1>(pts, verts, n, v, out_idx, out_d2, s); break;
    case 7: launch<7, 1>(pts, verts, n, v, out_idx, out_d2, s); break;
    default: launch<8, 1>(pts, verts, n, v, out_idx, out_d2, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* icon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
