// The recon engine's level step on sm_90a: four launches a level.
//
// Stands for icon_tpu/recon/engine.py:ReconEngine._level_step (l.225-312,
// faster mode) with its pieces: the 2x trilinear align_corners upsample of
// icon_tpu/ops/resize.py:resize3d_trilinear_align_corners (l.87) on the
// engine's r -> 2r - 1 ladder, the boundary dilation smooth_conv3d(b, k)
// > 0 of icon_tpu/ops/voxelize.py (l.34), minus the voxels evaluated at the
// coarser level, and the compaction of icon_tpu/recon/engine.py:_compact
// (l.65-79) with the query points of its eval_at. The JAX package wrote
// them as XLA for the TPU (einsums of interpolation matrices, three padded
// box passes, top_k over index keys); here:
//
// 1. level_upsample_kernel: a lane a fine voxel, a warp 32 voxels of one
//    row (z, y) of the fine grid (a row padded to W = ceil(r / 32) words),
//    a block a row's group of 8 words.
//    Each lane reads its 1, 2, 4 or 8 coarse corners and forms the D, then
//    H, then W midpoints, each 0.5 a + 0.5 b rounded as the plain twin's
//    separate tensor operations round it (__fmul_rn, __fadd_rn: no FMA).
//    With marks it also writes the fine evaluated flags (the coarse flags
//    at (2i, 2j, 2k), else 0) and, by a ballot, the row's words of
//    "mixed" bits: the corners' > 0.5 indicators are neither all 0 nor
//    all 1. That is exactly the plain (valid > 0) & (valid < 1) of the
//    upsampled indicator, whose midpoints of 0 and 1 are dyadic and
//    exact. Without marks it is the faster mode's last level.
// 2. level_mark_kernel: a thread a (row, word). It ORs the words w - 1,
//    w, w + 1 of the (2h + 1)^2 rows around its own (rows past the grid
//    are zero padding), then ORs the 96-bit window shifted by -h..h: the
//    k^3 box dilation, k = 2h + 1. A zero-padded box sum of non-negative
//    terms divided by k stays above 0 iff a term is 1, so this OR is
//    smooth_conv3d(b, k) > 0 exactly. It clears the evaluated coarse
//    voxels at even (z, y, x), writes the word and each block's popcount.
//    In byte mode it packs a bool mask into words instead (exact mode's
//    conflict flags).
// 3. level_compact_kernel: the same blocks over the same words. A block
//    sums the popcounts of the blocks before it and of all blocks (a few
//    thousand at most: the words of 257^3 are 2,323 blocks), scans its
//    words, and writes each set bit's linear index and its world point at
//    its rank while the rank is below the budget; the slots past min(total,
//    budget) get r^3 - 1 and its point; block 0 writes (n_sel, total,
//    overflow). The points are the plain twin's: the grid index as float
//    divided by r - 1 (IEEE division), times bmax - bmin, plus bmin, each
//    rounded on its own.
// 4. level_write_kernel: a thread a slot; slots below n_sel (read on the
//    card) write the queried value and the evaluated flag at their index.
//
// Bound: bytes. Each kernel reads its inputs once and writes its outputs
// once (chip_smoke.py phase 21 counts them from the shapes and, for the
// write, the live slots); none does more than a few integer operations a
// byte. The upsample to 257^3 writes 68 MB, 20 us at 3.35 TB/s; the
// level steps move 1-12 MB.
//
// Every buffer is the caller's; no kernel allocates, synchronizes or reads
// the host, so a level can be captured in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum MarkMode { kDilate = 0, kBytes = 1 };

__device__ __forceinline__ float mid(float a, float b) {
  return __fadd_rn(__fmul_rn(0.5f, a), __fmul_rn(0.5f, b));
}

__device__ __forceinline__ long long block_sum(long long v, long long* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                 // sh may hold an earlier sum
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  long long s = 0;
  for (int i = 0; i < kWarps; ++i) s += sh[i];
  return s;
}

// The fine voxel's value and its corners' mixed flag. A block a row and
// kWarps of its words (blockIdx.y the group): 32-bit index arithmetic, one
// division a lane (64-bit divisions cost more than the lane's loads).
__global__ void __launch_bounds__(kThreads)
level_upsample_kernel(const float* __restrict__ occ_c,
                      const unsigned char* __restrict__ ev_c, int rc, int r,
                      int W, float* __restrict__ occ_f,
                      unsigned char* __restrict__ ev_f,
                      unsigned* __restrict__ raw) {
  const int w = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (w >= W) return;                  // whole warps
  const int row = blockIdx.x;
  const int x = 32 * w + (threadIdx.x & 31);
  const int z = row / r, y = row - z * r;
  const bool in = x < r;
  bool mixed = false;
  if (in) {
    const int zc = z >> 1, yc = y >> 1, xc = x >> 1;
    const int oz = z & 1, oy = y & 1, ox = x & 1;
    bool any1 = false, any0 = false;
    float u[2];
    for (int dx = 0; dx <= ox; ++dx) {
      float tv[2];
      for (int dy = 0; dy <= oy; ++dy) {
        const long long base =
            (static_cast<long long>(zc) * rc + yc + dy) * rc + xc + dx;
        const float a = occ_c[base];
        any1 |= a > 0.5f;
        any0 |= !(a > 0.5f);
        if (oz) {
          const float b = occ_c[base + static_cast<long long>(rc) * rc];
          any1 |= b > 0.5f;
          any0 |= !(b > 0.5f);
          tv[dy] = mid(a, b);
        } else {
          tv[dy] = a;
        }
      }
      u[dx] = oy ? mid(tv[0], tv[1]) : tv[0];
    }
    const long long f = static_cast<long long>(row) * r + x;
    occ_f[f] = ox ? mid(u[0], u[1]) : u[0];
    if (ev_c != nullptr) {
      ev_f[f] = (oz | oy | ox)
          ? 0
          : ev_c[(static_cast<long long>(zc) * rc + yc) * rc + xc];
      mixed = any1 && any0;
    }
  }
  if (ev_c != nullptr) {
    const unsigned word = __ballot_sync(kFull, mixed);
    if ((threadIdx.x & 31) == 0)
      raw[static_cast<long long>(row) * W + w] = word;
  }
}

__global__ void __launch_bounds__(kThreads)
level_mark_kernel(const void* __restrict__ src, int mode,
                  const unsigned char* __restrict__ ev_c, int rc, int r,
                  int W, int h, unsigned* __restrict__ words,
                  int* __restrict__ block_counts) {
  __shared__ long long sh[kWarps];
  const long long items = static_cast<long long>(r) * r * W;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  unsigned res = 0;
  if (t < items) {
    const long long row = t / W;
    const int w = static_cast<int>(t - row * W);
    const int z = static_cast<int>(row / r), y = static_cast<int>(row % r);
    const int tail = r - 32 * w;          // valid bits of this word
    const unsigned valid = tail >= 32 ? kFull : ((1u << tail) - 1u);
    if (mode == kBytes) {
      const unsigned char* m = static_cast<const unsigned char*>(src) +
                               row * r + 32 * w;
      for (int b = 0; b < 32 && b < tail; ++b)
        if (m[b]) res |= 1u << b;
    } else {
      const unsigned* rw = static_cast<const unsigned*>(src);
      unsigned prev = 0, cur = 0, next = 0;
      for (int zz = max(z - h, 0); zz <= min(z + h, r - 1); ++zz) {
        for (int yy = max(y - h, 0); yy <= min(y + h, r - 1); ++yy) {
          const unsigned* p =
              rw + (static_cast<long long>(zz) * r + yy) * W + w;
          cur |= p[0];
          if (w > 0) prev |= p[-1];
          if (w + 1 < W) next |= p[1];
        }
      }
      const unsigned long long lo =
          (static_cast<unsigned long long>(cur) << 32) | prev;
      const unsigned long long hi =
          (static_cast<unsigned long long>(next) << 32) | cur;
      res = cur;
      for (int s = 1; s <= h; ++s) {
        res |= static_cast<unsigned>(hi >> s);         // from x + s
        res |= static_cast<unsigned>(lo >> (32 - s));  // from x - s
      }
      res &= valid;
      if (ev_c != nullptr && !(z & 1) && !(y & 1)) {
        const unsigned char* e =
            ev_c + (static_cast<long long>(z >> 1) * rc + (y >> 1)) * rc;
        for (int b = 0; b < 32 && b < tail; b += 2)   // 32 w + b is even
          if (e[(32 * w + b) >> 1]) res &= ~(1u << b);
      }
    }
    words[t] = res;
  }
  const long long n = block_sum(__popc(res), sh);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = static_cast<int>(n);
}

struct Box {
  float bmin[3], span[3];
};

__device__ __forceinline__ void world(float* p, int x, int y, int z,
                                      float denom, const Box& box) {
  const int c[3] = {x, y, z};
  for (int a = 0; a < 3; ++a)
    p[a] = __fadd_rn(__fmul_rn(__fdiv_rn(static_cast<float>(c[a]), denom),
                               box.span[a]),
                     box.bmin[a]);
}

__global__ void __launch_bounds__(kThreads)
level_compact_kernel(const unsigned* __restrict__ words,
                     const int* __restrict__ block_counts, int nblk, int r,
                     int W, long long budget, Box box,
                     long long* __restrict__ idx, float* __restrict__ pts,
                     long long* __restrict__ counts) {
  __shared__ long long sh[kWarps];
  __shared__ int warp_pre[kWarps];
  long long before = 0, all = 0;
  for (int j = threadIdx.x; j < nblk; j += kThreads) {
    const int c = block_counts[j];
    all += c;
    if (j < static_cast<int>(blockIdx.x)) before += c;
  }
  before = block_sum(before, sh);
  all = block_sum(all, sh);
  const long long n_sel = all < budget ? all : budget;
  const float denom = static_cast<float>(r - 1);

  const long long items = static_cast<long long>(r) * r * W;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  unsigned word = t < items ? words[t] : 0u;
  const int c = __popc(word);
  // the block's exclusive scan of the popcounts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_pre[warp] = inc;
  __syncthreads();
  int base = inc - c;
  for (int i = 0; i < warp; ++i) base += warp_pre[i];

  long long slot = before + base;
  if (word != 0u && slot < budget) {
    const long long row = t / W;
    const int w = static_cast<int>(t - row * W);
    const int z = static_cast<int>(row / r), y = static_cast<int>(row % r);
    while (word != 0u && slot < budget) {
      const int b = __ffs(word) - 1;
      word &= word - 1u;
      const int x = 32 * w + b;
      idx[slot] = row * r + x;
      world(pts + 3 * slot, x, y, z, denom, box);
      ++slot;
    }
  }
  // the padded slots: index r^3 - 1 and its point
  const long long last = static_cast<long long>(r) * r * r - 1;
  for (long long s = n_sel + t; s < budget;
       s += static_cast<long long>(gridDim.x) * kThreads) {
    idx[s] = last;
    world(pts + 3 * s, r - 1, r - 1, r - 1, denom, box);
  }
  if (t == 0) {
    counts[0] = n_sel;
    counts[1] = all;
    counts[2] = all > budget ? all - budget : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
level_write_kernel(float* __restrict__ occ_f, unsigned char* __restrict__ ev_f,
                   const long long* __restrict__ idx,
                   const long long* __restrict__ counts,
                   const float* __restrict__ vals, long long budget) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= budget || i >= counts[0]) return;
  const long long j = idx[i];
  occ_f[j] = vals[i];
  ev_f[j] = 1;
}

int words_a_row(int r) { return (r + 31) / 32; }

bool grid_ok(long long threads) {
  return threads / kThreads < 0x7fffffffLL;
}

}  // namespace

extern "C" {

// occ_c [rc^3] f32; ev_c [rc^3] bool bytes or null. Writes occ_f [r^3] f32,
// r = 2 rc - 1, and with ev_c the fine flags ev_f [r^3] and the mixed
// bits raw [r^2, W] u32, W = ceil(r / 32). Returns a cudaError_t.
int icon_level_upsample(const float* occ_c, const unsigned char* ev_c,
                        int rc, float* occ_f, unsigned char* ev_f,
                        unsigned* raw, void* stream) {
  if (rc < 1 || rc > 65536 ||
      (ev_c != nullptr && (ev_f == nullptr || raw == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = 2 * rc - 1, W = words_a_row(r);
  const long long rows = static_cast<long long>(r) * r;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows), (W + kWarps - 1) / kWarps);
  level_upsample_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      occ_c, ev_c, rc, r, W, occ_f, ev_f, raw);
  return static_cast<int>(cudaGetLastError());
}

// mode 0: src the mixed bits raw [r^2, W] u32, dilated by the (2h + 1)^3
// box, minus the coarse flags ev_c [rc^3] (or null) at even (z, y, x);
// mode 1: src a bool mask [r^3] bytes, packed. Writes words [r^2, W] u32
// and block_counts [blocks] i32, one a block of 256 words. Returns a
// cudaError_t.
int icon_level_mark(const void* src, int mode, const unsigned char* ev_c,
                    int rc, int r, int h, unsigned* words, int* block_counts,
                    void* stream) {
  if (r < 1 || (mode != kDilate && mode != kBytes) || h < 0 || h > 31 ||
      (ev_c != nullptr && 2 * rc - 1 != r))
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = words_a_row(r);
  const long long items = static_cast<long long>(r) * r * W;
  if (!grid_ok(items)) return static_cast<int>(cudaErrorInvalidValue);
  level_mark_kernel<<<static_cast<unsigned>((items + kThreads - 1) /
                                            kThreads),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, mode, ev_c, rc, r, W, h, words, block_counts);
  return static_cast<int>(cudaGetLastError());
}

// words [r^2, W] u32 and block_counts [blocks] from icon_level_mark. Writes
// the first budget set indices in linear order, padded with r^3 - 1, to
// idx [budget] i64, their world points to pts [budget, 3] f32 (the box
// bmin, bmax) and (n_sel, total, overflow) to counts [3] i64. Returns a
// cudaError_t.
int icon_level_compact(const unsigned* words, const int* block_counts,
                       int r, long long budget, float bmin0, float bmin1,
                       float bmin2, float bmax0, float bmax1, float bmax2,
                       long long* idx, float* pts, long long* counts,
                       void* stream) {
  if (r < 1 || budget < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int W = words_a_row(r);
  const long long items = static_cast<long long>(r) * r * W;
  if (!grid_ok(items)) return static_cast<int>(cudaErrorInvalidValue);
  const long long nblk = (items + kThreads - 1) / kThreads;
  // the host's float subtraction rounds once, as the twin's tensor one
  Box box{{bmin0, bmin1, bmin2},
          {bmax0 - bmin0, bmax1 - bmin1, bmax2 - bmin2}};
  level_compact_kernel<<<static_cast<unsigned>(nblk), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      words, block_counts, static_cast<int>(nblk), r, W, budget, box, idx,
      pts, counts);
  return static_cast<int>(cudaGetLastError());
}

// occ_f [r^3] f32 and ev_f [r^3] bool bytes updated in place: slot i <
// counts[0] writes vals[i] and 1 at idx[i]. Returns a cudaError_t.
int icon_level_write(float* occ_f, unsigned char* ev_f, const long long* idx,
                     const long long* counts, const float* vals,
                     long long budget, void* stream) {
  if (budget < 0 || !grid_ok(budget))
    return static_cast<int>(cudaErrorInvalidValue);
  if (budget == 0) return static_cast<int>(cudaSuccess);
  level_write_kernel<<<static_cast<unsigned>((budget + kThreads - 1) /
                                             kThreads),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      occ_f, ev_f, idx, counts, vals, budget);
  return static_cast<int>(cudaGetLastError());
}

const char* icon_level_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
