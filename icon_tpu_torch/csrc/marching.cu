// The indexed marching-tetrahedra mesh on sm_90a: triangle emit and vertex
// indexing.
//
// Stands for the table and dedup stages of
// icon_tpu/recon/marching.py:marching_tetrahedra_indexed (l.282-392): per
// cell, one-hot [cells, 96] @ [96, 36] MXU products apply the (tet, case)
// tables, a top_k compaction packs the valid triangle slots, and one
// multi-operand lax.sort of the 3 x max_tris vertex slots by their lattice
// edge ids dedups the vertices. On this card there is no matrix unit to
// feed and a sort of millions of keys is the largest cost, so both stages
// are rewritten around what the lattice guarantees.
//
// mt_emit (three launches): a thread per active cell (256 a block) gathers
// its 8 corner values, forms the 6 Kuhn tets' 4-bit cases and reads the
// (tet, case) tables from constant memory (set once a device from
// recon/lattice_host.py:_tet_tables). The count launch writes each cell's
// 12-bit triangle-slot mask and each block's triangle count; one block
// scans the block counts (exclusive, carrying a running offset over tiles
// of 1024) and writes the total; the write launch scans its block's cell
// counts (warp shuffles, then the warp totals) and gives triangle slot s of
// cell i the index block offset + cells before it + its valid slots before
// s: the linear (cell, slot) order of the JAX package's _compact_indices.
// Triangles past max_tris are dropped (the total still counts them). Each
// of a triangle's 3 vertex slots gets the point c + a + t (b - a) on its
// edge (a the inside corner, t = (iso - v_a) / (v_b - v_a), 0.5 where
// |v_b - v_a| < 1e-12, clipped to [0, 1]; each operation rounded on its
// own, as the plain version does) and the int64 edge id min(lin_a, lin_b) *
// 8 + direction code.
//
// mt_index (four launches and a scan): every vertex of the mesh lies on
// one lattice edge, and edge ids are below D H W 8, so the set of used ids
// is a bitmap of D H W 8 bits (16.8 MB at 256^3), zeroed, then marked by
// one atomicOr a live vertex slot. The rank of an id among the used ids is
// the popcount of the bits below it: per-block popcounts of the words, the
// same one-block scan, a per-word exclusive prefix; a slot's rank is its
// word's prefix plus the popcount of its word below its bit. The rank is
// the slot's face index, and the slot writes its point to that row of the
// vertex table (rows below max_verts), which is therefore in ascending
// edge-id order, as the sort leaves it. Every slot of one edge writes the
// same bits (each computes the point from the edge's inside corner), so the
// race is benign. Memory is bound by the grid, not the surface; the
// virtual final level (recon/marching.py:marching_lattice_virtual) is the
// path for grids whose bitmap would not fit.
//
// Bound: bytes. mt_emit reads 8 corners a cell (32 B, mostly in L1) and
// writes 3 x (12 + 8) B a triangle; mt_index reads and writes those 20 B a
// slot, zeroes and reads the bitmap and writes its prefix (2 x 4 bits an
// edge id) and writes 12 B a vertex.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kWordsPerThread = 8;

// (tet, case, tri, vert) -> inside / outside local corner; (tet, case,
// tri) -> valid
__constant__ unsigned char c_A[6 * 16 * 2 * 3];
__constant__ unsigned char c_B[6 * 16 * 2 * 3];
__constant__ unsigned char c_valid[6 * 16 * 2];
// Kuhn's 6 tets: paths 0 -> a -> b -> 7 along cube edges
__constant__ unsigned char c_tets[6][4] = {{0, 1, 3, 7}, {0, 1, 5, 7},
                                           {0, 2, 3, 7}, {0, 2, 6, 7},
                                           {0, 4, 5, 7}, {0, 4, 6, 7}};

struct Grid {
  int D, H, W;
};

__device__ __forceinline__ long long corner_lin(const Grid& g, long long x,
                                                long long y, long long z,
                                                int c) {
  return ((z + ((c >> 2) & 1)) * g.H + (y + ((c >> 1) & 1))) * g.W +
         (x + (c & 1));
}

// The 12-bit valid-slot mask of one cell (slot = tet * 2 + tri) and its
// 6 cases packed 4 bits each.
__device__ __forceinline__ unsigned cell_cases(const float* occ,
                                               const Grid& g, long long x,
                                               long long y, long long z,
                                               float iso, float* v,
                                               unsigned* cases) {
  unsigned bits = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    v[c] = occ[corner_lin(g, x, y, z, c)];
    bits |= (v[c] > iso ? 1u : 0u) << c;
  }
  unsigned mask = 0, packed = 0;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    unsigned cs = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) cs |= ((bits >> c_tets[t][i]) & 1u) << i;
    packed |= cs << (4 * t);
    mask |= static_cast<unsigned>(c_valid[(t * 16 + cs) * 2]) << (2 * t);
    mask |= static_cast<unsigned>(c_valid[(t * 16 + cs) * 2 + 1])
            << (2 * t + 1);
  }
  *cases = packed;
  return mask;
}

// Exclusive scan of one int per thread over the block; *total gets the
// block's sum. blockDim.x a multiple of 32, at most 1024.
__device__ __forceinline__ int block_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;        // inclusive
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();                                  // warp_sums reusable
  return before + incl - x;
}

__global__ void __launch_bounds__(kThreads)
emit_count_kernel(const float* __restrict__ occ, Grid g,
                  const long long* __restrict__ cx,
                  const long long* __restrict__ cy,
                  const long long* __restrict__ cz,
                  const long long* __restrict__ n_cells, int nc, float iso,
                  unsigned short* __restrict__ slot_mask,
                  int* __restrict__ block_counts) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  unsigned mask = 0;
  if (i < nc && i < *n_cells) {
    float v[8];
    unsigned cases;
    mask = cell_cases(occ, g, cx[i], cy[i], cz[i], iso, v, &cases);
  }
  if (i < nc) slot_mask[i] = static_cast<unsigned short>(mask);
  int total;
  block_scan(__popc(mask), warp_sums, &total);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

// One block: in-place exclusive scan of counts[0, n); *total = the sum.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ counts, int n, long long* __restrict__ total) {
  __shared__ int warp_sums[32];
  long long carry = 0;
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int x = i < n ? counts[i] : 0;
    int tile;
    const int ex = block_scan(x, warp_sums, &tile);
    if (i < n) counts[i] = static_cast<int>(carry + ex);
    carry += tile;
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kThreads)
emit_write_kernel(const float* __restrict__ occ, Grid g,
                  const long long* __restrict__ cx,
                  const long long* __restrict__ cy,
                  const long long* __restrict__ cz, int nc, float iso,
                  const unsigned short* __restrict__ slot_mask,
                  const int* __restrict__ block_offsets, long long max_tris,
                  float* __restrict__ tvx, float* __restrict__ tvy,
                  float* __restrict__ tvz, long long* __restrict__ teid) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const unsigned mask = i < nc ? slot_mask[i] : 0u;
  int total;
  const int before = block_scan(__popc(mask), warp_sums, &total);
  if (!mask) return;
  const long long base =
      static_cast<long long>(block_offsets[blockIdx.x]) + before;
  if (base >= max_tris) return;
  const long long x = cx[i], y = cy[i], z = cz[i];
  float v[8];
  unsigned cases;
  cell_cases(occ, g, x, y, z, iso, v, &cases);
  int rank = 0;
  for (int s = 0; s < 12; ++s) {
    if (!((mask >> s) & 1u)) continue;
    const long long tri = base + rank++;
    if (tri >= max_tris) return;
    const int t = s >> 1, k = s & 1;
    const int e = (t * 16 + ((cases >> (4 * t)) & 15u)) * 2 + k;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int a = c_A[e * 3 + j], b = c_B[e * 3 + j];
      const float va = v[a], vb = v[b];
      const float den = __fsub_rn(vb, va);
      float tt = fabsf(den) < 1e-12f ? 0.5f
                                     : __fdiv_rn(__fsub_rn(iso, va), den);
      tt = fminf(fmaxf(tt, 0.0f), 1.0f);
      const int ax = a & 1, ay = (a >> 1) & 1, az = (a >> 2) & 1;
      const int bx = b & 1, by = (b >> 1) & 1, bz = (b >> 2) & 1;
      const long long o = tri * 3 + j;
      tvx[o] = __fadd_rn(static_cast<float>(x + ax),
                         __fmul_rn(tt, static_cast<float>(bx - ax)));
      tvy[o] = __fadd_rn(static_cast<float>(y + ay),
                         __fmul_rn(tt, static_cast<float>(by - ay)));
      tvz[o] = __fadd_rn(static_cast<float>(z + az),
                         __fmul_rn(tt, static_cast<float>(bz - az)));
      const long long la = corner_lin(g, x, y, z, a);
      const long long lb = corner_lin(g, x, y, z, b);
      const int dir = abs(bx - ax) + 2 * abs(by - ay) + 4 * abs(bz - az);
      teid[o] = (la < lb ? la : lb) * 8 + dir;
    }
  }
}

__global__ void index_mark_kernel(const long long* __restrict__ teid,
                                  const long long* __restrict__ n_tris,
                                  long long n_slots,
                                  unsigned* __restrict__ bitmap) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n_slots || i >= 3 * *n_tris) return;
  const long long e = teid[i];
  atomicOr(bitmap + (e >> 5), 1u << (e & 31));
}

// Per-thread popcount of kWordsPerThread consecutive words; returns it.
__device__ __forceinline__ int words_popc(const unsigned* bitmap,
                                          long long w0, long long nwords) {
  int c = 0;
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k)
    if (w0 + k < nwords) c += __popc(bitmap[w0 + k]);
  return c;
}

__global__ void __launch_bounds__(kThreads)
index_count_kernel(const unsigned* __restrict__ bitmap, long long nwords,
                   int* __restrict__ block_counts) {
  __shared__ int warp_sums[32];
  const long long w0 = (blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x) * kWordsPerThread;
  int total;
  block_scan(words_popc(bitmap, w0, nwords), warp_sums, &total);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
index_prefix_kernel(const unsigned* __restrict__ bitmap, long long nwords,
                    const int* __restrict__ block_offsets,
                    int* __restrict__ word_prefix) {
  __shared__ int warp_sums[32];
  const long long w0 = (blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x) * kWordsPerThread;
  int total;
  int run = block_offsets[blockIdx.x] +
            block_scan(words_popc(bitmap, w0, nwords), warp_sums, &total);
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    if (w0 + k < nwords) {
      word_prefix[w0 + k] = run;
      run += __popc(bitmap[w0 + k]);
    }
  }
}

__global__ void index_write_kernel(const long long* __restrict__ teid,
                                   const float* __restrict__ tvx,
                                   const float* __restrict__ tvy,
                                   const float* __restrict__ tvz,
                                   const long long* __restrict__ n_tris,
                                   long long n_slots,
                                   const unsigned* __restrict__ bitmap,
                                   const int* __restrict__ word_prefix,
                                   long long max_verts,
                                   int* __restrict__ faces,
                                   float* __restrict__ vx,
                                   float* __restrict__ vy,
                                   float* __restrict__ vz) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n_slots) return;
  if (i >= 3 * *n_tris) {
    faces[i] = 0;
    return;
  }
  const long long e = teid[i];
  const long long w = e >> 5;
  const unsigned below = bitmap[w] & ((1u << (e & 31)) - 1u);
  const int r = word_prefix[w] + __popc(below);
  faces[i] = r;
  if (r < max_verts) {
    vx[r] = tvx[i];
    vy[r] = tvy[i];
    vz[r] = tvz[i];
  }
}

inline unsigned blocks_for(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// The (tet, case) tables: A, B [6, 16, 2, 3] u8 local corner ids (inside,
// outside) of each triangle vertex, valid [6, 16, 2] u8. Call once a
// device before the first mt_emit. Returns a cudaError_t.
int icon_mt_set_tables(const unsigned char* A, const unsigned char* B,
                       const unsigned char* valid) {
  cudaError_t err = cudaMemcpyToSymbol(c_A, A, sizeof(c_A));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_B, B, sizeof(c_B));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(c_valid, valid, sizeof(c_valid));
  return static_cast<int>(err);
}

// occ [D, H, W] f32; cx, cy, cz [nc] int64 cell coordinates (cells past
// *n_cells are dead); writes slot_mask [nc] u16 (scratch), counts
// [ceil(nc / 256)] i32 (scratch), the triangles' vertex slots tvx, tvy, tvz
// [max_tris * 3] f32 and teid [max_tris * 3] int64 (rows past the total
// left as the caller filled them) and *n_total (int64), the triangle count
// before the max_tris cut. Returns a cudaError_t.
int icon_mt_emit(const float* occ, int D, int H, int W, const long long* cx,
                 const long long* cy, const long long* cz,
                 const long long* n_cells, int nc, float iso,
                 long long max_tris, unsigned short* slot_mask, int* counts,
                 float* tvx, float* tvy, float* tvz, long long* teid,
                 long long* n_total, void* stream) {
  if (D < 2 || H < 2 || W < 2 || nc < 1 || max_tris < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{D, H, W};
  const unsigned nb = blocks_for(nc, kThreads);
  emit_count_kernel<<<nb, kThreads, 0, s>>>(occ, g, cx, cy, cz, n_cells, nc,
                                            iso, slot_mask, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, static_cast<int>(nb),
                                         n_total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  emit_write_kernel<<<nb, kThreads, 0, s>>>(occ, g, cx, cy, cz, nc, iso,
                                            slot_mask, counts, max_tris, tvx,
                                            tvy, tvz, teid);
  return static_cast<int>(cudaGetLastError());
}

// teid, tvx, tvy, tvz [n_slots] (3 slots a triangle, the first 3 * *n_tris
// live, ids below nwords * 32); bitmap and word_prefix [nwords] (scratch),
// counts [ceil(nwords / 2048)] (scratch). Writes faces [n_slots] i32 (each
// live slot's vertex rank, 0 elsewhere), the vertex table vx, vy, vz
// [max_verts] in ascending edge-id order and *n_unique (int64), the count
// of distinct ids. Returns a cudaError_t.
int icon_mt_index(const long long* teid, const float* tvx, const float* tvy,
                  const float* tvz, const long long* n_tris,
                  long long n_slots, long long nwords, unsigned* bitmap,
                  int* word_prefix, int* counts, long long max_verts,
                  int* faces, float* vx, float* vy, float* vz,
                  long long* n_unique, void* stream) {
  const long long nb = (nwords + kThreads * kWordsPerThread - 1) /
                       (kThreads * kWordsPerThread);
  if (n_slots < 1 || nwords < 1 || nb > 0x7fffffffLL || max_verts < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bitmap, 0, sizeof(unsigned) * nwords, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  index_mark_kernel<<<blocks_for(n_slots, kThreads), kThreads, 0, s>>>(
      teid, n_tris, n_slots, bitmap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  index_count_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      bitmap, nwords, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, static_cast<int>(nb),
                                         n_unique);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  index_prefix_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      bitmap, nwords, counts, word_prefix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  index_write_kernel<<<blocks_for(n_slots, kThreads), kThreads, 0, s>>>(
      teid, tvx, tvy, tvz, n_tris, n_slots, bitmap, word_prefix, max_verts,
      faces, vx, vy, vz);
  return static_cast<int>(cudaGetLastError());
}

const char* icon_mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
