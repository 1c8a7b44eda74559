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
// mt_emit (one launch): a single-pass scan with decoupled look-back
// (Merrill and Garland). A block takes tiles of 128 cells in the order of
// an atomic ticket, so it looks back only at tiles whose blocks already
// run. Four threads a cell gather its 8 corner values (an x-adjacent pair
// each) into shared memory, every corner read once; two shuffles give the
// cell's inside bits, and one of its threads forms the 6 Kuhn tets' 4-bit
// cases and reads the (tet, case) tables (set once a device from
// recon/lattice_host.py:_tet_tables, copied to shared memory a block). One
// warp scans the tile's triangle counts, lists its triangles in (cell,
// slot) order in shared memory, publishes the tile's count, and looks back
// 32 statuses a step for the tiles before it: the linear (cell, slot) order
// of the JAX package's _compact_indices. The tile's triangles are one
// contiguous range, written a vertex slot a thread, so neighbouring
// threads store neighbouring elements of tvx, tvy, tvz and teid, and no
// warp waits for its busiest cell. Each vertex slot gets the point
// c + a + t (b - a) on its edge (a the inside corner, t = (iso - v_a) /
// (v_b - v_a), 0.5 where |v_b - v_a| < 1e-12, clipped to [0, 1]; each
// operation rounded on its own, as the plain version does) and the int64
// edge id min(lin_a, lin_b) * 8 + direction code. Triangles past max_tris
// are dropped (the total still counts them). Only tiles holding live cells
// (below *n_cells) run. The C entry zeroes the scan's scratch (one
// cudaMemsetAsync) before the launch.
//
// mt_index (four launches, each over the live slots or the summary):
// every vertex lies on one lattice edge and edge ids are below D H W 8.
// A bitmap of that id space (one bit an id) holds anything on entry: only
// the words of live ids are ever read, and the first pass zeroes those.
// Its summary (one bit a bitmap word, 1/32 of the bitmap's bytes) and the
// scan's scratch are zeroed by the C entry (two cudaMemsetAsync) before the
// first pass, so that a call owns them whole: launches of two calls that
// host threads interleave on one stream never share a summary bit.
// 1. clear: a grid-stride loop over the 3 * n_tris live slots zeroes each
//    id's bitmap word.
// 2. mark: the same loop ORs each id into the bitmap (the slots of one
//    word in a warp merged first); the slot that finds its word empty sets
//    the word's summary bit.
// 3. summary scan, the only pass at the grid's scale: a thread a summary
//    word counts its touched words and their ids (popcounts of the bitmap
//    words under its set bits); a single-pass scan as mt_emit's, over
//    tiles of 256 summary words, gives each word its touched words and
//    distinct ids before it. The thread writes
//    (touched words before it, its bits) for its summary word, and (ids
//    before it, its bits) for each touched bitmap word in a compact array
//    indexed by the touched words' rank.
// 4. write: a live slot's rank is its touched word's ids before it plus the
//    popcount of its word below its bit; it is the slot's face index, and
//    the slot writes its point to that row of the vertex table (rows below
//    max_verts), which is therefore in ascending edge-id order, as the sort
//    leaves it. Every slot of one edge writes the same bits (each computes
//    the point from the edge's inside corner), so the race is benign. The
//    dead slots' faces get 0.
// No pass touches the bitmap at full resolution: its bytes scale with the
// live slots. The virtual final level (recon/marching.py:
// marching_lattice_virtual) remains the path for grids whose bitmap would
// not fit.
//
// Bound: bytes. mt_emit reads 3 coordinates and 8 corners a cell and
// writes 3 x (12 + 8) B a triangle; mt_index reads those 20 B a slot,
// writes 4 B of faces a slot and 12 B a vertex.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// The design was chosen on one H100 at 257^3 and 513^3 against builds
// with other choices: 32-cell tiles took 1.5x as long as 128-cell tiles at
// 257^3, 64- or 256-cell tiles 1.02-1.1x; 4 statuses a lane a look-back
// step (one here) made the summary scan 1.6-1.9x slower; 2 summary words a
// thread (one here) helped at 513^3 and hurt at 257^3; without a bound on
// its registers mt_emit took 57 (2 blocks an SM) and was 10% slower at
// 513^3, and at 4 blocks an SM it spilled; the mark without the warp's
// merge took 2.2x as long.
constexpr int kTileCells = 128;                   // mt_emit: cells a tile
constexpr int kEmitThreads = kTileCells * 4;      // a thread a corner pair
constexpr int kTileTris = kTileCells * 12;
constexpr int kCellsPerLane = kTileCells / 32;    // in the tile's scan
constexpr int kEmitMinBlocks = 3;                 // resident an SM, at least
static_assert(kTileCells % 32 == 0 && kEmitThreads <= 1024,
              "a tile is whole warps' cells and one block");
constexpr int kThreads = 256;     // mt_index's passes; summary words a tile
constexpr int kMaxDevices = 16;

// a look-back status: the flag in bits 62-63, a sum in bits 0-61
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kSumBits = (1ull << 62) - 1;
constexpr unsigned kMaxSpins = 1u << 24;          // seconds of polling
// mt_index's scan sums two counts below 2^31 in one word: touched bitmap
// words in bits 0-30, distinct ids in bits 31-61
constexpr int kIdShift = 31;
constexpr unsigned long long kWordMask = (1ull << kIdShift) - 1;

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

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The sum of the tiles before tile t > 0, from their statuses (a scan's
// decoupled look-back, 32 tiles a step: lane l reads tile top - l). A
// whole warp calls it; every lane gets the sum.
__device__ unsigned long long look_back(const unsigned long long* status,
                                        long long t) {
  const int lane = threadIdx.x & 31;
  unsigned long long before = 0;
  for (long long top = t - 1;; top -= 32) {
    const long long j = top - lane;
    unsigned long long s = j >= 0 ? load_status(status + j) : kInclusive;
    for (unsigned spins = 0; __any_sync(0xffffffffu, (s >> 62) == 0);
         ++spins) {
      // a tile that never publishes is a fault (scratch not zero on
      // entry): fail the launch rather than spin on
      if (spins == kMaxSpins) __trap();
      if ((s >> 62) == 0) s = load_status(status + j);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (s >> 62) == 2);
    // the nearest inclusive tile ends the window
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned long long v = lane <= stop ? s & kSumBits : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    before += v;
    if (incl) return before;
  }
}

// Scratch of a single-pass scan: [0] the tile ticket, [1 + t] tile t's
// status; zero on entry (the C entries' memset).
struct Scan {
  unsigned long long* ticket;
  unsigned long long* status;
};

__device__ __forceinline__ Scan scan_of(unsigned long long* scratch) {
  return Scan{scratch, scratch + 1};
}

// The block's next tile, or -1 when none is left.
__device__ long long next_tile(const Scan& sc, long long tiles,
                               long long* shared_tile) {
  if (threadIdx.x == 0)
    *shared_tile = static_cast<long long>(atomicAdd(sc.ticket, 1ull));
  __syncthreads();                   // also: the block's last tile is done
  const long long t = *shared_tile;
  return t < tiles ? t : -1;
}

__global__ void __launch_bounds__(kEmitThreads, kEmitMinBlocks)
emit_kernel(const float* __restrict__ occ, Grid g,
            const long long* __restrict__ cx,
            const long long* __restrict__ cy,
            const long long* __restrict__ cz,
            const long long* __restrict__ n_cells, int nc, float iso,
            long long max_tris, float* __restrict__ tvx,
            float* __restrict__ tvy, float* __restrict__ tvz,
            long long* __restrict__ teid, long long* __restrict__ n_total,
            unsigned long long* __restrict__ scratch) {
  __shared__ unsigned char sA[6 * 16 * 2 * 3], sB[6 * 16 * 2 * 3];
  __shared__ unsigned char sValid[6 * 16 * 2];
  __shared__ __align__(16) float sv[kTileCells * 8];  // [cell][corner]
  __shared__ int sxyz[3][kTileCells];
  __shared__ unsigned sCases[kTileCells];
  __shared__ unsigned short sMask[kTileCells];
  __shared__ int sBefore[kTileCells];                // tile's tris before
  __shared__ unsigned short sTri[kTileTris];         // cell << 4 | slot
  __shared__ long long sTile;
  __shared__ unsigned long long sFirst;              // the tile's first tri
  __shared__ int sCount;

  for (int k = threadIdx.x; k < 6 * 16 * 2 * 3; k += kEmitThreads) {
    sA[k] = c_A[k];
    sB[k] = c_B[k];
    if (k < 6 * 16 * 2) sValid[k] = c_valid[k];
  }
  const Scan sc = scan_of(scratch);
  long long live = *n_cells;
  live = live < 0 ? 0 : (live > nc ? nc : live);
  // tile 0 always runs: it writes *n_total when no cell is live
  const long long tiles =
      live > 0 ? (live + kTileCells - 1) / kTileCells : 1;
  const int lane = threadIdx.x & 31;
  // a cell's 4 threads: thread p gathers corners 2p and 2p + 1 (x = 0, 1 at
  // y = p & 1, z = p >> 1), adjacent in memory
  const int c = threadIdx.x >> 2, pair = threadIdx.x & 3;
  for (long long tile; (tile = next_tile(sc, tiles, &sTile)) >= 0;) {
    const long long i = tile * kTileCells + c;
    const bool alive = i < live;
    float2 v = make_float2(0.0f, 0.0f);
    int x = 0, y = 0, z = 0;
    if (alive) {
      x = static_cast<int>(cx[i]);
      y = static_cast<int>(cy[i]);
      z = static_cast<int>(cz[i]);
      const long long at = corner_lin(g, x, y, z, 2 * pair);
      v = make_float2(occ[at], occ[at + 1]);
    }
    reinterpret_cast<float2*>(sv)[threadIdx.x] = v;
    // the cell's 8 inside bits, from its 4 threads' 2 each
    unsigned bits = ((v.x > iso ? 1u : 0u) | (v.y > iso ? 2u : 0u))
                    << (2 * pair);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
    if (pair == 0) {
      unsigned mask = 0, packed = 0;
#pragma unroll
      for (int t = 0; t < 6; ++t) {
        unsigned cs = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) cs |= ((bits >> c_tets[t][k]) & 1u) << k;
        packed |= cs << (4 * t);
        mask |= static_cast<unsigned>(sValid[(t * 16 + cs) * 2]) << (2 * t);
        mask |= static_cast<unsigned>(sValid[(t * 16 + cs) * 2 + 1])
                << (2 * t + 1);
      }
      sMask[c] = static_cast<unsigned short>(alive ? mask : 0u);
      sCases[c] = packed;
      sxyz[0][c] = x;
      sxyz[1][c] = y;
      sxyz[2][c] = z;
    }
    __syncthreads();
    if (threadIdx.x < 32) {          // warp 0: kCellsPerLane cells a lane
      int n[kCellsPerLane], mine = 0;
#pragma unroll
      for (int k = 0; k < kCellsPerLane; ++k) {
        n[k] = __popc(sMask[lane * kCellsPerLane + k]);
        mine += n[k];
      }
      int incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y2 = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y2;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      // the aggregate first, so that later tiles need not wait for ours
      if (lane == 0) {
        atomicExch(sc.status + tile,
                   (tile == 0 ? kInclusive : kAggregate) |
                       static_cast<unsigned long long>(total));
        sCount = total;
      }
      int before = incl - mine;
#pragma unroll
      for (int k = 0; k < kCellsPerLane; ++k) {
        sBefore[lane * kCellsPerLane + k] = before;
        before += n[k];
      }
    }
    __syncthreads();
    {                                // the cell's slots 3 pair .. 3 pair + 2
      const unsigned m = sMask[c];
      int at = sBefore[c] + __popc(m & ((1u << (3 * pair)) - 1u));
      for (int s = 3 * pair; s < 3 * pair + 3; ++s)
        if ((m >> s) & 1u)
          sTri[at++] = static_cast<unsigned short>((c << 4) | s);
    }
    if (threadIdx.x < 32) {          // warp 0 looks back meanwhile
      unsigned long long first = 0;
      if (tile > 0) {
        first = look_back(sc.status, tile);
        if (lane == 0)
          atomicExch(sc.status + tile,
                     kInclusive | (first + static_cast<unsigned>(sCount)));
      }
      if (lane == 0) {
        sFirst = first;
        if (tile == tiles - 1)
          *n_total = static_cast<long long>(first) + sCount;
      }
    }
    __syncthreads();
    const long long first = static_cast<long long>(sFirst);
    // the tile's vertex slots below max_tris * 3
    const long long room = (max_tris - first) * 3;
    const int n_slots = static_cast<int>(
        room < 3 * sCount ? (room > 0 ? room : 0) : 3 * sCount);
    for (int q = threadIdx.x; q < n_slots; q += kEmitThreads) {
      const int tri = q / 3, j = q - 3 * tri;
      const unsigned entry = sTri[tri];
      const int cl = entry >> 4, s = entry & 15;
      const int t = s >> 1;
      const int e = (t * 16 + ((sCases[cl] >> (4 * t)) & 15u)) * 2 + (s & 1);
      const int a = sA[e * 3 + j], b = sB[e * 3 + j];
      const float va = sv[cl * 8 + a], vb = sv[cl * 8 + b];
      const float den = __fsub_rn(vb, va);
      float tt = fabsf(den) < 1e-12f ? 0.5f
                                     : __fdiv_rn(__fsub_rn(iso, va), den);
      tt = fminf(fmaxf(tt, 0.0f), 1.0f);
      const long long x0 = sxyz[0][cl], y0 = sxyz[1][cl], z0 = sxyz[2][cl];
      const int ax = a & 1, ay = (a >> 1) & 1, az = (a >> 2) & 1;
      const int bx = b & 1, by = (b >> 1) & 1, bz = (b >> 2) & 1;
      const long long o = first * 3 + q;
      tvx[o] = __fadd_rn(static_cast<float>(x0 + ax),
                         __fmul_rn(tt, static_cast<float>(bx - ax)));
      tvy[o] = __fadd_rn(static_cast<float>(y0 + ay),
                         __fmul_rn(tt, static_cast<float>(by - ay)));
      tvz[o] = __fadd_rn(static_cast<float>(z0 + az),
                         __fmul_rn(tt, static_cast<float>(bz - az)));
      const long long la = corner_lin(g, x0, y0, z0, a);
      const long long lb = corner_lin(g, x0, y0, z0, b);
      const int dir = abs(bx - ax) + 2 * abs(by - ay) + 4 * abs(bz - az);
      teid[o] = (la < lb ? la : lb) * 8 + dir;
    }
  }
}

// The first live slot of this warp's first stride, the stride, and the
// live slot count 3 * *n_tris (at most n_slots). Lanes walk warp-aligned
// windows so that a whole warp enters each window.
struct Slots {
  long long begin, stride, live;
};

__device__ __forceinline__ Slots slots_of(const long long* n_tris,
                                          long long n_slots) {
  long long live = 3 * *n_tris;
  live = live < 0 ? 0 : (live > n_slots ? n_slots : live);
  return Slots{static_cast<long long>(blockIdx.x) * blockDim.x +
                   (threadIdx.x & ~31),
               static_cast<long long>(gridDim.x) * blockDim.x, live};
}

__global__ void __launch_bounds__(kThreads)
index_clear_kernel(const long long* __restrict__ teid,
                   const long long* __restrict__ n_tris, long long n_slots,
                   unsigned* __restrict__ bitmap) {
  const Slots sl = slots_of(n_tris, n_slots);
  for (long long i = sl.begin + (threadIdx.x & 31); i < sl.live;
       i += sl.stride)
    bitmap[teid[i] >> 5] = 0;
}

__global__ void __launch_bounds__(kThreads)
index_mark_kernel(const long long* __restrict__ teid,
                  const long long* __restrict__ n_tris, long long n_slots,
                  unsigned* __restrict__ bitmap,
                  unsigned* __restrict__ summary) {
  const Slots sl = slots_of(n_tris, n_slots);
  const int lane = threadIdx.x & 31;
  for (long long base = sl.begin; base < sl.live; base += sl.stride) {
    const long long i = base + lane;
    const long long e = i < sl.live ? teid[i] : -1;
    const long long w = e >> 5;                      // -1 for idle lanes
    const unsigned peers = __match_any_sync(0xffffffffu, w);
    const unsigned word_bits =
        __reduce_or_sync(peers, e >= 0 ? 1u << (e & 31) : 0u);
    if (e >= 0 && lane == __ffs(peers) - 1) {
      const unsigned old = atomicOr(bitmap + w, word_bits);
      if (old == 0) atomicOr(summary + (w >> 5), 1u << (w & 31));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
index_scan_kernel(long long n_sum, const unsigned* __restrict__ bitmap,
                  const unsigned* __restrict__ summary,
                  int2* __restrict__ sum_rank, int2* __restrict__ word_rank,
                  long long* __restrict__ n_unique,
                  unsigned long long* __restrict__ scratch) {
  __shared__ unsigned long long warp_sums[kThreads / 32];
  __shared__ long long sTile;
  __shared__ unsigned long long sBefore;
  const Scan sc = scan_of(scratch);
  const long long tiles = (n_sum + kThreads - 1) / kThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long tile; (tile = next_tile(sc, tiles, &sTile)) >= 0;) {
    // this thread's summary word and the bitmap words under its bits
    const long long s0 = tile * kThreads + threadIdx.x;
    const unsigned sb = s0 < n_sum ? summary[s0] : 0u;
    const unsigned* words_of = bitmap + s0 * 32;
    const unsigned words = __popc(sb);
    unsigned ids = 0;
    for (unsigned r = sb; r; r &= r - 1)
      ids += __popc(words_of[__ffs(r) - 1]);
    const unsigned long long mine =
        words | (static_cast<unsigned long long>(ids) << kIdShift);
    // block-wide exclusive scan of the packed counts
    unsigned long long incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      unsigned long long ws = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < kThreads / 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xffffffffu, ws, o);
        if (lane >= o) ws += y;
      }
      const unsigned long long total =
          __shfl_sync(0xffffffffu, ws, kThreads / 32 - 1);
      if (lane == 0)
        atomicExch(sc.status + tile,
                   (tile == 0 ? kInclusive : kAggregate) | total);
      unsigned long long before = 0;
      if (tile > 0) {
        before = look_back(sc.status, tile);
        if (lane == 0)
          atomicExch(sc.status + tile, kInclusive | (before + total));
      }
      if (lane < kThreads / 32) warp_sums[lane] = ws;   // inclusive
      if (lane == 0) {
        sBefore = before;
        if (tile == tiles - 1)
          *n_unique = static_cast<long long>((before + total) >> kIdShift);
      }
    }
    __syncthreads();
    if (words) {
      const unsigned long long at = sBefore +
          (warp ? warp_sums[warp - 1] : 0ull) + incl - mine;
      int k = static_cast<int>(at & kWordMask);
      int id = static_cast<int>(at >> kIdShift);
      sum_rank[s0] = make_int2(k, static_cast<int>(sb));
      for (unsigned r = sb; r; r &= r - 1) {
        const unsigned wb = words_of[__ffs(r) - 1];
        word_rank[k++] = make_int2(id, static_cast<int>(wb));
        id += __popc(wb);
      }
    }
    __syncthreads();                 // warp_sums and sBefore reused
  }
}

__global__ void __launch_bounds__(kThreads)
index_write_kernel(const long long* __restrict__ teid,
                   const float* __restrict__ tvx,
                   const float* __restrict__ tvy,
                   const float* __restrict__ tvz,
                   const long long* __restrict__ n_tris, long long n_slots,
                   const int2* __restrict__ sum_rank,
                   const int2* __restrict__ word_rank, long long max_verts,
                   int* __restrict__ faces, float* __restrict__ vx,
                   float* __restrict__ vy, float* __restrict__ vz) {
  const Slots sl = slots_of(n_tris, n_slots);
  const long long first = sl.begin + (threadIdx.x & 31);
  for (long long i = first; i < sl.live; i += sl.stride) {
    const long long e = teid[i];
    const long long w = e >> 5;
    const int2 sr = sum_rank[w >> 5];
    const int k = sr.x + __popc(static_cast<unsigned>(sr.y) &
                                ((1u << (w & 31)) - 1u));
    const int2 wr = word_rank[k];
    const int r = wr.x + __popc(static_cast<unsigned>(wr.y) &
                                ((1u << (e & 31)) - 1u));
    faces[i] = r;
    if (r < max_verts) {
      vx[r] = tvx[i];
      vy[r] = tvy[i];
      vz[r] = tvz[i];
    }
  }
  for (long long i = sl.live + first; i < n_slots; i += sl.stride)
    faces[i] = 0;                    // the dead slots
}

// The resident blocks of a kernel on the current card (its SMs times the
// occupancy calculator's blocks an SM), asked of the runtime once a card
// and kernel (`which`).
std::atomic<int> g_resident[kMaxDevices][5];

// min(the kernel's resident blocks, ceil(work / per_block)), at least 1
template <typename Kernel>
cudaError_t grid_for(int which, Kernel kernel, int threads, long long work,
                     long long per_block, unsigned* grid) {
  int dev = 0, fit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* kept =
      dev < kMaxDevices ? &g_resident[dev][which] : nullptr;
  if (!kept || (fit = kept->load(std::memory_order_relaxed)) <= 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, 0);
    if (err != cudaSuccess) return err;
    fit = sms * (per_sm > 0 ? per_sm : 1);
    if (kept) kept->store(fit, std::memory_order_relaxed);
  }
  long long need = (work + per_block - 1) / per_block;
  need = need < 1 ? 1 : need;
  *grid = static_cast<unsigned>(need < fit ? need : fit);
  return cudaSuccess;
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

// Cells a tile of mt_emit's scan (its scratch holds 1 + ceil(nc / this)
// words).
int icon_mt_emit_tile_cells() { return kTileCells; }

// Summary words a tile of mt_index's scan (its scratch holds 1 +
// ceil(n_sum / this) words).
int icon_mt_index_tile_words() { return kThreads; }

// occ [D, H, W] f32; cx, cy, cz [nc] int64 cell coordinates (cells past
// *n_cells are dead); scratch [1 + ceil(nc / 128)] u64 (any contents:
// zeroed here on the stream before the launch); writes the triangles'
// vertex slots tvx, tvy, tvz [max_tris * 3] f32 and teid [max_tris * 3]
// int64 (rows past the total left as the caller filled them) and *n_total
// (int64), the triangle count before the max_tris cut. Returns a
// cudaError_t.
int icon_mt_emit(const float* occ, int D, int H, int W, const long long* cx,
                 const long long* cy, const long long* cz,
                 const long long* n_cells, int nc, float iso,
                 long long max_tris, unsigned long long* scratch, float* tvx,
                 float* tvy, float* tvz, long long* teid, long long* n_total,
                 void* stream) {
  if (D < 2 || H < 2 || W < 2 || nc < 1 || max_tris < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid = 0;
  cudaError_t err = grid_for(0, emit_kernel, kEmitThreads, nc,
                             kTileCells, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = 1 + (nc + kTileCells - 1) / kTileCells;
  err = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  emit_kernel<<<grid, kEmitThreads, 0, s>>>(
      occ, Grid{D, H, W}, cx, cy, cz, n_cells, nc, iso, max_tris, tvx, tvy,
      tvz, teid, n_total, scratch);
  return static_cast<int>(cudaGetLastError());
}

// teid, tvx, tvy, tvz [n_slots] (3 slots a triangle, the first 3 * *n_tris
// live, ids below n_sum * 1024); bitmap [n_sum * 32] u32 (any contents);
// summary [n_sum] u32 and scratch [1 + ceil(n_sum / 256)] u64 (any
// contents: zeroed here on the stream before the first pass); sum_rank
// [n_sum] and word_rank [min(n_slots, n_sum * 32)] int2 (scratch, never
// cleared). Writes faces [n_slots] i32
// (each live slot's vertex rank, 0 elsewhere), the vertex table vx, vy, vz
// [max_verts] in ascending edge-id order (rows past the count untouched)
// and *n_unique (int64), the count of distinct ids. Returns a
// cudaError_t.
int icon_mt_index(const long long* teid, const float* tvx, const float* tvy,
                  const float* tvz, const long long* n_tris,
                  long long n_slots, long long n_sum, unsigned* bitmap,
                  unsigned* summary, unsigned long long* scratch,
                  int* sum_rank, int* word_rank, long long max_verts,
                  int* faces, float* vx, float* vy, float* vz,
                  long long* n_unique, void* stream) {
  if (n_slots < 1 || n_slots >= (1LL << 31) || n_sum < 1 || max_verts < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long scan_words = 1 + (n_sum + kThreads - 1) / kThreads;
  cudaError_t err = cudaMemsetAsync(summary, 0, n_sum * sizeof(unsigned), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0,
                          scan_words * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  err = grid_for(1, index_clear_kernel, kThreads, n_slots, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  index_clear_kernel<<<grid, kThreads, 0, s>>>(teid, n_tris, n_slots,
                                               bitmap);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = grid_for(2, index_mark_kernel, kThreads, n_slots, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  index_mark_kernel<<<grid, kThreads, 0, s>>>(teid, n_tris, n_slots, bitmap,
                                              summary);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = grid_for(3, index_scan_kernel, kThreads, n_sum, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  index_scan_kernel<<<grid, kThreads, 0, s>>>(
      n_sum, bitmap, summary, reinterpret_cast<int2*>(sum_rank),
      reinterpret_cast<int2*>(word_rank), n_unique, scratch);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = grid_for(4, index_write_kernel, kThreads, n_slots, kThreads,
                   &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  index_write_kernel<<<grid, kThreads, 0, s>>>(
      teid, tvx, tvy, tvz, n_tris, n_slots,
      reinterpret_cast<const int2*>(sum_rank),
      reinterpret_cast<const int2*>(word_rank), max_verts, faces, vx, vy,
      vz);
  return static_cast<int>(cudaGetLastError());
}

const char* icon_mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
