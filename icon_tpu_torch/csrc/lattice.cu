// The serving marcher's lattice on sm_90a: the active cells, the emit of
// the lattice vertices and the decode of the mesh on the card.
//
// Stands for icon_tpu/recon/marching.py:_active_cells (l.168-246) with
// _compact_indices (l.132-149), _lattice_emit (l.542-586) and the host
// decode of the lattice wire, decode_lattice (l.749) in
// icon_tpu/native/src/latticecodec.cc:77-150. The JAX package computes the
// first two as whole-grid XLA passes and top_k compactions shaped for the
// TPU, and sends the lattice's generators to a host core, which rebuilds
// the faces. Here the three stages are kernels, and the mesh leaves the
// card whole.
//
// lattice_cells (one launch): a single-pass scan with decoupled look-back
// (Merrill and Garland) over wide tiles of the scanned grid's cells (the
// coarse grid's, or without one the fine grid's), in the order of an
// atomic ticket. A tile is whole rows of cells along x, at most 4,096
// cells as 128 words of 32 cells (at 257^3 the 128^3 coarse cells make 512
// tiles of 32 rows, about one wave of resident blocks; tiles of 256 cells,
// a thread a cell, were 8,192, each paying a ticket, a look-back and a
// fence for 8 loads a thread). 1. A warp takes a 32-cell chunk of up to 4 rows of a
// plane: each lane loads one point of each of the 5 point rows of the 2
// planes (coalesced; lane 0 also the point past the chunk), a ballot makes
// each point row's inside bits, and shifts with ANDs and ORs of two rows x
// two planes give the chunk's mixed cells as one word; each point is read
// by at most 2 row batches and 2 planes. 2. The tile's mixed cells are
// listed in shared memory in linear order (a scan of the words' popcounts).
// 3. With a coarse grid, a lane takes a (mixed cell, fine cell) pair and
// tests the fine cell exactly on its own 8 corners (the fine grid is the
// coarse one's 2x align_corners upsample sliced by one, so coarse cell c
// covers fine cells 2c - 1 and 2c an axis); a ballot gives each mixed
// cell's byte of alive fine cells, and a scan their slots within the tile.
// No lane holds a mixed cell's 27 points, and no warp waits on one lane.
// 4. The scan sums two counts a tile, packed in one word: mixed coarse
// cells, and alive fine cells. A mixed cell's rank among the mixed cells
// says whether it lies within the candidate budget (the first nc_budget);
// within it, its alive fine cells take the slots from its alive count's
// prefix on, in the fine cells' corner order: the candidate order of
// _compact. Since the cells within the budget are a prefix of the linear
// order, the prefix of the alive counts over all mixed cells is exact for
// every cell within the budget. Slots past max_cells are dropped. 5. A
// lane a pair writes the cell's coordinates, linear id and 8 corner
// values. The tile holding the budget's last mixed cell publishes the end
// of its slots, flagged, before its inclusive status; the last tile in scan
// order writes n_cells = min(alive, max_cells) and n_cells_total = alive +
// 8 max(mixed - nc_budget, 0) once its look-back is done, waiting for that
// flag where the budget is exceeded (its look-back can pass over the budget
// tile's aggregate, so the inclusive statuses alone do not order the two).
// Without a coarse grid the fine grid's mixed cells are the alive ones,
// with no budget. The C entry zeroes the outputs, so rows past n_cells are
// 0, and the scan's scratch.
//
// lattice_emit (five launches): every vertex is a crossing lattice edge
// that one alive cell owns (the 19 slots of
// recon/lattice_host.py:_build_edge_slots), so the vertices are distinct
// by construction and their edge ids lie below D H W 8.
// 1. emit: a single-pass scan over tiles of 256 alive cells, a thread a
//    cell: its corner byte, its owned crossing slots, each slot's fraction
//    s = clamp((iso - v_lo) / (v_hi - v_lo), 0, 1) and edge id
//    plin * 8 + dir. The slots take the positions of the scan in linear
//    (cell, slot) order, the first max_verts kept: the compaction of the
//    JAX package. Rows past the live cells get a corner byte of 0.
// 2.-5. the vertices in ascending edge-id order without a sort, as
//    csrc/marching.cu's mt_index ranks them: a bitmap of the edge ids (one
//    bit an id; only the words of kept ids are cleared and read), its
//    summary (a bit a bitmap word, zeroed by the C entry), a scan of the
//    summary giving each touched summary word its touched words before it
//    (sum_rank) and each touched bitmap word its ids before it and its
//    bits (word_rank), and a write of each kept (id, s) at its rank. The
//    rows past the kept count get the id INT64_MAX and s = 0. The summary,
//    sum_rank and word_rank stay with the lattice for the decode (the
//    bitmap does not: word_rank holds the bits of every touched word).
//
// lattice_decode (one launch): the host decoder's mesh from the emit's
// outputs, written into one int32 buffer [header 4 | verts 3 nvb f32 |
// faces 3 nfb i32] that one copy takes to the host. A single-pass scan
// over tiles of 128 cells, a cell a thread (at 257^3's 47,002 cells, 368
// tiles: with 28 KB of shared memory a block, 8 blocks an SM fit, so the
// tiles run in one wave and each look-back reads at most 12 windows of 32
// statuses; two cells a thread would halve the tiles and leave SMs idle).
// A cell's corner byte gives, through a table built from the codec's
// (tet, case) tables, the edge slots its faces use and the faces as slot
// triples in the codec's order (tet, then triangle). Each used slot's
// edge id is ranked in O(1) through the emit's tables, as place_kernel
// ranks it: if the summary bit of word w = e >> 5 is clear, the id is no
// vertex; else k = sum_rank[w >> 5].x + the summary bits below w, and the
// rank is word_rank[k].x + its bits below e if bit e & 31 of word_rank[k].y
// is set, else the id is no vertex. Two dependent loads, issued for every
// slot of the cell at once, where a binary search over the sorted ids
// makes ~18 for each face corner. A face whose edge is no vertex (dropped by an overflow) or
// whose ranks repeat is dropped, as csrc/latticecodec.cc:137-140 drops
// it. The tile's faces are staged in shared memory at their in-tile prefix
// and written as the tile's one contiguous run, 16-byte stores, the first
// nfb. Each block then writes vertices: s quantized as pack_lattice
// quantizes it (rint(s * 255), clamped to [0, 255]), s8 / 255 by exact
// division and lo + s8 / 255 * d an axis, each operation rounded on its
// own (no contraction), as the host decoder computes them. The header
// holds (vertices, faces, cells, 0), the true counts; the host reads an
// overflow where they exceed nvb or nfb. A lattice without the emit's
// tables (released, or not from the emit) gets them anew from its sorted
// ids: the emit's launches 3-5 on them (icon_lattice_rank).
//
// Bound: bytes. lattice_cells reads the coarse grid and the fine points of
// the mixed coarse cells and writes 64 B a row (the zeroed rows too);
// lattice_emit reads 56 B an alive cell and writes 12 B a vertex twice and
// 4 B a cell; lattice_decode reads 12 B an alive cell and 12 B a vertex and
// writes 12 B a vertex and 12 B a face. The cells kernel and the decode
// are latency-bound (dependent loads, ballots and scans on little data);
// their designs cut the dependent steps a tile and the tiles. What is left
// of the cells kernel's time is each tile's chain of dependent steps (a
// warp's 4 load rounds, two block scans, the expansion's loads, the
// writes), not its look-back: the whole block looking back 256 statuses a
// step in place of a warp's 32 measured no faster at 257^3 and slower at
// 513^3 (kernels/profile_lattice.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;          // cells a tile of cells and emit
constexpr int kDecodeThreads = 128;    // cells a tile of decode
constexpr int kMaxDevices = 16;

// a look-back status: the flag in bits 62-63, a sum in bits 0-61
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kSumBits = (1ull << 62) - 1;
constexpr unsigned kMaxSpins = 1u << 24;
// two counts below 2^31 in one scanned word: bits 0-30 and 31-61
constexpr int kHiShift = 31;
constexpr unsigned long long kLoMask = (1ull << kHiShift) - 1;
constexpr long long kInt64Max = 0x7fffffffffffffffll;

// the 19 owned edge slots: (lo corner, hi corner, direction code)
__constant__ unsigned char c_slots[19 * 3];
// per corner byte, from the host codec's tables
// (kernels/lattice.py:_cell_face_tables): the edge slots its faces use (a
// bit a slot), its faces (valid triangles) and their slot triples in the
// codec's order (tet, then triangle); read by each thread at its own byte
__device__ unsigned g_cell_slots[256];
__device__ unsigned char g_cell_nf[256];
__device__ unsigned char g_cell_faces[256 * 36];

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The sum of the tiles before tile t > 0, from their statuses (32 tiles a
// step: lane l reads tile top - l). A whole warp calls it.
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

// The block's exclusive prefix of `mine` (every thread calls it) and the
// tile's sum in *total; `warp_sums` is shared [32].
__device__ unsigned long long block_scan(unsigned long long mine,
                                         unsigned long long* total,
                                         unsigned long long* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned long long incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned long long ws = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += y;
    }
    if (lane < warps) warp_sums[lane] = ws;            // inclusive
  }
  __syncthreads();
  const unsigned long long before =
      (warp ? warp_sums[warp - 1] : 0ull) + incl - mine;
  *total = warp_sums[warps - 1];
  __syncthreads();                   // warp_sums reused by the next call
  return before;
}

// The sum of the tiles before `tile` (every thread calls it): publishes
// the tile's `total`, looks back, publishes the inclusive sum.
__device__ unsigned long long tile_prefix(const Scan& sc, long long tile,
                                          unsigned long long total,
                                          unsigned long long* s_before) {
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      atomicExch(sc.status + tile,
                 (tile == 0 ? kInclusive : kAggregate) | total);
    unsigned long long before = 0;
    if (tile > 0) {
      before = look_back(sc.status, tile);
      if (threadIdx.x == 0)
        atomicExch(sc.status + tile, kInclusive | (before + total));
    }
    if (threadIdx.x == 0) *s_before = before;
  }
  __syncthreads();
  const unsigned long long before = *s_before;
  __syncthreads();                   // s_before reused by the next tile
  return before;
}

struct Strided {                     // a [D, H, W] float32 view
  const float* p;
  int D, H, W;
  long long sD, sH, sW;              // element strides
  __device__ __forceinline__ float at(long long z, long long y,
                                      long long x) const {
    return __ldg(p + z * sD + y * sH + x * sW);
  }
};

// lattice_cells: 8 warps a block; tiles of whole rows, at most
// kCellsTileWords words of 32 cells; a warp loads kCellsBatch rows at once
constexpr int kCellsThreads = 256;
constexpr int kCellsTileCells = 4096;
constexpr int kCellsTileWords = kCellsTileCells / 32;
constexpr int kCellsBatch = 4;
static_assert(kCellsTileWords <= kCellsThreads, "a thread a word");

// lattice_cells' scratch words before the scan's
constexpr int kCellsAlive = 0;       // the budget's last slot end, flagged
constexpr int kCellsScan = 1;        // the scan's ticket and statuses

// The scanned grid's cells and the tiles over them.
struct CellsGrid {
  int iw, ih;                        // cells a row, rows a plane
  long long rows;                    // rows in all
  int cpr;                           // 32-cell words a row
  int tile_rows;                     // rows a tile: kCellsTileWords / cpr
  long long tiles;
};

struct CellsOut {
  long long *cx, *cy, *cz, *cid;
  float* cvals;                      // [max_cells, 8]
  long long *n_cells, *n_cells_total;
};

__device__ __forceinline__ void write_cell(const CellsOut& o, long long slot,
                                           int x, int y, int z, int cw,
                                           int ch, const float* v8) {
  o.cx[slot] = x;
  o.cy[slot] = y;
  o.cz[slot] = z;
  o.cid[slot] = (static_cast<long long>(z) * ch + y) * cw + x;
  float4* dst = reinterpret_cast<float4*>(o.cvals + slot * 8);
  dst[0] = make_float4(v8[0], v8[1], v8[2], v8[3]);
  dst[1] = make_float4(v8[4], v8[5], v8[6], v8[7]);
}

// The 8 corner values of cell (x, y, z) of g, corner c = x + 2y + 4z.
__device__ __forceinline__ void corners(const Strided& g, int x, int y, int z,
                                        float* v8) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
    v8[c] = g.at(z + ((c >> 2) & 1), y + ((c >> 1) & 1), x + (c & 1));
}

// The inside bits of points x = 32 w .. 32 w + 32 of point rows y .. y + nb
// of planes z (a) and z + 1 (b): bit j for x = 32 w + j, 0 past the row.
// A whole warp calls it; the loads of all rows are in flight at once.
__device__ __forceinline__ void inside_rows(const Strided& g, int z, int y,
                                            int w, int nb, float iso,
                                            unsigned long long* a,
                                            unsigned long long* b) {
  const int lane = threadIdx.x & 31;
  const int x = 32 * w + lane;
  const bool mine = x < g.W, past = lane == 0 && x + 32 < g.W;
  float va[kCellsBatch + 1], vb[kCellsBatch + 1];
  float ea[kCellsBatch + 1], eb[kCellsBatch + 1];
#pragma unroll
  for (int j = 0; j <= kCellsBatch; ++j) {
    const bool row = j <= nb;        // iso itself reads as outside
    va[j] = row && mine ? g.at(z, y + j, x) : iso;
    vb[j] = row && mine ? g.at(z + 1, y + j, x) : iso;
    ea[j] = row && past ? g.at(z, y + j, x + 32) : iso;
    eb[j] = row && past ? g.at(z + 1, y + j, x + 32) : iso;
  }
#pragma unroll
  for (int j = 0; j <= kCellsBatch; ++j) {
    a[j] = __ballot_sync(0xffffffffu, va[j] > iso) |
           static_cast<unsigned long long>(
               __ballot_sync(0xffffffffu, ea[j] > iso)) << 32;
    b[j] = __ballot_sync(0xffffffffu, vb[j] > iso) |
           static_cast<unsigned long long>(
               __ballot_sync(0xffffffffu, eb[j] > iso)) << 32;
  }
}

// The mixed cells of a 32-cell word from the inside bits of its 4 point
// rows: cell j spans points j and j + 1 of each.
__device__ __forceinline__ unsigned mixed_word(unsigned long long a0,
                                               unsigned long long a1,
                                               unsigned long long b0,
                                               unsigned long long b1) {
  const unsigned long long all = a0 & a1 & b0 & b1, any = a0 | a1 | b0 | b1;
  return static_cast<unsigned>(any | (any >> 1)) &
         ~static_cast<unsigned>(all & (all >> 1));
}

__global__ void __launch_bounds__(kCellsThreads)
cells_kernel(Strided fine, Strided g, CellsGrid cg, bool use_coarse,
             float iso, long long nc_budget, long long max_cells,
             CellsOut out, unsigned long long* __restrict__ scratch) {
  __shared__ unsigned long long warp_sums[32];
  __shared__ unsigned long long sBefore;
  __shared__ long long sTile;
  __shared__ unsigned sMix[kCellsTileWords];      // mixed bits, row-major
  __shared__ unsigned short sList[kCellsTileCells];   // mixed cells in order
  __shared__ unsigned short sSlot[kCellsTileCells];   // their slots in tile
  __shared__ unsigned char sAlive[kCellsTileCells];   // their alive cells
  const Scan sc = scan_of(scratch + kCellsScan);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cw = fine.W - 1, ch = fine.H - 1, cd = fine.D - 1;
  for (long long tile; (tile = next_tile(sc, cg.tiles, &sTile)) >= 0;) {
    const long long row0 = tile * cg.tile_rows;
    const int nrows = static_cast<int>(
        cg.rows - row0 < cg.tile_rows ? cg.rows - row0 : cg.tile_rows);
    // 1. the mixed bits, a warp a (word, batch of rows) unit
    const int batches = (nrows + kCellsBatch - 1) / kCellsBatch;
    for (int u = warp; u < batches * cg.cpr; u += kCellsThreads / 32) {
      const int w = u % cg.cpr;
      const int left = cg.iw - 32 * w;
      const unsigned valid = left >= 32 ? 0xffffffffu : (1u << left) - 1u;
      int r = (u / cg.cpr) * kCellsBatch;
      const int r_end = min(r + kCellsBatch, nrows);
      while (r < r_end) {            // twice where the batch ends a plane
        const long long gr = row0 + r;
        const int y = static_cast<int>(gr % cg.ih);
        const int z = static_cast<int>(gr / cg.ih);
        const int nb = min(r_end - r, cg.ih - y);
        unsigned long long a[kCellsBatch + 1], b[kCellsBatch + 1];
        inside_rows(g, z, y, w, nb, iso, a, b);
#pragma unroll
        for (int j = 0; j < kCellsBatch; ++j)
          if (j < nb && lane == 0)
            sMix[(r + j) * cg.cpr + w] =
                mixed_word(a[j], a[j + 1], b[j], b[j + 1]) & valid;
        r += nb;
      }
    }
    __syncthreads();
    // 2. the mixed cells listed in linear order (in-tile cell indices)
    const int words = nrows * cg.cpr;
    unsigned long long n_mixed;
    {
      const int t = threadIdx.x;
      const unsigned m = t < words ? sMix[t] : 0u;
      int k = static_cast<int>(block_scan(__popc(m), &n_mixed, warp_sums));
      const int base = (t / cg.cpr) * cg.iw + 32 * (t % cg.cpr);
      for (unsigned r = m; r; r &= r - 1)
        sList[k++] = static_cast<unsigned short>(base + __ffs(r) - 1);
    }
    __syncthreads();
    const int M = static_cast<int>(n_mixed);
    // 3. each mixed coarse cell's alive fine cells, a lane a pair
    unsigned long long tile_total =
        static_cast<unsigned long long>(M) << kHiShift;
    if (use_coarse) {
      for (int p0 = 0; p0 < 8 * M; p0 += kCellsThreads) {
        const int p = p0 + threadIdx.x, k = p & 7;
        bool alive = false;
        if (p < 8 * M) {
          const int idx = sList[p >> 3];
          const long long gr = row0 + idx / cg.iw;
          const int fx = 2 * (idx % cg.iw) - 1 + (k & 1);
          const int fy = 2 * static_cast<int>(gr % cg.ih) - 1 + ((k >> 1) & 1);
          const int fz = 2 * static_cast<int>(gr / cg.ih) - 1 + ((k >> 2) & 1);
          if (fx >= 0 && fx < cw && fy >= 0 && fy < ch && fz >= 0 &&
              fz < cd) {
            float v8[8];
            corners(fine, fx, fy, fz, v8);
            unsigned in = 0;
#pragma unroll
            for (int c = 0; c < 8; ++c) in |= (v8[c] > iso) << c;
            alive = in != 0 && in != 0xffu;
          }
        }
        const unsigned bits = __ballot_sync(0xffffffffu, alive);
        if (p < 8 * M && k == 0)
          sAlive[p >> 3] = static_cast<unsigned char>(bits >> (lane & 24));
      }
      __syncthreads();
      // their slots within the tile: a thread a run of mixed cells
      const int per = (M + kCellsThreads - 1) / kCellsThreads;
      const int j0 = min(M, static_cast<int>(threadIdx.x) * per);
      const int j1 = min(M, j0 + per);
      int sum = 0;
      for (int j = j0; j < j1; ++j) sum += __popc(sAlive[j]);
      unsigned long long n_alive;
      int at = static_cast<int>(block_scan(sum, &n_alive, warp_sums));
      for (int j = j0; j < j1; ++j) {
        sSlot[j] = static_cast<unsigned short>(at);
        at += __popc(sAlive[j]);
      }
      tile_total = static_cast<unsigned long long>(M) |
                   (n_alive << kHiShift);
      __syncthreads();
    }
    // 4. the tiles before this one; the budget's last cell and the counts
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0)
        atomicExch(sc.status + tile,
                   (tile == 0 ? kInclusive : kAggregate) | tile_total);
      const unsigned long long before =
          tile > 0 ? look_back(sc.status, tile) : 0ull;
      if (threadIdx.x == 0) {
        const long long last =
            nc_budget - 1 - static_cast<long long>(before & kLoMask);
        if (use_coarse && last >= 0 && last < M)
          atomicExch(scratch + kCellsAlive,
                     kInclusive | ((before >> kHiShift) + sSlot[last] +
                                   __popc(sAlive[last])));
        if (tile > 0)
          atomicExch(sc.status + tile, kInclusive | (before + tile_total));
        sBefore = before;
        if (tile == cg.tiles - 1) {
          const unsigned long long tot = before + tile_total;
          const long long m = static_cast<long long>(tot & kLoMask);
          long long n_alive = static_cast<long long>(tot >> kHiShift);
          const bool over = use_coarse && m > nc_budget;
          if (over) {
            n_alive = 0;
            if (nc_budget > 0) {
              unsigned long long s;
              // a flag that never comes is a fault (scratch not zero on
              // entry): fail the launch rather than spin on
              for (unsigned spins = 0;
                   ((s = load_status(scratch + kCellsAlive)) >> 62) == 0;)
                if (++spins == kMaxSpins) __trap();
              n_alive = static_cast<long long>(s & kSumBits);
            }
          }
          *out.n_cells = n_alive < max_cells ? n_alive : max_cells;
          *out.n_cells_total = n_alive + (over ? 8 * (m - nc_budget) : 0);
        }
      }
    }
    __syncthreads();
    const unsigned long long before = sBefore;
    const long long mixed_before = static_cast<long long>(before & kLoMask);
    const long long slot0 = static_cast<long long>(before >> kHiShift);
    // 5. the rows: a lane a (mixed cell, fine cell) pair, or a mixed cell
    if (use_coarse) {
      for (int p = threadIdx.x; p < 8 * M; p += kCellsThreads) {
        const int j = p >> 3, k = p & 7;
        const unsigned al = sAlive[j];
        if (mixed_before + j >= nc_budget || !((al >> k) & 1u)) continue;
        const long long slot =
            slot0 + sSlot[j] + __popc(al & ((1u << k) - 1u));
        if (slot >= max_cells) continue;
        const int idx = sList[j];
        const long long gr = row0 + idx / cg.iw;
        const int fx = 2 * (idx % cg.iw) - 1 + (k & 1);
        const int fy = 2 * static_cast<int>(gr % cg.ih) - 1 + ((k >> 1) & 1);
        const int fz = 2 * static_cast<int>(gr / cg.ih) - 1 + ((k >> 2) & 1);
        float v8[8];
        corners(fine, fx, fy, fz, v8);
        write_cell(out, slot, fx, fy, fz, cw, ch, v8);
      }
    } else {
      for (int j = threadIdx.x; j < M && slot0 + j < max_cells;
           j += kCellsThreads) {
        const int idx = sList[j];
        const long long gr = row0 + idx / cg.iw;
        const int x = idx % cg.iw, y = static_cast<int>(gr % cg.ih);
        const int z = static_cast<int>(gr / cg.ih);
        float v8[8];
        corners(fine, x, y, z, v8);
        write_cell(out, slot0 + j, x, y, z, cw, ch, v8);
      }
    }
  }
}

struct EmitOut {
  long long* keid;                   // [max_verts] kept ids, slot order
  float* ks;                         // [max_verts] their fractions
  int* cell_bits;                    // [nc]
  long long* counts;                 // [2]: kept, total
};

__global__ void __launch_bounds__(kThreads)
emit_kernel(const float* __restrict__ cvals, const long long* __restrict__ cx,
            const long long* __restrict__ cy,
            const long long* __restrict__ cz,
            const long long* __restrict__ n_cells, long long nc, int D,
            int H, int W, float iso, long long max_verts, EmitOut out,
            unsigned long long* __restrict__ scratch) {
  __shared__ unsigned long long warp_sums[32];
  __shared__ unsigned long long sBefore;
  __shared__ long long sTile;
  __shared__ unsigned char sSlots[19 * 3];
  for (int k = threadIdx.x; k < 19 * 3; k += blockDim.x)
    sSlots[k] = c_slots[k];
  const Scan sc = scan_of(scratch);
  long long live = *n_cells;
  live = live < 0 ? 0 : (live > nc ? nc : live);
  // tile 0 always runs: it writes the counts when no cell is live
  const long long tiles = live > 0 ? (live + kThreads - 1) / kThreads : 1;
  const int cw = W - 1, ch = H - 1;
  for (long long tile; (tile = next_tile(sc, tiles, &sTile)) >= 0;) {
    const long long i = tile * kThreads + threadIdx.x;
    float v[8];
    unsigned bits = 0, mask = 0;
    long long x = 0, y = 0, z = 0;
    if (i < live) {
      const float4* src = reinterpret_cast<const float4*>(cvals + i * 8);
      const float4 a = __ldg(src), b = __ldg(src + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      x = cx[i];
      y = cy[i];
      z = cz[i];
#pragma unroll
      for (int c = 0; c < 8; ++c) bits |= (v[c] > iso ? 1u : 0u) << c;
      for (int s = 0; s < 19; ++s) {
        const int lo = sSlots[s * 3], hi = sSlots[s * 3 + 1];
        const bool crossing = ((bits >> lo) & 1u) != ((bits >> hi) & 1u);
        const bool own = ((lo & 1) == 0 || x == cw - 1) &&
                         (((lo >> 1) & 1) == 0 || y == ch - 1) &&
                         (((lo >> 2) & 1) == 0 || z == D - 2);
        if (crossing && own) mask |= 1u << s;
      }
      out.cell_bits[i] = static_cast<int>(bits);
    }
    unsigned long long total;
    const unsigned long long in_tile =
        block_scan(__popc(mask), &total, warp_sums);
    const unsigned long long first = tile_prefix(sc, tile, total, &sBefore);
    long long at = static_cast<long long>(first + in_tile);
    for (unsigned r = mask; r; r &= r - 1, ++at) {
      if (at >= max_verts) break;
      const int s = __ffs(r) - 1;
      const int lo = sSlots[s * 3], hi = sSlots[s * 3 + 1];
      const float vlo = v[lo], vhi = v[hi];
      const float den = __fsub_rn(vhi, vlo);
      float t = __fdiv_rn(__fsub_rn(iso, vlo), den == 0.0f ? 1.0f : den);
      t = fminf(fmaxf(t, 0.0f), 1.0f);
      const long long plin = ((z + ((lo >> 2) & 1)) * H +
                              (y + ((lo >> 1) & 1))) * W + (x + (lo & 1));
      out.keid[at] = plin * 8 + sSlots[s * 3 + 2];
      out.ks[at] = t;
    }
    if (threadIdx.x == 0 && tile == tiles - 1) {
      const long long n = static_cast<long long>(first + total);
      out.counts[0] = n < max_verts ? n : max_verts;
      out.counts[1] = n;
    }
  }
  // the rows past the live cells
  for (long long i = live + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < nc; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out.cell_bits[i] = 0;
}

// The first lane's kept slot of this warp's stride, the stride, and the
// kept count. Lanes walk warp-aligned windows so that a whole warp enters
// each window.
struct Slots {
  long long begin, stride, live;
};

__device__ __forceinline__ Slots slots_of(const long long* counts) {
  return Slots{static_cast<long long>(blockIdx.x) * blockDim.x +
                   (threadIdx.x & ~31),
               static_cast<long long>(gridDim.x) * blockDim.x, counts[0]};
}

__global__ void __launch_bounds__(kThreads)
clear_kernel(const long long* __restrict__ keid,
             const long long* __restrict__ counts,
             unsigned* __restrict__ bitmap) {
  const Slots sl = slots_of(counts);
  for (long long i = sl.begin + (threadIdx.x & 31); i < sl.live;
       i += sl.stride)
    bitmap[keid[i] >> 5] = 0;
}

__global__ void __launch_bounds__(kThreads)
mark_kernel(const long long* __restrict__ keid,
            const long long* __restrict__ counts,
            unsigned* __restrict__ bitmap, unsigned* __restrict__ summary) {
  const Slots sl = slots_of(counts);
  const int lane = threadIdx.x & 31;
  for (long long base = sl.begin; base < sl.live; base += sl.stride) {
    const long long i = base + lane;
    const long long e = i < sl.live ? keid[i] : -1;
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

// A thread a summary word: its touched bitmap words and their ids, scanned
// in one word (touched words in bits 0-30, ids in 31-61); writes (touched
// words before it, its bits) for its summary word and (ids before it, the
// word's bits) for each touched bitmap word, at the touched words' rank.
__global__ void __launch_bounds__(kThreads)
rank_kernel(long long n_sum, const unsigned* __restrict__ bitmap,
            const unsigned* __restrict__ summary, int2* __restrict__ sum_rank,
            int2* __restrict__ word_rank,
            unsigned long long* __restrict__ scratch) {
  __shared__ unsigned long long warp_sums[32];
  __shared__ unsigned long long sBefore;
  __shared__ long long sTile;
  const Scan sc = scan_of(scratch);
  const long long tiles = (n_sum + kThreads - 1) / kThreads;
  for (long long tile; (tile = next_tile(sc, tiles, &sTile)) >= 0;) {
    const long long s0 = tile * kThreads + threadIdx.x;
    const unsigned sb = s0 < n_sum ? summary[s0] : 0u;
    const unsigned* words_of = bitmap + s0 * 32;
    unsigned ids = 0;
    for (unsigned r = sb; r; r &= r - 1)
      ids += __popc(words_of[__ffs(r) - 1]);
    const unsigned long long mine =
        __popc(sb) | (static_cast<unsigned long long>(ids) << kHiShift);
    unsigned long long total;
    const unsigned long long in_tile = block_scan(mine, &total, warp_sums);
    const unsigned long long at =
        tile_prefix(sc, tile, total, &sBefore) + in_tile;
    if (sb) {
      int k = static_cast<int>(at & kLoMask);
      int id = static_cast<int>(at >> kHiShift);
      sum_rank[s0] = make_int2(k, static_cast<int>(sb));
      for (unsigned r = sb; r; r &= r - 1) {
        const unsigned wb = words_of[__ffs(r) - 1];
        word_rank[k++] = make_int2(id, static_cast<int>(wb));
        id += __popc(wb);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
place_kernel(const long long* __restrict__ keid,
             const float* __restrict__ ks,
             const long long* __restrict__ counts,
             const int2* __restrict__ sum_rank,
             const int2* __restrict__ word_rank, long long max_verts,
             long long* __restrict__ vert_eid, float* __restrict__ vert_s) {
  const Slots sl = slots_of(counts);
  const long long first = sl.begin + (threadIdx.x & 31);
  for (long long i = first; i < sl.live; i += sl.stride) {
    const long long e = keid[i];
    const long long w = e >> 5;
    const int2 sr = sum_rank[w >> 5];
    const int k = sr.x + __popc(static_cast<unsigned>(sr.y) &
                                ((1u << (w & 31)) - 1u));
    const int2 wr = word_rank[k];
    const int r = wr.x + __popc(static_cast<unsigned>(wr.y) &
                                ((1u << (e & 31)) - 1u));
    vert_eid[r] = e;
    vert_s[r] = ks[i];
  }
  for (long long i = sl.live + first; i < max_verts; i += sl.stride) {
    vert_eid[i] = kInt64Max;         // the rows past the kept vertices
    vert_s[i] = 0.0f;
  }
}

// The rank of edge id e among the kept ids through the emit's tables, or
// -1 if it is none: sw and sr are summary[w >> 5] and sum_rank[w >> 5] of
// w = e >> 5 (read only where the summary bit is set).
__device__ __forceinline__ int table_rank(long long e, unsigned sw, int2 sr,
                                          const int2* __restrict__ word_rank) {
  const long long w = e >> 5;
  const unsigned wbit = 1u << (w & 31);
  if (!(sw & wbit)) return -1;
  const int2 wr = __ldg(word_rank + sr.x + __popc(sw & (wbit - 1u)));
  const unsigned ebit = 1u << (e & 31);
  const unsigned bits = static_cast<unsigned>(wr.y);
  return bits & ebit ? wr.x + __popc(bits & (ebit - 1u)) : -1;
}

__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const long long* __restrict__ vert_eid,
              const float* __restrict__ vert_s,
              const long long* __restrict__ n_verts, long long nv_cap,
              const long long* __restrict__ cell_id,
              const int* __restrict__ cell_bits,
              const long long* __restrict__ n_cells, long long nc_cap, int H,
              int W, long long n_ids, const unsigned* __restrict__ summary,
              const int2* __restrict__ sum_rank,
              const int2* __restrict__ word_rank, long long nvb,
              long long nfb, int* __restrict__ buf,
              unsigned long long* __restrict__ scratch) {
  __shared__ unsigned long long warp_sums[32];
  __shared__ unsigned long long sBefore;
  __shared__ long long sTile;
  __shared__ long long sKey[19];     // a slot's edge id less the cell's
  __shared__ int sRank[19 * kDecodeThreads];          // [slot][thread]
  __shared__ __align__(16) int sFaces[kDecodeThreads * 36 + 4];
  if (threadIdx.x < 19) {
    const int lo = c_slots[threadIdx.x * 3];
    sKey[threadIdx.x] =
        ((static_cast<long long>((lo >> 2) & 1) * H + ((lo >> 1) & 1)) * W +
         (lo & 1)) * 8 + c_slots[threadIdx.x * 3 + 2];
  }
  __syncthreads();
  const Scan sc = scan_of(scratch);
  long long nv = *n_verts, nc = *n_cells;
  nv = nv < 0 ? 0 : (nv > nv_cap ? nv_cap : nv);
  nc = nc < 0 ? 0 : (nc > nc_cap ? nc_cap : nc);
  const long long tiles = nc > 0 ? (nc + kDecodeThreads - 1) /
                                       kDecodeThreads : 1;
  const long long cw = W - 1, ch = H - 1;
  int* faces = buf + 4 + 3 * nvb;
  int* rank = sRank + threadIdx.x;
  for (long long tile; (tile = next_tile(sc, tiles, &sTile)) >= 0;) {
    const long long c = tile * kDecodeThreads + threadIdx.x;
    unsigned bits = 0, used = 0;
    if (c < nc && nv > 0) {
      const long long idx = cell_id[c];
      const long long x = idx % cw, y = (idx / cw) % ch, z = idx / (cw * ch);
      const long long key0 = ((z * H + y) * W + x) * 8;
      bits = static_cast<unsigned>(cell_bits[c]) & 0xffu;
      used = __ldg(g_cell_slots + bits);
      // every used slot's first load at once, then every second load
      unsigned sw[19];
      int2 sr[19];
#pragma unroll
      for (int s = 0; s < 19; ++s) {
        const long long e = key0 + sKey[s];
        sw[s] = 0u;
        sr[s] = make_int2(0, 0);
        if (((used >> s) & 1u) && e < n_ids) {
          sw[s] = __ldg(summary + (e >> 10));
          sr[s] = __ldg(sum_rank + (e >> 10));
        }
      }
#pragma unroll
      for (int s = 0; s < 19; ++s)
        if ((used >> s) & 1u)
          rank[s * kDecodeThreads] =
              table_rank(key0 + sKey[s], sw[s], sr[s], word_rank);
    }
    // the cell's faces in the codec's order; kept: found, ranks distinct
    const int nf = used ? g_cell_nf[bits] : 0;
    const unsigned char* slots = g_cell_faces + bits * 36;
    int n = 0;
    for (int f = 0; f < nf; ++f) {
      const int a = rank[slots[3 * f] * kDecodeThreads];
      const int b = rank[slots[3 * f + 1] * kDecodeThreads];
      const int d = rank[slots[3 * f + 2] * kDecodeThreads];
      n += a >= 0 && b >= 0 && d >= 0 && a != b && b != d && a != d;
    }
    unsigned long long total;
    const unsigned long long in_tile = block_scan(n, &total, warp_sums);
    const unsigned long long first = tile_prefix(sc, tile, total, &sBefore);
    // the tile's faces [first, first + total), the first nfb: staged at
    // their in-tile prefix, shifted so that shared and device words share
    // their 16-byte phase, then stored as one run
    const long long run =
        first >= static_cast<unsigned long long>(nfb)
            ? 0
            : (nfb - static_cast<long long>(first) <
                       static_cast<long long>(total)
                   ? nfb - static_cast<long long>(first)
                   : static_cast<long long>(total));
    int* dst = faces + 3 * static_cast<long long>(first);
    const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >>
                                        2) & 3);
    int* stage = sFaces + phase + 3 * static_cast<int>(in_tile);
    for (int f = 0, m = 0; f < nf; ++f) {
      const int a = rank[slots[3 * f] * kDecodeThreads];
      const int b = rank[slots[3 * f + 1] * kDecodeThreads];
      const int d = rank[slots[3 * f + 2] * kDecodeThreads];
      if (a < 0 || b < 0 || d < 0 || a == b || b == d || a == d) continue;
      stage[3 * m] = a;
      stage[3 * m + 1] = b;
      stage[3 * m + 2] = d;
      ++m;
    }
    __syncthreads();
    {
      int* base = dst - phase;       // 16-byte aligned
      const int end = phase + 3 * static_cast<int>(run);
      for (int q = threadIdx.x; 4 * q < end; q += kDecodeThreads) {
        const int i = 4 * q;
        if (i >= phase && i + 4 <= end) {
          reinterpret_cast<int4*>(base)[q] =
              reinterpret_cast<const int4*>(sFaces)[q];
        } else {
          for (int j = i; j < i + 4; ++j)
            if (j >= phase && j < end) base[j] = sFaces[j];
        }
      }
    }
    if (threadIdx.x == 0 && tile == tiles - 1)
      buf[1] = static_cast<int>(first + total);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    buf[0] = static_cast<int>(nv);
    buf[2] = static_cast<int>(nc);
    buf[3] = 0;
  }
  // the vertices: the host decoder's arithmetic on the packed u8 fraction
  float* verts = reinterpret_cast<float*>(buf + 4);
  const long long HW = static_cast<long long>(H) * W;
  const long long nw = nv < nvb ? nv : nvb;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < nw; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long e = vert_eid[i];
    const long long lo = e >> 3;
    const int d = static_cast<int>(e & 7);
    const float q = fminf(fmaxf(rintf(__fmul_rn(vert_s[i], 255.0f)), 0.0f),
                          255.0f);
    const float s = __fdiv_rn(q, 255.0f);       // q: the packed u8
    verts[i * 3 + 0] = __fadd_rn(static_cast<float>(lo % W),
                                 __fmul_rn(s, static_cast<float>(d & 1)));
    verts[i * 3 + 1] =
        __fadd_rn(static_cast<float>((lo / W) % H),
                  __fmul_rn(s, static_cast<float>((d >> 1) & 1)));
    verts[i * 3 + 2] =
        __fadd_rn(static_cast<float>(lo / HW),
                  __fmul_rn(s, static_cast<float>((d >> 2) & 1)));
  }
}

// The resident blocks of a kernel on the current card (its SMs times the
// occupancy calculator's blocks an SM), asked of the runtime once a card
// and kernel (`which`).
std::atomic<int> g_resident[kMaxDevices][7];

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

// The rank tables of the ids [the first *live] (distinct, below n_sum *
// 1024): clear, mark and rank (lattice_emit's launches 2-4) into bitmap
// [n_sum * 32] (any contents), summary [n_sum] (zero on entry), sum_rank
// [n_sum] and word_rank; rank_scan: the rank scan's scratch (zero on entry).
// `cap` bounds *live (the grids' size).
cudaError_t launch_rank(const long long* ids, const long long* live,
                        long long cap, unsigned* bitmap, long long n_sum,
                        unsigned* summary, unsigned long long* rank_scan,
                        int* sum_rank, int* word_rank, cudaStream_t s) {
  unsigned grid = 0;
  cudaError_t err = grid_for(2, clear_kernel, kThreads, cap, kThreads, &grid);
  if (err != cudaSuccess) return err;
  clear_kernel<<<grid, kThreads, 0, s>>>(ids, live, bitmap);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = grid_for(3, mark_kernel, kThreads, cap, kThreads, &grid);
  if (err != cudaSuccess) return err;
  mark_kernel<<<grid, kThreads, 0, s>>>(ids, live, bitmap, summary);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = grid_for(4, rank_kernel, kThreads, n_sum, kThreads, &grid);
  if (err != cudaSuccess) return err;
  rank_kernel<<<grid, kThreads, 0, s>>>(
      n_sum, bitmap, summary, reinterpret_cast<int2*>(sum_rank),
      reinterpret_cast<int2*>(word_rank), rank_scan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The edge slots [19, 3] u8 and the decode's per-corner-byte tables:
// used slots [256] u32, face counts [256] u8 and face slot triples [256 *
// 36] u8. Call once a device before the first launch. Returns a
// cudaError_t.
int icon_lattice_set_tables(const unsigned char* slots,
                            const unsigned* cell_slots,
                            const unsigned char* cell_nf,
                            const unsigned char* cell_faces) {
  cudaError_t err = cudaMemcpyToSymbol(c_slots, slots, sizeof(c_slots));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_cell_slots, cell_slots, sizeof(g_cell_slots));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_cell_nf, cell_nf, sizeof(g_cell_nf));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_cell_faces, cell_faces, sizeof(g_cell_faces));
  return static_cast<int>(err);
}

// Cells a tile of lattice_emit's scan; at most a tile of lattice_cells';
// a tile of lattice_decode's.
int icon_lattice_tile_cells() { return kThreads; }
int icon_lattice_cells_tile_cells() { return kCellsTileCells; }
int icon_lattice_decode_tile_cells() { return kDecodeThreads; }

// fine [D, H, W] f32 at element strides fs (3); coarse [Dc, Hc, Wc] f32 at
// strides cs, or null for the fine grid's own mixed cells; out [8 *
// max_cells] int64 words: cx, cy, cz, cell ids [max_cells] int64, then
// the corner values [max_cells, 8] f32 (zeroed here, so rows past the
// count are 0); counts [2] int64: n_cells, n_cells_total; scratch [2 +
// tiles] u64 (zeroed here), tiles = ceil(rows / (128 / ceil(iw / 32))) for
// the scanned grid's rows of iw <= 4096 cells. Returns a cudaError_t.
int icon_lattice_cells(const float* fine, int D, int H, int W,
                       const long long* fs, const float* coarse, int Dc,
                       int Hc, int Wc, const long long* cs, float iso,
                       long long nc_budget, long long max_cells,
                       long long* out, long long* counts,
                       unsigned long long* scratch, void* stream) {
  if (D < 2 || H < 2 || W < 2 || max_cells < 1 || nc_budget < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool use_coarse = coarse != nullptr;
  if (use_coarse && (Dc < 2 || Hc < 2 || Wc < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  CellsGrid cg;
  cg.iw = use_coarse ? Wc - 1 : W - 1;
  cg.ih = use_coarse ? Hc - 1 : H - 1;
  cg.rows = static_cast<long long>(cg.ih) * (use_coarse ? Dc - 1 : D - 1);
  const long long n_items = cg.rows * cg.iw;
  // both scanned counts stay below 2^31; a row fits a tile
  if ((use_coarse ? 8 * n_items : n_items) >= (1ll << kHiShift) ||
      cg.iw > kCellsTileCells)
    return static_cast<int>(cudaErrorInvalidValue);
  cg.cpr = (cg.iw + 31) / 32;
  cg.tile_rows = kCellsTileWords / cg.cpr;
  cg.tiles = (cg.rows + cg.tile_rows - 1) / cg.tile_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (kCellsScan + 1 + cg.tiles) * sizeof(unsigned long long),
      s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(out, 0, 8 * max_cells * sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  err = grid_for(0, cells_kernel, kCellsThreads, cg.tiles, 1, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strided f{fine, D, H, W, fs[0], fs[1], fs[2]};
  const Strided g = use_coarse ? Strided{coarse, Dc, Hc, Wc, cs[0], cs[1],
                                         cs[2]}
                               : f;
  const CellsOut o{out, out + max_cells, out + 2 * max_cells,
                   out + 3 * max_cells,
                   reinterpret_cast<float*>(out + 4 * max_cells), counts,
                   counts + 1};
  cells_kernel<<<grid, kCellsThreads, 0, s>>>(
      f, g, cg, use_coarse, iso, use_coarse ? nc_budget : 0, max_cells, o,
      scratch);
  return static_cast<int>(cudaGetLastError());
}

// cvals [nc, 8] f32 (16-byte aligned), cx, cy, cz [nc] int64 and *n_cells
// (cells at and past it are dead) on a fine grid (D, H, W). keid
// [max_verts] int64 and ks [max_verts] f32: scratch for the kept slots;
// bitmap [n_sum * 32] u32 (any contents), n_sum = ceil(D H W 8 / 1024);
// scratch [ceil(n_sum / 2) + 1 + ceil(nc / 256) + 1 + ceil(n_sum / 256)]
// u64 (the summary, then the two scans', zeroed here); sum_rank [n_sum] and
// word_rank [min(max_verts, n_sum * 32)] int2. Writes cell_bits [nc] i32
// (0 past the live cells), vert_eid [max_verts] int64 (ascending, then
// INT64_MAX), vert_s [max_verts] f32 (then 0) and counts [2] int64: kept
// vertices, all vertices; the summary (the scratch's first n_sum u32),
// sum_rank and word_rank hold the decode's rank tables of the kept
// vertices. Returns a cudaError_t.
int icon_lattice_emit(const float* cvals, const long long* cx,
                      const long long* cy, const long long* cz,
                      const long long* n_cells, long long nc, int D, int H,
                      int W, float iso, long long max_verts, long long* keid,
                      float* ks, unsigned* bitmap, long long n_sum,
                      unsigned long long* scratch, int* sum_rank,
                      int* word_rank, int* cell_bits, long long* vert_eid,
                      float* vert_s, long long* counts, void* stream) {
  if (D < 2 || H < 2 || W < 2 || nc < 1 || max_verts < 1 || n_sum < 1 ||
      reinterpret_cast<uintptr_t>(cvals) % 16 != 0 ||
      static_cast<long long>(D) * H * W * 8 > n_sum * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long sum_words = (n_sum + 1) / 2;
  const long long emit_words = 1 + (nc + kThreads - 1) / kThreads;
  const long long rank_words = 1 + (n_sum + kThreads - 1) / kThreads;
  const long long words = sum_words + emit_words + rank_words;
  unsigned* summary = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* emit_scan = scratch + sum_words;
  unsigned long long* rank_scan = emit_scan + emit_words;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  err = grid_for(1, emit_kernel, kThreads, nc, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  emit_kernel<<<grid, kThreads, 0, s>>>(
      cvals, cx, cy, cz, n_cells, nc, D, H, W, iso, max_verts,
      EmitOut{keid, ks, cell_bits, counts}, emit_scan);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_rank(keid, counts, max_verts, bitmap, n_sum, summary,
                      rank_scan, sum_rank, word_rank, s);
  if (err == cudaSuccess)
    err = grid_for(5, place_kernel, kThreads, max_verts, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  place_kernel<<<grid, kThreads, 0, s>>>(
      keid, ks, counts, reinterpret_cast<const int2*>(sum_rank),
      reinterpret_cast<const int2*>(word_rank), max_verts, vert_eid, vert_s);
  return static_cast<int>(cudaGetLastError());
}

// The decode's rank tables of ids [cap] (the first *n_ids distinct and
// below n_sum * 1024; the emit's vert_eid), as lattice_emit leaves them:
// bitmap [n_sum * 32] u32 (any contents); scratch [ceil(n_sum / 2) + 1 +
// ceil(n_sum / 256)] u64 (zeroed here), the summary its first n_sum u32;
// sum_rank [n_sum] and word_rank [min(cap, n_sum * 32)] int2.
// Returns a cudaError_t.
int icon_lattice_rank(const long long* ids, const long long* n_ids,
                      long long cap, unsigned* bitmap, long long n_sum,
                      unsigned long long* scratch, int* sum_rank,
                      int* word_rank, void* stream) {
  if (cap < 1 || n_sum < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long sum_words = (n_sum + 1) / 2;
  const long long rank_words = 1 + (n_sum + kThreads - 1) / kThreads;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (sum_words + rank_words) * sizeof(unsigned long long), s);
  if (err == cudaSuccess)
    err = launch_rank(ids, n_ids, cap, bitmap, n_sum,
                      reinterpret_cast<unsigned*>(scratch),
                      scratch + sum_words, sum_rank, word_rank, s);
  return static_cast<int>(err);
}

// The emit's vert_eid, vert_s [nv_cap] (the first *n_verts live, ids
// ascending), cell_id [nc_cap] int64 and cell_bits [nc_cap] i32 (the first
// *n_cells live) on a marched grid of H x W points a slice; the rank tables
// of the live ids (lattice_emit's or icon_lattice_rank's: summary, sum_rank
// [n_sum] and word_rank) over ids below n_sum * 1024; buf [4 + 3 nvb + 3
// nfb] i32, 16-byte aligned; scratch [1 + ceil(nc_cap / 128)] u64 (zeroed
// here). Writes the header (vertices, faces, cells, 0), the first nvb
// vertices and the first nfb faces. Returns a cudaError_t.
int icon_lattice_decode(const long long* vert_eid, const float* vert_s,
                        const long long* n_verts, long long nv_cap,
                        const long long* cell_id, const int* cell_bits,
                        const long long* n_cells, long long nc_cap, int H,
                        int W, long long n_sum, const unsigned* summary,
                        const int* sum_rank, const int* word_rank,
                        long long nvb, long long nfb, int* buf,
                        unsigned long long* scratch, void* stream) {
  if (H < 2 || W < 2 || nv_cap < 1 || nc_cap < 1 || nvb < 0 || nfb < 0 ||
      n_sum < 1 || 12 * nc_cap >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(buf) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = 1 + (nc_cap + kDecodeThreads - 1) / kDecodeThreads;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  const long long work = nc_cap > nv_cap ? nc_cap : nv_cap;
  err = grid_for(6, decode_kernel, kDecodeThreads, work, kDecodeThreads,
                 &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<<<grid, kDecodeThreads, 0, s>>>(
      vert_eid, vert_s, n_verts, nv_cap, cell_id, cell_bits, n_cells, nc_cap,
      H, W, n_sum * 1024, summary, reinterpret_cast<const int2*>(sum_rank),
      reinterpret_cast<const int2*>(word_rank), nvb, nfb, buf, scratch);
  return static_cast<int>(cudaGetLastError());
}

const char* icon_lattice_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
