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
// lattice_emit (one cooperative launch, no memset): every vertex is a
// crossing lattice edge that one alive cell owns (the 19 slots of
// recon/lattice_host.py:_build_edge_slots), so the vertices are distinct
// by construction and their edge ids lie below D H W 8. The slots' first
// max_verts in linear (cell, slot) order are kept (the compaction of the
// JAX package) and written in ascending edge-id order without a sort,
// through rank tables that stay with the lattice for the decode: the
// summary (bit b of word s: the 32 ids of word 32 s + b hold a kept id),
// sum_rank (each touched summary word's touched words before it, and its
// bits) and word_rank (each touched word's kept ids before it, and its
// bits, in word order). The call moves little data through many
// dependent steps (at 257^3: 47,002 cells, 147,622 vertices), so it is
// bound by latency, not bytes: a launch a step would pay a launch, a ramp
// and a drain each. So one persistent grid, at most the blocks that are
// resident at once (a cooperative launch; a larger grid is refused), runs
// the steps as phases between grid-wide barriers, each block on a
// contiguous share of the items, and a scan across blocks is one sum of
// the block totals after a barrier (no ticket, no look-back, no scratch
// to zero beforehand: every word a phase reads is written earlier in the
// launch).
// 1. Each block zeroes its share of the summary and counts the owned
//    crossing slots of its share of the cells (from two tables in shared
//    memory: a corner byte's crossing slots, and the slots a cell owns by
//    whether it is last along x, y and z), writing their corner bytes.
//    Barrier. The block totals give each slot its position (the first
//    max_verts kept); a kept slot gets its id plin * 8 + dir and fraction
//    s = clamp((iso - v_lo) / (v_hi - v_lo), 0, 1), staged in shared
//    memory so that a tile's run of slots is stored in order, and marks
//    its word in the summary (once for a cell's slots in one word). Block
//    0 writes the counts. Barrier.
// 2. The summary words, 8 consecutive ones a thread in a contiguous share
//    a block: touched words summed, barrier, the block totals summed, then
//    sum_rank for each touched summary word (no other row is written or
//    read) and the touched words' word_rank rows zeroed. Barrier. Each
//    kept id ORs its bit into its word's row (a run of adjacent lanes in
//    one word in one atomic); then the rows past the live cells and past
//    the kept count are filled. Barrier. The rows' ids summed, a
//    contiguous share of rows a block, barrier, each row's kept ids
//    before it written.
// 3. Barrier. Each kept id is written at its rank, found in O(1) as the
//    decode finds it, four ids a thread in flight; the rows past the kept
//    count hold the id INT64_MAX and s = 0.
// No bitmap of the id range: a word's bits gather in its own word_rank
// row, so nothing the call allocates is sized by D H W 8 / 32 (a 134 MB
// bitmap at 513^3). icon_lattice_rank zeroes the summary, marks given
// sorted ids and runs phase 2 in one cooperative launch of the same code.
// What is left of the time is the seven barriers (about 1 us each on an
// H100 with 264 blocks), three sums of block totals after them, and each
// phase's chain of dependent loads (kernels/profile_lattice.py times the
// call; no __match_any_sync: combining marks through it measured slower
// than atomics a run of adjacent lanes).
//
// lattice_decode (one launch): the host decoder's mesh from the emit's outputs,
// written into one int32 buffer [header 4 | verts 3 nvb f32 | faces 3 nfb i32]
// that one copy takes to the host. A single-pass scan over tiles of 128 cells,
// a cell a thread (at 257^3's 47,002 cells, 368 tiles: with 28 KB of shared
// memory a block, 8 blocks an SM fit, so the tiles run in one wave and each
// look-back reads at most 12 windows of 32 statuses; two cells a thread would
// halve the tiles and leave SMs idle). A cell's corner byte gives, through a
// table built from the codec's (tet, case) tables, the edge slots its faces use
// and the faces as slot triples in the codec's order (tet, then triangle). Each
// used slot's edge id is ranked in O(1) through the emit's tables, as the
// emit's phase 3 ranks it: if the summary bit of word w = e >> 5 is clear, the
// id is no vertex; else k = sum_rank[w >> 5].x + the summary bits below w, and
// the rank is word_rank[k].x + its bits below e if bit e & 31 of word_rank[k].y
// is set, else the id is no vertex. Two dependent loads, issued for every slot
// of the cell at once, where a binary search over the sorted ids makes ~18 for
// each face corner. A face whose edge is no vertex (dropped by an overflow) or
// whose ranks repeat is dropped, as csrc/latticecodec.cc:137-140 drops it. The
// tile's faces are staged in shared memory at their in-tile prefix and written
// as the tile's one contiguous run, 16-byte stores, the first nfb. Each block
// then writes vertices: s quantized as pack_lattice quantizes it (rint(s *
// 255), clamped to [0, 255]), s8 / 255 by exact division and lo + s8 / 255 * d
// an axis, each operation rounded on its own (no contraction), as the host
// decoder computes them. The header holds (vertices, faces, cells, 0), the true
// counts; the host reads an overflow where they exceed nvb or nfb. A lattice
// without the emit's tables (released, or not from the emit) gets them anew
// from its sorted ids: the emit's phase 2 on them (icon_lattice_rank).
//
// Bound: bytes. lattice_cells reads the coarse grid and the fine points of
// the mixed coarse cells and writes 64 B a row (the zeroed rows too);
// lattice_emit reads 56 B an alive cell and writes 12 B a vertex twice and
// 4 B a cell; lattice_decode reads 12 B an alive cell and 12 B a vertex and
// writes 12 B a vertex and 12 B a face. All three are latency-bound
// (dependent loads, ballots and scans on little data): the cells kernel
// and the decode cut the dependent steps a tile and the tiles; the emit
// runs its steps in one launch, seven grid barriers apart. What is left
// of the cells kernel's time is each tile's chain of dependent steps (a
// warp's 4 load rounds, two block scans, the expansion's loads, the
// writes), not its look-back: the whole block looking back 256 statuses a
// step in place of a warp's 32 measured no faster at 257^3 and slower at
// 513^3 (kernels/profile_lattice.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

namespace coop = cooperative_groups;

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

// lattice_emit and icon_lattice_rank: blocks of kEmitThreads, at most
// kEmitBlocksPerSm an SM resident (64 registers a thread)
constexpr int kEmitThreads = 512;
constexpr int kEmitBlocksPerSm = 2;
// summary words a thread takes at once in the summary scan
constexpr int kSumRun = 8;

// The rank tables of the kept ids and the block totals, a call's own.
struct Tables {
  unsigned* summary;                 // [n_sum]
  int2* sum_rank;                    // [n_sum]
  int2* word_rank;                   // [touched words]
  // [3 * stride]: the block totals of the emit's, the summary's and the
  // word rows' scans, stride = gridDim.x rounded up to 4
  unsigned* totals;
  long long n_sum;
};

__device__ __forceinline__ unsigned* totals_of(const Tables& t, int scan) {
  return t.totals + scan * ((gridDim.x + 3) & ~3u);
}

// This block's contiguous share [*lo, *hi) of n items, in multiples of 32
// (blocks past the items get an empty share).
__device__ __forceinline__ void block_share(long long n, long long* lo,
                                            long long* hi) {
  long long per = (n + gridDim.x - 1) / gridDim.x;
  per = (per + 31) & ~31ll;
  const long long a = static_cast<long long>(blockIdx.x) * per;
  *lo = a < n ? a : n;
  *hi = a + per < n ? a + per : n;
}

// The block's sum of x, in every thread; `sh` is shared [32].
__device__ unsigned long long block_sum(unsigned long long x,
                                        unsigned long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  x = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) x += sh[w];
  __syncthreads();                   // sh reused by the next call
  return x;
}

// Publishes the block's total of a scan (thread 0 writes it; every thread
// calls it with the block's sum).
__device__ __forceinline__ void publish(unsigned* totals,
                                        unsigned long long total) {
  if (threadIdx.x == 0) totals[blockIdx.x] = static_cast<unsigned>(total);
}

// After a grid barrier: the sum of the published totals before this block
// (*before) and of all of them (*all); every thread of the block calls it.
// 16-byte L2 reads (the totals are another block's writes of this launch).
__device__ void grid_prefix(const unsigned* totals, unsigned long long* before,
                            unsigned long long* all, unsigned long long* sh) {
  unsigned long long b = 0, a = 0;
  for (unsigned q = threadIdx.x; 4 * q < gridDim.x; q += blockDim.x) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(totals) + q);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned i = 4 * q + j;
      const unsigned long long x = i < gridDim.x ? w[j] : 0u;
      a += x;
      b += i < blockIdx.x ? x : 0u;
    }
  }
  // both sums in one reduction: before in bits 0-31, all in 32-63
  const unsigned long long both = block_sum(b | (a << 32), sh);
  *before = both & 0xffffffffull;
  *all = both >> 32;
}

// Marks 32-id word w as touched in the summary: bit w & 31 of word w >> 5.
__device__ __forceinline__ void mark_word(long long w, unsigned* summary) {
  atomicOr(summary + (w >> 5), 1u << (w & 31));
}

// The OR of `bits` over each run of adjacent lanes with one `key`, at the
// run's first lane (*head). A whole warp calls it.
__device__ __forceinline__ unsigned run_or(int key, unsigned bits,
                                           bool* head) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  *head = lane == 0 || prev != key;
  const unsigned heads = __ballot_sync(0xffffffffu, *head);
  const unsigned above = lane == 31 ? 0u : heads & (0xfffffffeu << lane);
  const int end = above ? __ffs(above) - 1 : 32;   // the run's end
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_down_sync(0xffffffffu, bits, o);
    if (lane + o < end) bits |= y;
  }
  return bits;
}

// p[lo, hi) = value, grid-stride (p 16-byte aligned): 16-byte stores but
// at the ends.
template <typename T, typename V>
__device__ void fill_range(T* p, long long lo, long long hi, T value,
                           V vvalue, long long first, long long stride) {
  constexpr long long n = sizeof(V) / sizeof(T);
  long long a = (lo + n - 1) / n * n;
  a = a < hi ? a : hi;
  const long long b = a + (hi - a) / n * n;
  for (long long i = lo + first; i < a; i += stride) p[i] = value;
  for (long long q = a / n + first; q < b / n; q += stride)
    reinterpret_cast<V*>(p)[q] = vvalue;
  for (long long i = b + first; i < hi; i += stride) p[i] = value;
}

// The word_rank row of kept id e, through sum_rank (written by a phase
// before, so read from L2).
__device__ __forceinline__ int word_row(long long e, const int2* sum_rank) {
  const int2 sr = __ldcg(sum_rank + (e >> 10));
  return sr.x + __popc(static_cast<unsigned>(sr.y) &
                       ((1u << ((e >> 5) & 31)) - 1u));
}

// This thread's kSumRun summary words from s (zero past s1; s a multiple
// of 4, the summary 16-byte aligned).
__device__ __forceinline__ void summary_run(const unsigned* summary,
                                            long long s, long long s1,
                                            unsigned* w) {
#pragma unroll
  for (int j = 0; j < kSumRun; j += 4) {
    const uint4 v = s + j < s1 ? __ldcg(reinterpret_cast<const uint4*>(
                                     summary + s + j))
                               : make_uint4(0, 0, 0, 0);
    w[j] = v.x; w[j + 1] = v.y; w[j + 2] = v.z; w[j + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < kSumRun; ++j) w[j] = s + j < s1 ? w[j] : 0u;
}

// The rank tables of the kept ids [kept], each marked in the summary
// before a grid barrier: four more barriers. Every thread of the grid
// calls it; `sh` and `warp_sums` are shared [32]. `fill` (a grid-stride
// store loop) runs after the ORs.
template <typename Fill>
__device__ void rank_phases(coop::grid_group& grid, const long long* ids,
                            long long kept, const Tables& t,
                            unsigned long long* sh,
                            unsigned long long* warp_sums, Fill fill) {
  // 1. the summary words, kSumRun consecutive ones a thread: the
  //    block's touched words, then their rows and those before them
  long long s0, s1;
  block_share(t.n_sum, &s0, &s1);
  unsigned long long mine = 0;
  for (long long s = s0 + kSumRun * threadIdx.x; s < s1;
       s += kSumRun * blockDim.x) {
    unsigned w[kSumRun];
    summary_run(t.summary, s, s1, w);
#pragma unroll
    for (int j = 0; j < kSumRun; ++j) mine += __popc(w[j]);
  }
  publish(totals_of(t, 1), block_sum(mine, sh));
  grid.sync();
  unsigned long long before, all;
  grid_prefix(totals_of(t, 1), &before, &all, sh);
  const long long touched = static_cast<long long>(all);
  {                                  // the touched words' rows zeroed
    long long k0, k1;
    block_share(touched, &k0, &k1);
    for (long long k = k0 + threadIdx.x; k < k1; k += blockDim.x)
      t.word_rank[k] = make_int2(0, 0);
  }
  for (long long base = s0; base < s1; base += kSumRun * blockDim.x) {
    const long long s = base + kSumRun * threadIdx.x;
    unsigned w[kSumRun];
    summary_run(t.summary, s, s1, w);
    unsigned n = 0;
#pragma unroll
    for (int j = 0; j < kSumRun; ++j) n += __popc(w[j]);
    unsigned long long tile;
    int k = static_cast<int>(before + block_scan(n, &tile, warp_sums));
#pragma unroll
    for (int j = 0; j < kSumRun; ++j)
      if (w[j]) {
        t.sum_rank[s + j] = make_int2(k, static_cast<int>(w[j]));
        k += __popc(w[j]);
      }
    before += tile;
  }
  grid.sync();
  // 2. each kept id's bit in its word's row, a lane an id, four ids a
  //    lane in flight; the lanes of a run of ids in one word combine in one
  //    atomic. Then the stores that fill the rows past the counts.
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      (threadIdx.x & ~31);
       i0 < kept; i0 += 4 * stride) {
    long long e[4];
    int k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = i0 + j * stride + lane;
      e[j] = i < kept ? __ldcg(ids + i) : -1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      k[j] = e[j] >= 0 ? word_row(e[j], t.sum_rank) : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool head;
      const unsigned bits =
          run_or(k[j], e[j] >= 0 ? 1u << (e[j] & 31) : 0u, &head);
      if (head && k[j] >= 0)
        atomicOr(reinterpret_cast<unsigned*>(t.word_rank + k[j]) + 1, bits);
    }
  }
  fill();
  grid.sync();
  // 3. each touched word's kept ids before it: a scan over the rows
  long long k0, k1;
  block_share(touched, &k0, &k1);
  mine = 0;
  for (long long k = k0 + threadIdx.x; k < k1; k += blockDim.x)
    mine += __popc(__ldcg(reinterpret_cast<const unsigned*>(
        t.word_rank + k) + 1));
  publish(totals_of(t, 2), block_sum(mine, sh));
  grid.sync();
  grid_prefix(totals_of(t, 2), &before, &all, sh);
  for (long long base = k0; base < k1; base += blockDim.x) {
    const long long k = base + threadIdx.x;
    int* row = reinterpret_cast<int*>(t.word_rank + k);
    const unsigned bits =
        k < k1 ? __ldcg(reinterpret_cast<const unsigned*>(row) + 1) : 0u;
    unsigned long long tile;
    const unsigned long long at =
        before + block_scan(__popc(bits), &tile, warp_sums);
    if (k < k1) row[0] = static_cast<int>(at);
    before += tile;
  }
}

struct EmitIn {
  const float* cvals;                // [nc, 8], 16-byte aligned
  const long long *cx, *cy, *cz;     // [nc]
  const long long* n_cells;          // cells at and past it are dead
  long long nc;
  int D, H, W;
  float iso;
  long long max_verts;
};

struct EmitOut {
  long long* keid;                   // [max_verts] kept ids, slot order
  float* ks;                         // [max_verts] their fractions
  int* cell_bits;                    // [nc]
  long long* vert_eid;               // [max_verts] ascending, then INT64_MAX
  float* vert_s;                     // [max_verts]
  long long* counts;                 // [3]: kept, total, min(n_cells, nc)
};

// The slots a tile of cells may stage in shared memory (about 3 a cell
// on a surface; a tile with more stores its slots directly)
constexpr int kStage = 2048;

// The emit's tables in shared memory: each slot's corners and edge id
// less its cell's, the crossing slots of each corner byte, and the owned
// slots of a cell by whether it is last along x, y and z; then a tile's
// kept slots (id and fraction) in order.
struct EmitShared {
  unsigned char slots[19 * 3];
  long long key[19];
  unsigned cross[256];
  unsigned own[8];
  long long stage_eid[kStage];
  float stage_s[kStage];
};

__device__ void emit_tables(EmitShared* sm, int H, int W) {
  for (int k = threadIdx.x; k < 19 * 3; k += blockDim.x)
    sm->slots[k] = c_slots[k];
  __syncthreads();
  const int i = threadIdx.x;
  if (i < 256) {
    unsigned m = 0;
    for (int s = 0; s < 19; ++s)
      m |= (((i >> sm->slots[3 * s]) ^ (i >> sm->slots[3 * s + 1])) & 1u)
           << s;
    sm->cross[i] = m;
  } else if (i < 256 + 8) {
    const int last = i - 256;        // bit 0: x, bit 1: y, bit 2: z
    unsigned m = 0;
    for (int s = 0; s < 19; ++s) {
      const int lo = sm->slots[3 * s];
      if ((lo & ~last & 7) == 0) m |= 1u << s;   // every far side is last
    }
    sm->own[last] = m;
  } else if (i < 256 + 8 + 19) {
    const int s = i - 256 - 8, lo = sm->slots[3 * s];
    sm->key[s] = ((static_cast<long long>((lo >> 2) & 1) * H +
                   ((lo >> 1) & 1)) * W + (lo & 1)) * 8 + sm->slots[3 * s + 2];
  }
  __syncthreads();
}

// Live cell c's corner byte (*bits) and its owned crossing slots (the
// result, a bit a slot), from its corner values and coordinates.
__device__ __forceinline__ unsigned cell_slots(const EmitIn& in,
                                               const EmitShared& sm,
                                               const float* v, long long x,
                                               long long y, long long z,
                                               unsigned* bits) {
  unsigned b = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) b |= (v[k] > in.iso ? 1u : 0u) << k;
  *bits = b;
  return sm.cross[b] & sm.own[(x == in.W - 2) | (y == in.H - 2) << 1 |
                              (z == in.D - 2) << 2];
}

__device__ __forceinline__ void load_cell(const EmitIn& in, long long c,
                                          float* v, long long* x,
                                          long long* y, long long* z) {
  const float4* src = reinterpret_cast<const float4*>(in.cvals + c * 8);
  const float4 a = __ldg(src), b = __ldg(src + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  *x = __ldg(in.cx + c);
  *y = __ldg(in.cy + c);
  *z = __ldg(in.cz + c);
}

// v[c] for a corner c known only at run time, without local memory.
__device__ __forceinline__ float corner_value(const float* v, int c) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) r = c == k ? v[k] : r;
  return r;
}

__global__ void __launch_bounds__(kEmitThreads, kEmitBlocksPerSm)
emit_kernel(EmitIn in, EmitOut out, Tables t) {
  __shared__ unsigned long long warp_sums[32];
  __shared__ unsigned long long sh[32];
  __shared__ EmitShared sm;
  emit_tables(&sm, in.H, in.W);
  coop::grid_group grid = coop::this_grid();
  const long long n_cells = *in.n_cells;
  const long long live =
      n_cells < 0 ? 0 : (n_cells > in.nc ? in.nc : n_cells);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // 1. the summary zeroed; each block's owned crossing slots over its
  //    share of the live cells
  {
    long long z0, z1;
    block_share(t.n_sum, &z0, &z1);
    for (long long z = z0 + threadIdx.x; z < z1; z += blockDim.x)
      t.summary[z] = 0u;
  }
  long long c0, c1;
  block_share(live, &c0, &c1);
  unsigned long long mine = 0;
  for (long long c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    float v[8];
    long long x, y, z;
    unsigned bits;
    load_cell(in, c, v, &x, &y, &z);
    mine += __popc(cell_slots(in, sm, v, x, y, z, &bits));
    out.cell_bits[c] = static_cast<int>(bits);
  }
  publish(totals_of(t, 0), block_sum(mine, sh));
  grid.sync();
  unsigned long long before, all;
  grid_prefix(totals_of(t, 0), &before, &all, sh);
  const long long total = static_cast<long long>(all);
  const long long kept = total < in.max_verts ? total : in.max_verts;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out.counts[0] = kept;
    out.counts[1] = total;
    out.counts[2] = n_cells < in.nc ? n_cells : in.nc;
  }
  // the slots' positions in (cell, slot) order, the first max_verts kept,
  // each word of a cell's kept slots marked once (a cell's slots mostly
  // share one); a tile's slots, a contiguous run, are staged in shared
  // memory and stored in order where they fit
  for (long long base = c0; base < c1; base += blockDim.x) {
    const long long c = base + threadIdx.x;
    float v[8];
    long long x = 0, y = 0, z = 0;
    unsigned bits, mask = 0;
    if (c < c1) {
      load_cell(in, c, v, &x, &y, &z);
      mask = cell_slots(in, sm, v, x, y, z, &bits);
    }
    unsigned long long tile;
    const long long tile0 = static_cast<long long>(before);
    long long at = tile0 + static_cast<long long>(
                               block_scan(__popc(mask), &tile, warp_sums));
    const bool staged = tile <= kStage;
    const long long key0 = ((z * in.H + y) * in.W + x) * 8;
    long long marked = -1;           // the word last marked
    for (; mask && at < in.max_verts; mask &= mask - 1, ++at) {
      const int s = __ffs(mask) - 1;
      const float vlo = corner_value(v, sm.slots[s * 3]);
      const float vhi = corner_value(v, sm.slots[s * 3 + 1]);
      const float den = __fsub_rn(vhi, vlo);
      float f = __fdiv_rn(__fsub_rn(in.iso, vlo), den == 0.0f ? 1.0f : den);
      f = fminf(fmaxf(f, 0.0f), 1.0f);
      const long long e = key0 + sm.key[s];
      if (staged) {
        sm.stage_eid[at - tile0] = e;
        sm.stage_s[at - tile0] = f;
      } else {
        out.keid[at] = e;
        out.ks[at] = f;
      }
      if (e >> 5 != marked) {
        marked = e >> 5;
        mark_word(marked, t.summary);
      }
    }
    if (staged) {
      __syncthreads();
      const long long left = in.max_verts - tile0;
      const long long n = static_cast<long long>(tile) < left
                              ? static_cast<long long>(tile) : left;
      for (long long j = threadIdx.x; j < n; j += blockDim.x) {
        out.keid[tile0 + j] = sm.stage_eid[j];
        out.ks[tile0 + j] = sm.stage_s[j];
      }
      __syncthreads();               // the stage is reused by the next tile
    }
    before += tile;
  }
  grid.sync();
  // 2. the rank tables, and the rows past the live cells and past the
  //    kept vertices filled
  rank_phases(grid, out.keid, kept, t, sh, warp_sums, [&]() {
    fill_range(out.cell_bits, live, in.nc, 0, make_int4(0, 0, 0, 0), first,
               stride);
    fill_range(out.vert_eid, kept, in.max_verts, kInt64Max,
               make_longlong2(kInt64Max, kInt64Max), first, stride);
    fill_range(out.vert_s, kept, in.max_verts, 0.0f,
               make_float4(0.0f, 0.0f, 0.0f, 0.0f), first, stride);
  });
  grid.sync();
  // 3. each kept id at its rank; four ids a thread in flight at once
  for (long long i0 = first; i0 < kept; i0 += 4 * stride) {
    long long e[4];
    int2 wr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = i0 + j * stride;
      e[j] = i < kept ? __ldcg(out.keid + i) : -1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wr[j] = e[j] >= 0 ? __ldcg(t.word_rank + word_row(e[j], t.sum_rank))
                        : make_int2(0, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e[j] >= 0) {
        const int r = wr[j].x + __popc(static_cast<unsigned>(wr[j].y) &
                                       ((1u << (e[j] & 31)) - 1u));
        out.vert_eid[r] = e[j];
        out.vert_s[r] = __ldcg(out.ks + i0 + j * stride);
      }
  }
}

// The rank tables of ids [the first clamp(*n_ids, 0, cap)] (distinct,
// below n_sum * 1024): the summary zeroed, the ids marked, then the
// emit's rank phases.
__global__ void __launch_bounds__(kEmitThreads, kEmitBlocksPerSm)
rank_kernel(const long long* __restrict__ ids,
            const long long* __restrict__ n_ids, long long cap, Tables t) {
  __shared__ unsigned long long warp_sums[32];
  __shared__ unsigned long long sh[32];
  coop::grid_group grid = coop::this_grid();
  long long z0, z1;
  block_share(t.n_sum, &z0, &z1);
  for (long long z = z0 + threadIdx.x; z < z1; z += blockDim.x)
    t.summary[z] = 0u;
  const long long n = *n_ids;
  const long long kept = n < 0 ? 0 : (n > cap ? cap : n);
  grid.sync();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      (threadIdx.x & ~31);
       i0 < kept; i0 += stride) {
    const long long i = i0 + (threadIdx.x & 31);
    const long long e = i < kept ? __ldg(ids + i) : -1;
    const int s = e >= 0 ? static_cast<int>(e >> 10) : -1;
    bool head;
    const unsigned bits =
        run_or(s, e >= 0 ? 1u << ((e >> 5) & 31) : 0u, &head);
    if (head && s >= 0) atomicOr(t.summary + s, bits);
  }
  grid.sync();
  rank_phases(grid, ids, kept, t, sh, warp_sums, []() {});
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
// and kernel (`which`: 0 cells, 1 emit, 2 rank, 3 decode).
std::atomic<int> g_resident[kMaxDevices][4];

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

// One cooperative launch of `kernel`: at most max_blocks of its resident
// blocks (ceil(work / kEmitThreads) at least 1). A grid the card cannot
// hold at once is refused, and the error returned.
template <typename Kernel>
cudaError_t launch_cooperative(int which, Kernel kernel, long long work,
                               long long max_blocks, void** args,
                               cudaStream_t s) {
  unsigned grid = 0;
  cudaError_t err = grid_for(which, kernel, kEmitThreads, work, kEmitThreads,
                             &grid);
  if (err != cudaSuccess) return err;
  if (grid > max_blocks) grid = static_cast<unsigned>(max_blocks);
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kEmitThreads), args, 0, s);
  const cudaError_t last = cudaGetLastError();   // clears a refusal
  return err != cudaSuccess ? err : last;
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

// Threads a block of lattice_emit's and icon_lattice_rank's cooperative
// grid; cells at most a tile of lattice_cells'; a tile of lattice_decode's.
int icon_lattice_emit_threads() { return kEmitThreads; }
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
// (cells at and past it are dead) on a fine grid (D, H, W); max_verts below
// 2^31, 19 nc below 2^32. The call's own scratch: totals [3 ceil(max_blocks
// / 4) * 4] u32 (16-byte aligned), keid [max_verts] int64 and ks [max_verts]
// f32 (the kept slots). Writes cell_bits [nc] i32 (0 past the live cells),
// vert_eid [max_verts] int64 (ascending, then INT64_MAX), vert_s [max_verts]
// f32 (then 0), counts [3] int64: kept vertices, all vertices, min(*n_cells,
// nc); and the decode's rank tables of the kept vertices: summary [n_sum]
// u32 (16-byte aligned), n_sum = ceil(D H W 8 / 1024), sum_rank [n_sum] and
// word_rank [min(max_verts, n_sum * 32)] int2. One cooperative launch of at
// most max_blocks resident blocks, no memset. Returns a cudaError_t.
int icon_lattice_emit(const float* cvals, const long long* cx,
                      const long long* cy, const long long* cz,
                      const long long* n_cells, long long nc, int D, int H,
                      int W, float iso, long long max_verts, long long n_sum,
                      unsigned* summary, int* sum_rank, int* word_rank,
                      unsigned* totals, long long max_blocks,
                      long long* keid, float* ks, int* cell_bits,
                      long long* vert_eid, float* vert_s, long long* counts,
                      void* stream) {
  if (D < 2 || H < 2 || W < 2 || nc < 1 || nc > 0xffffffffll / 19 ||
      max_verts < 1 || max_verts >= (1ll << 31) || n_sum < 1 ||
      n_sum >= (1ll << 31) || max_blocks < 1 ||
      reinterpret_cast<uintptr_t>(cvals) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(summary) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(totals) % 16 != 0 ||
      static_cast<long long>(D) * H * W * 8 > n_sum * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  EmitIn in{cvals, cx, cy, cz, n_cells, nc, D, H, W, iso, max_verts};
  EmitOut out{keid, ks, cell_bits, vert_eid, vert_s, counts};
  Tables t{summary, reinterpret_cast<int2*>(sum_rank),
           reinterpret_cast<int2*>(word_rank), totals, n_sum};
  void* args[] = {&in, &out, &t};
  return static_cast<int>(launch_cooperative(
      1, emit_kernel, nc > max_verts ? nc : max_verts, max_blocks, args,
      static_cast<cudaStream_t>(stream)));
}

// The decode's rank tables of ids [cap] (the first *n_ids distinct and
// below n_sum * 1024; the emit's vert_eid), cap below 2^31, as
// lattice_emit leaves them: summary [n_sum] u32, sum_rank [n_sum] and
// word_rank [min(cap, n_sum * 32)] int2; totals [3 ceil(max_blocks / 4) *
// 4] u32 scratch (it and the summary 16-byte aligned). One cooperative
// launch (the emit's rank phases), no memset. Returns a cudaError_t.
int icon_lattice_rank(const long long* ids, const long long* n_ids,
                      long long cap, long long n_sum, unsigned* summary,
                      int* sum_rank, int* word_rank, unsigned* totals,
                      long long max_blocks, void* stream) {
  if (cap < 1 || cap >= (1ll << 31) || n_sum < 1 || n_sum >= (1ll << 31) ||
      max_blocks < 1 || reinterpret_cast<uintptr_t>(summary) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(totals) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t{summary, reinterpret_cast<int2*>(sum_rank),
           reinterpret_cast<int2*>(word_rank), totals, n_sum};
  void* args[] = {&ids, &n_ids, &cap, &t};
  return static_cast<int>(launch_cooperative(
      2, rank_kernel, cap, max_blocks, args,
      static_cast<cudaStream_t>(stream)));
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
  err = grid_for(3, decode_kernel, kDecodeThreads, work, kDecodeThreads,
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
