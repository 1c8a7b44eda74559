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
// (Merrill and Garland) over tiles of 256 coarse cells, a thread a cell,
// in the order of an atomic ticket. A thread tests its coarse cell's 8
// corners; a mixed cell loads the 3^3 fine points its 8 fine cells span
// (the fine grid is the coarse one's 2x align_corners upsample sliced by
// one, so coarse cell c covers fine cells 2c - 1 and 2c an axis) and tests
// each fine cell exactly on its own 8 corners. The scan sums two counts a
// cell, packed in one word: mixed coarse cells, and alive fine cells. A
// mixed cell's rank among the mixed cells says whether it lies within the
// candidate budget (the first nc_budget); within it, its alive fine cells
// take the slots from its alive count's prefix on, in the fine cells'
// corner order: the candidate order of _compact. Since the cells within
// the budget are a prefix of the linear order, the prefix of the alive
// counts over all mixed cells is exact for every cell within the budget.
// Slots past max_cells are dropped. A cell writes its coordinates, its
// linear id and its 8 corner values. The block that finishes the last
// tile writes n_cells = min(alive, max_cells) and n_cells_total = alive +
// 8 max(mixed - nc_budget, 0). Without a coarse grid the fine cells are
// tested directly, a thread a cell, with no budget. The C entry zeroes the
// outputs, so rows past n_cells are 0, and the scan's scratch.
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
//    summary giving each touched bitmap word its ids before it, and a
//    write of each kept (id, s) at its rank. The rows past the kept count
//    get the id INT64_MAX and s = 0.
//
// lattice_decode (one launch): the host decoder's mesh from the emit's
// outputs, written into one int32 buffer [header 4 | verts 3 nvb f32 |
// faces 3 nfb i32] that one copy takes to the host. A single-pass scan
// over tiles of 128 cells, a thread a cell: its 6 tets' cases from its
// corner byte, their triangle slots in the codec's order (tet, then slot)
// through the codec's tables, each vertex's edge id ranked by a binary
// search over the sorted ids; a face whose edge is not found (dropped by
// an overflow) or whose ranks repeat is dropped, as
// csrc/latticecodec.cc:137-140 drops it. The tile's faces take their
// positions from the scan, the first nfb written. Each block then writes
// vertices: s quantized as pack_lattice quantizes it (rint(s * 255),
// clamped to [0, 255]), s8 / 255 by exact division and lo + s8 / 255 * d
// an axis, each operation rounded on its own (no contraction), as the
// host decoder computes them. The header holds (vertices, faces, cells,
// 0), the true counts; the host reads an overflow where they exceed nvb
// or nfb.
//
// Bound: bytes. lattice_cells reads the coarse grid and the fine points of
// the mixed coarse cells and writes 64 B an alive cell; lattice_emit reads
// 56 B an alive cell and writes 12 B a vertex twice and 4 B a cell;
// lattice_decode reads 12 B an alive cell and 12 B a vertex and writes 12
// B a vertex and 12 B a face.

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
// the host codec's tables (recon/lattice_host.py:_host_tables_flat)
__constant__ unsigned char c_tet_case[256 * 6];
__constant__ unsigned char c_tri_lo[96 * 2 * 3];
__constant__ unsigned char c_tri_dcode[96 * 2 * 3];
__constant__ unsigned char c_tri_valid[96 * 2];

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

// lattice_cells' scratch words before the scan's
constexpr int kCellsDone = 0;        // tiles finished
constexpr int kCellsAlive = 1;       // alive cells within the budget
constexpr int kCellsTotals = 2;      // the scan's inclusive total
constexpr int kCellsScan = 3;        // the scan's ticket and statuses

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

__global__ void __launch_bounds__(kThreads)
cells_kernel(Strided fine, Strided coarse, bool use_coarse, float iso,
             long long n_items, long long nc_budget, long long max_cells,
             CellsOut out, unsigned long long* __restrict__ scratch) {
  __shared__ unsigned long long warp_sums[32];
  __shared__ unsigned long long sBefore;
  __shared__ long long sTile;
  const Scan sc = scan_of(scratch + kCellsScan);
  const long long tiles = (n_items + kThreads - 1) / kThreads;
  const int cw = fine.W - 1, ch = fine.H - 1, cd = fine.D - 1;
  // the grid whose cells the threads take
  const int iw = use_coarse ? coarse.W - 1 : cw;
  const int ih = use_coarse ? coarse.H - 1 : ch;
  for (long long tile; (tile = next_tile(sc, tiles, &sTile)) >= 0;) {
    const long long i = tile * kThreads + threadIdx.x;
    int x = 0, y = 0, z = 0;
    unsigned mixed = 0, alive = 0;   // alive: a bit a fine cell
    float pts[27];                   // use_coarse: [z][y][x] fine points
    if (i < n_items) {
      x = static_cast<int>(i % iw);
      y = static_cast<int>((i / iw) % ih);
      z = static_cast<int>(i / (static_cast<long long>(iw) * ih));
      const Strided& g = use_coarse ? coarse : fine;
      unsigned in = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        in |= (g.at(z + ((c >> 2) & 1), y + ((c >> 1) & 1), x + (c & 1)) >
               iso) << c;
      mixed = in != 0 && in != 0xffu;
      if (!use_coarse) {
        alive = mixed;
      } else if (mixed) {
        const int bx = 2 * x - 1, by = 2 * y - 1, bz = 2 * z - 1;
#pragma unroll
        for (int k = 0; k < 27; ++k) {
          const int px = bx + k % 3, py = by + (k / 3) % 3, pz = bz + k / 9;
          pts[k] = (px >= 0 && px < fine.W && py >= 0 && py < fine.H &&
                    pz >= 0 && pz < fine.D) ? fine.at(pz, py, px) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int ox = k & 1, oy = (k >> 1) & 1, oz = (k >> 2) & 1;
          const int fx = bx + ox, fy = by + oy, fz = bz + oz;
          if (fx < 0 || fx >= cw || fy < 0 || fy >= ch || fz < 0 ||
              fz >= cd)
            continue;
          unsigned fin = 0;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            fin |= (pts[(oz + ((c >> 2) & 1)) * 9 + (oy + ((c >> 1) & 1)) * 3 +
                        ox + (c & 1)] > iso) << c;
          if (fin != 0 && fin != 0xffu) alive |= 1u << k;
        }
      }
    }
    const unsigned long long mine =
        (use_coarse ? mixed : 0u) |
        (static_cast<unsigned long long>(__popc(alive)) << kHiShift);
    unsigned long long total;
    const unsigned long long in_tile = block_scan(mine, &total, warp_sums);
    const unsigned long long before =
        tile_prefix(sc, tile, total, &sBefore) + in_tile;
    const long long rank = static_cast<long long>(before & kLoMask);
    long long slot = static_cast<long long>(before >> kHiShift);
    if (use_coarse && mixed && rank < nc_budget) {
      if (rank == nc_budget - 1)     // the budget's last mixed cell
        scratch[kCellsAlive] = slot + __popc(alive);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (!((alive >> k) & 1u)) continue;
        if (slot < max_cells) {
          const int ox = k & 1, oy = (k >> 1) & 1, oz = (k >> 2) & 1;
          float v8[8];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            v8[c] = pts[(oz + ((c >> 2) & 1)) * 9 +
                        (oy + ((c >> 1) & 1)) * 3 + ox + (c & 1)];
          write_cell(out, slot, 2 * x - 1 + ox, 2 * y - 1 + oy,
                     2 * z - 1 + oz, cw, ch, v8);
        }
        ++slot;
      }
    } else if (!use_coarse && alive && slot < max_cells) {
      float v8[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v8[c] = fine.at(z + ((c >> 2) & 1), y + ((c >> 1) & 1), x + (c & 1));
      write_cell(out, slot, x, y, z, cw, ch, v8);
    }
    if (threadIdx.x == 0 && tile == tiles - 1)
      scratch[kCellsTotals] = (before - in_tile) + total;
    // the block that finishes the last tile writes the counts
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long done =
          atomicAdd(scratch + kCellsDone, 1ull);
      if (done == static_cast<unsigned long long>(tiles - 1)) {
        __threadfence();
        const unsigned long long tot = load_status(scratch + kCellsTotals);
        const long long m = static_cast<long long>(tot & kLoMask);
        long long n_alive = static_cast<long long>(tot >> kHiShift);
        if (use_coarse && m > nc_budget)
          n_alive = nc_budget > 0
                        ? static_cast<long long>(
                              load_status(scratch + kCellsAlive))
                        : 0;
        const long long dropped = use_coarse && m > nc_budget
                                      ? m - nc_budget : 0;
        *out.n_cells = n_alive < max_cells ? n_alive : max_cells;
        *out.n_cells_total = n_alive + 8 * dropped;
      }
    }
  }
}

// lattice_emit's scan scratch: the emit's and the summary's, then the
// summary itself
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

// The rank of `key` among the n sorted ids, or -1 if it is not one.
__device__ __forceinline__ int find_rank(const long long* __restrict__ ids,
                                         long long n, long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo < n && __ldg(ids + lo) == key ? static_cast<int>(lo) : -1;
}

__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const long long* __restrict__ vert_eid,
              const float* __restrict__ vert_s,
              const long long* __restrict__ n_verts, long long nv_cap,
              const long long* __restrict__ cell_id,
              const int* __restrict__ cell_bits,
              const long long* __restrict__ n_cells, long long nc_cap, int H,
              int W, long long nvb, long long nfb, int* __restrict__ buf,
              unsigned long long* __restrict__ scratch) {
  __shared__ unsigned long long warp_sums[32];
  __shared__ unsigned long long sBefore;
  __shared__ long long sTile;
  __shared__ int sFaces[kDecodeThreads * 12 * 3];
  const Scan sc = scan_of(scratch);
  long long nv = *n_verts, nc = *n_cells;
  nv = nv < 0 ? 0 : (nv > nv_cap ? nv_cap : nv);
  nc = nc < 0 ? 0 : (nc > nc_cap ? nc_cap : nc);
  const long long tiles = nc > 0 ? (nc + kDecodeThreads - 1) /
                                       kDecodeThreads : 1;
  const long long cw = W - 1, ch = H - 1;
  int* faces = buf + 4 + 3 * nvb;
  for (long long tile; (tile = next_tile(sc, tiles, &sTile)) >= 0;) {
    const long long c = tile * kDecodeThreads + threadIdx.x;
    int* mine = sFaces + threadIdx.x * 36;
    int n = 0;
    if (c < nc && nv > 0) {
      const long long idx = cell_id[c];
      const long long x = idx % cw, y = (idx / cw) % ch, z = idx / (cw * ch);
      const unsigned bits = static_cast<unsigned>(cell_bits[c]) & 0xffu;
      for (int t = 0; t < 6; ++t) {
        const int e96 = t * 16 + c_tet_case[bits * 6 + t];
        for (int k = 0; k < 2; ++k) {
          if (!c_tri_valid[e96 * 2 + k]) continue;
          int r[3];
          bool ok = true;
          for (int j = 0; j < 3 && ok; ++j) {
            const int slot = (e96 * 2 + k) * 3 + j;
            const int lo = c_tri_lo[slot];
            const long long lin = ((z + ((lo >> 2) & 1)) * H +
                                   (y + ((lo >> 1) & 1))) * W +
                                  (x + (lo & 1));
            r[j] = find_rank(vert_eid, nv, lin * 8 + c_tri_dcode[slot]);
            ok = r[j] >= 0;
          }
          if (!ok || r[0] == r[1] || r[1] == r[2] || r[0] == r[2]) continue;
          mine[n * 3 + 0] = r[0];
          mine[n * 3 + 1] = r[1];
          mine[n * 3 + 2] = r[2];
          ++n;
        }
      }
    }
    unsigned long long total;
    const unsigned long long in_tile = block_scan(n, &total, warp_sums);
    const unsigned long long first = tile_prefix(sc, tile, total, &sBefore);
    const long long at = static_cast<long long>(first + in_tile);
    for (int f = 0; f < n && at + f < nfb; ++f) {
      faces[(at + f) * 3 + 0] = mine[f * 3 + 0];
      faces[(at + f) * 3 + 1] = mine[f * 3 + 1];
      faces[(at + f) * 3 + 2] = mine[f * 3 + 2];
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

}  // namespace

extern "C" {

// The edge slots [19, 3] and the host codec's flat tables (tet_case
// [256 * 6], tri_lo and tri_dcode [96 * 2 * 3], tri_valid [96 * 2]), all
// u8. Call once a device before the first launch. Returns a cudaError_t.
int icon_lattice_set_tables(const unsigned char* slots,
                            const unsigned char* tet_case,
                            const unsigned char* tri_lo,
                            const unsigned char* tri_dcode,
                            const unsigned char* tri_valid) {
  cudaError_t err = cudaMemcpyToSymbol(c_slots, slots, sizeof(c_slots));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(c_tet_case, tet_case, sizeof(c_tet_case));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(c_tri_lo, tri_lo, sizeof(c_tri_lo));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(c_tri_dcode, tri_dcode, sizeof(c_tri_dcode));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(c_tri_valid, tri_valid, sizeof(c_tri_valid));
  return static_cast<int>(err);
}

// Cells a tile of lattice_cells' and lattice_emit's scans; of
// lattice_decode's.
int icon_lattice_tile_cells() { return kThreads; }
int icon_lattice_decode_tile_cells() { return kDecodeThreads; }

// fine [D, H, W] f32 at element strides fs (3); coarse [Dc, Hc, Wc] f32 at
// strides cs, or null for the fine grid's own mixed cells; out [8 *
// max_cells] int64 words: cx, cy, cz, cell ids [max_cells] int64, then
// the corner values [max_cells, 8] f32 (zeroed here, so rows past the
// count are 0); counts [2] int64: n_cells, n_cells_total; scratch [3 + 1 +
// tiles] u64 (zeroed here), tiles = ceil(cells scanned / 256). Returns a
// cudaError_t.
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
  const long long n_items =
      use_coarse ? static_cast<long long>(Dc - 1) * (Hc - 1) * (Wc - 1)
                 : static_cast<long long>(D - 1) * (H - 1) * (W - 1);
  // both scanned counts stay below 2^31
  if ((use_coarse ? 8 * n_items : n_items) >= (1ll << kHiShift))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n_items + kThreads - 1) / kThreads;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (kCellsScan + 1 + tiles) * sizeof(unsigned long long), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(out, 0, 8 * max_cells * sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  err = grid_for(0, cells_kernel, kThreads, n_items, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strided f{fine, D, H, W, fs[0], fs[1], fs[2]};
  const Strided c{use_coarse ? coarse : fine, Dc, Hc, Wc,
                  use_coarse ? cs[0] : 0, use_coarse ? cs[1] : 0,
                  use_coarse ? cs[2] : 0};
  const CellsOut o{out, out + max_cells, out + 2 * max_cells,
                   out + 3 * max_cells,
                   reinterpret_cast<float*>(out + 4 * max_cells), counts,
                   counts + 1};
  cells_kernel<<<grid, kThreads, 0, s>>>(f, c, use_coarse, iso, n_items,
                                         use_coarse ? nc_budget : 0,
                                         max_cells, o, scratch);
  return static_cast<int>(cudaGetLastError());
}

// cvals [nc, 8] f32 (16-byte aligned), cx, cy, cz [nc] int64 and *n_cells
// (cells at and past it are dead) on a fine grid (D, H, W). keid
// [max_verts] int64 and ks [max_verts] f32: scratch for the kept slots;
// bitmap [n_sum * 32] u32 (any contents), n_sum = ceil(D H W 8 / 1024);
// scratch [1 + ceil(nc / 256) + 1 + ceil(n_sum / 256) + ceil(n_sum / 2)]
// u64 (the two scans' and the summary, zeroed here); sum_rank [n_sum] and
// word_rank [min(max_verts, n_sum * 32)] int2. Writes cell_bits [nc] i32
// (0 past the live cells), vert_eid [max_verts] int64 (ascending, then
// INT64_MAX), vert_s [max_verts] f32 (then 0) and counts [2] int64: kept
// vertices, all vertices. Returns a cudaError_t.
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
  const long long emit_words = 1 + (nc + kThreads - 1) / kThreads;
  const long long rank_words = 1 + (n_sum + kThreads - 1) / kThreads;
  const long long words = emit_words + rank_words + (n_sum + 1) / 2;
  unsigned long long* rank_scan = scratch + emit_words;
  unsigned* summary = reinterpret_cast<unsigned*>(rank_scan + rank_words);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  err = grid_for(1, emit_kernel, kThreads, nc, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  emit_kernel<<<grid, kThreads, 0, s>>>(
      cvals, cx, cy, cz, n_cells, nc, D, H, W, iso, max_verts,
      EmitOut{keid, ks, cell_bits, counts}, scratch);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = grid_for(2, clear_kernel, kThreads, max_verts, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  clear_kernel<<<grid, kThreads, 0, s>>>(keid, counts, bitmap);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = grid_for(3, mark_kernel, kThreads, max_verts, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_kernel<<<grid, kThreads, 0, s>>>(keid, counts, bitmap, summary);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = grid_for(4, rank_kernel, kThreads, n_sum, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_kernel<<<grid, kThreads, 0, s>>>(
      n_sum, bitmap, summary, reinterpret_cast<int2*>(sum_rank),
      reinterpret_cast<int2*>(word_rank), rank_scan);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = grid_for(5, place_kernel, kThreads, max_verts, kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  place_kernel<<<grid, kThreads, 0, s>>>(
      keid, ks, counts, reinterpret_cast<const int2*>(sum_rank),
      reinterpret_cast<const int2*>(word_rank), max_verts, vert_eid, vert_s);
  return static_cast<int>(cudaGetLastError());
}

// The emit's vert_eid, vert_s [nv_cap] (the first *n_verts live, ids
// ascending), cell_id [nc_cap] int64 and cell_bits [nc_cap] i32 (the first
// *n_cells live) on a marched grid of H x W points a slice; buf [4 + 3 nvb
// + 3 nfb] i32; scratch [1 + ceil(nc_cap / 128)] u64 (zeroed here).
// Writes the header (vertices, faces, cells, 0), the first nvb vertices
// and the first nfb faces. Returns a cudaError_t.
int icon_lattice_decode(const long long* vert_eid, const float* vert_s,
                        const long long* n_verts, long long nv_cap,
                        const long long* cell_id, const int* cell_bits,
                        const long long* n_cells, long long nc_cap, int H,
                        int W, long long nvb, long long nfb, int* buf,
                        unsigned long long* scratch, void* stream) {
  if (H < 2 || W < 2 || nv_cap < 1 || nc_cap < 1 || nvb < 0 || nfb < 0 ||
      12 * nc_cap >= (1ll << 31))
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
      H, W, nvb, nfb, buf, scratch);
  return static_cast<int>(cudaGetLastError());
}

const char* icon_lattice_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
