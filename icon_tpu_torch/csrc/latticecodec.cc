// Host decoder of the marching lattice wire (a copy of the JAX package's
// native decoder, icon_tpu/native/src/latticecodec.cc).
//
// The frame's marching (icon_tpu_torch/recon/marching.py) transfers the
// marching-tetrahedra generators instead of an explicit mesh: per vertex an
// edge id and a u8 fraction, per cell its id and corner bits. The host
// rebuilds the faces from (cell id, corner bits) through the tetrahedra
// tables and maps lattice edge ids to vertex ranks in one pass (numpy's
// fancy indexing takes ~0.5 s per 250k-face frame, this loop ~10 ms).
// Called through ctypes, which releases the GIL.
//
// Build: icon_tpu_torch/kernels/build.py:build_host (g++ -O3 -shared
// -fPIC, cached under icon_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Open-addressing (linear probe) map: edge id -> vertex rank. ~250k-face
// frames do ~900k lookups; binary search over the sorted eid array costs
// ~17 dependent loads each (measured 70 ms/frame), the hash probes 1-2
// (measured ~15 ms/frame). Load factor <= 0.5, power-of-two capacity.
struct EdgeMap {
  std::vector<int32_t> key;   // -1 = empty (edge ids are non-negative)
  std::vector<int32_t> rank;
  uint32_t mask = 0;

  void build(const int32_t* eid, long long n) {
    uint64_t cap = 64;
    while (cap < uint64_t(n) * 2) cap <<= 1;
    key.assign(cap, -1);
    rank.resize(cap);
    mask = uint32_t(cap - 1);
    for (long long i = 0; i < n; ++i) {
      uint32_t h = (uint32_t(eid[i]) * 2654435761u) & mask;
      while (key[h] != -1) h = (h + 1) & mask;
      key[h] = eid[i];
      rank[h] = int32_t(i);
    }
  }

  inline int32_t find(int32_t k) const {
    uint32_t h = (uint32_t(k) * 2654435761u) & mask;
    while (true) {
      const int32_t kk = key[h];
      if (kk == k) return rank[h];
      if (kk == -1) return -1;
      h = (h + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// Decode a pack_lattice buffer (see icon_tpu_torch/recon/marching.py layout:
// [header 4 | vert_eid nvb | vert_s u8 x4/word | cell_id ncb |
//  cell_bits u8 x4/word]) into verts [nvb*3] f32 (grid coords) and
// faces [<= ncb*12*3] i32 vertex ranks.
//
// Tables (from the same generator as the device tables):
//   tet_case  [256*6]  u8: per-tet 4-bit marching case for a cell's
//                          8-bit corner-inside config
//   tri_lo    [96*2*3] u8: local corner id (0-7) of the edge end with the
//                          smaller lattice index, per (tet*16+case, tri, v)
//   tri_dcode [96*2*3] u8: edge direction code dx + 2dy + 4dz
//   tri_valid [96*2]   u8: triangle slot emits a face
//
// info[0]=n_verts, info[1]=n_cells, info[2]=overflow (true counts exceeded
// the packed sizes; the mesh is truncated — caller re-packs at full size).
// Returns the number of faces written (not-found edges and degenerate
// faces dropped), or -1 on malformed sizes.
long long icon_lattice_decode(const int32_t* buf, long long nvb,
                              long long ncb, int H, int W,
                              const uint8_t* tet_case, const uint8_t* tri_lo,
                              const uint8_t* tri_dcode,
                              const uint8_t* tri_valid, float* verts,
                              int32_t* faces, int32_t* info) {
  if (nvb <= 0 || ncb <= 0 || H < 2 || W < 2) return -1;
  const int32_t nv_true = buf[0];
  const int32_t nc_true = buf[1];
  const long long nv = nv_true < nvb ? nv_true : nvb;
  const long long nc = nc_true < ncb ? nc_true : ncb;
  info[0] = int32_t(nv);
  info[1] = int32_t(nc);
  info[2] = (nv_true > nvb || nc_true > ncb) ? 1 : 0;
  if (nv <= 0 || nc <= 0) return 0;

  const int32_t* eid = buf + 4;
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(eid + nvb);
  const long long s_words = (nvb + 3) / 4;
  const int32_t* cid = eid + nvb + s_words;
  const uint8_t* cb = reinterpret_cast<const uint8_t*>(cid + ncb);

  // vertices: walk the u8 fraction from the edge's lo end
  const long long HW = (long long)H * W;
  for (long long i = 0; i < nv; ++i) {
    const int32_t e = eid[i];
    const int32_t lo = e >> 3;
    const int d = e & 7;
    // exact division: must reproduce the numpy fallback bit-for-bit
    const float s = float(sb[i]) / 255.0f;
    verts[i * 3 + 0] = float(lo % W) + s * float(d & 1);
    verts[i * 3 + 1] = float((lo / W) % H) + s * float((d >> 1) & 1);
    verts[i * 3 + 2] = float(lo / HW) + s * float((d >> 2) & 1);
  }

  // faces: corner bits -> per-tet cases -> edge ids -> vertex ranks
  EdgeMap map;
  map.build(eid, nv);
  const int cw = W - 1, chh = H - 1;
  long long nf = 0;
  for (long long c = 0; c < nc; ++c) {
    const int32_t idx = cid[c];
    const int32_t cx = idx % cw;
    const int32_t cy = (idx / cw) % chh;
    const int32_t cz = idx / ((long long)cw * chh);
    const unsigned bits = cb[c];
    for (int t = 0; t < 6; ++t) {
      const int e96 = t * 16 + tet_case[bits * 6 + t];
      for (int k = 0; k < 2; ++k) {
        if (!tri_valid[e96 * 2 + k]) continue;
        int32_t r[3];
        bool ok = true;
        for (int j = 0; j < 3 && ok; ++j) {
          const int slot = (e96 * 2 + k) * 3 + j;
          const int lo_loc = tri_lo[slot];
          const long long lin = ((long long)(cz + ((lo_loc >> 2) & 1)) * H +
                                 (cy + ((lo_loc >> 1) & 1))) * W +
                                (cx + (lo_loc & 1));
          const int32_t key = int32_t(lin * 8 + tri_dcode[slot]);
          const int32_t rank = map.find(key);
          if (rank < 0) ok = false;  // edge lost to a device buffer overflow
          r[j] = rank;
        }
        if (!ok || r[0] == r[1] || r[1] == r[2] || r[0] == r[2]) continue;
        faces[nf * 3 + 0] = r[0];
        faces[nf * 3 + 1] = r[1];
        faces[nf * 3 + 2] = r[2];
        ++nf;
      }
    }
  }
  return nf;
}

// Decode the wire-v2 ("implicit eid") lattice buffer
// [header 4 | vert_s u8 x4/word | cell_id ncb | cell_bits u8 x4/word]:
// the vertex edge-id list is NOT transmitted — it is rebuilt here as the
// sorted-unique set of the faces' edge ids (every owned crossing edge is
// referenced by its owner cell's triangles, see marching.py's
// _pack_lattice_fn docstring), then the u8 fractions align to it by rank.
//
// Any truncation (header counts exceeding packed sizes) or derived-count
// mismatch makes the alignment undefined, so those frames return 0 faces
// with info[2]=1 and the caller re-packs with explicit edge ids.
long long icon_lattice_decode_implicit(
    const int32_t* buf, long long nvb, long long ncb, int H, int W,
    const uint8_t* tet_case, const uint8_t* tri_lo, const uint8_t* tri_dcode,
    const uint8_t* tri_valid, float* verts, int32_t* faces, int32_t* info) {
  if (nvb <= 0 || ncb <= 0 || H < 2 || W < 2) return -1;
  const int32_t nv_true = buf[0];
  const int32_t nc_true = buf[1];
  info[0] = 0;
  info[1] = 0;
  info[2] = (nv_true > nvb || nc_true > ncb) ? 1 : 0;
  if (info[2]) return 0;
  const long long nv = nv_true;
  const long long nc = nc_true;
  info[0] = int32_t(nv);
  info[1] = int32_t(nc);
  if (nv <= 0 || nc <= 0) return 0;

  const uint8_t* sb = reinterpret_cast<const uint8_t*>(buf + 4);
  const long long s_words = (nvb + 3) / 4;
  const int32_t* cid = buf + 4 + s_words;
  const uint8_t* cb = reinterpret_cast<const uint8_t*>(cid + ncb);

  // pass A: enumerate face edge ids, staging the key's INSERTION INDEX in
  // the faces buffer (one find-or-insert per reference; the index survives
  // the sort below as a permutation, so pass B is a plain array lookup
  // instead of a second 900k-probe hash pass)
  std::vector<int32_t> uniq;
  uniq.reserve(size_t(nv));
  uint64_t cap = 64;
  while (cap < uint64_t(nv) * 2) cap <<= 1;
  // one (key << 32 | idx) entry per slot: a probe costs one cache line
  constexpr uint64_t kEmpty = ~uint64_t(0);
  std::vector<uint64_t> set_ent(cap, kEmpty);
  const uint32_t smask = uint32_t(cap - 1);
  const int cw = W - 1, chh = H - 1;
  long long nf_raw = 0;
  for (long long c = 0; c < nc; ++c) {
    const int32_t idx = cid[c];
    const int32_t cx = idx % cw;
    const int32_t cy = (idx / cw) % chh;
    const int32_t cz = idx / ((long long)cw * chh);
    const unsigned bits = cb[c];
    for (int t = 0; t < 6; ++t) {
      const int e96 = t * 16 + tet_case[bits * 6 + t];
      for (int k = 0; k < 2; ++k) {
        if (!tri_valid[e96 * 2 + k]) continue;
        for (int j = 0; j < 3; ++j) {
          const int slot = (e96 * 2 + k) * 3 + j;
          const int lo_loc = tri_lo[slot];
          const long long lin = ((long long)(cz + ((lo_loc >> 2) & 1)) * H +
                                 (cy + ((lo_loc >> 1) & 1))) * W +
                                (cx + (lo_loc & 1));
          const int32_t key = int32_t(lin * 8 + tri_dcode[slot]);
          uint32_t h = (uint32_t(key) * 2654435761u) & smask;
          int32_t u;
          while (true) {
            const uint64_t e = set_ent[h];
            if (uint32_t(e >> 32) == uint32_t(key) && e != kEmpty) {
              u = int32_t(uint32_t(e));
              break;
            }
            if (e == kEmpty) {
              if ((long long)uniq.size() >= nv) {  // more edges than verts
                info[0] = 0;
                info[1] = 0;
                info[2] = 1;
                return 0;
              }
              u = int32_t(uniq.size());
              set_ent[h] = (uint64_t(uint32_t(key)) << 32) | uint32_t(u);
              uniq.push_back(key);
              break;
            }
            h = (h + 1) & smask;
          }
          faces[nf_raw * 3 + j] = u;
        }
        ++nf_raw;
      }
    }
  }
  if ((long long)uniq.size() != nv) {
    info[0] = 0;    // verts buffer is not populated on the mismatch path
    info[1] = 0;
    info[2] = 1;
    return 0;
  }

  // rank = position in ascending edge-id order (the device wire order):
  // sort (key << 32 | insertion idx) packed u64s, then invert
  std::vector<uint64_t> keyidx(static_cast<size_t>(nv));
  for (long long i = 0; i < nv; ++i)
    keyidx[size_t(i)] = (uint64_t(uint32_t(uniq[size_t(i)])) << 32) |
                        uint32_t(i);
  std::sort(keyidx.begin(), keyidx.end());
  std::vector<int32_t> rank(static_cast<size_t>(nv));
  const long long HW = (long long)H * W;
  for (long long i = 0; i < nv; ++i) {
    const uint64_t ki = keyidx[size_t(i)];
    rank[size_t(uint32_t(ki))] = int32_t(i);
    const int32_t e = int32_t(uint32_t(ki >> 32));
    const int32_t lo = e >> 3;
    const int d = e & 7;
    const float s = float(sb[i]) / 255.0f;
    verts[i * 3 + 0] = float(lo % W) + s * float(d & 1);
    verts[i * 3 + 1] = float((lo / W) % H) + s * float((d >> 1) & 1);
    verts[i * 3 + 2] = float(lo / HW) + s * float((d >> 2) & 1);
  }

  // pass B: staged insertion indices -> ranks, dropping degenerates
  long long nf = 0;
  for (long long f = 0; f < nf_raw; ++f) {
    const int32_t r0 = rank[size_t(faces[f * 3 + 0])];
    const int32_t r1 = rank[size_t(faces[f * 3 + 1])];
    const int32_t r2 = rank[size_t(faces[f * 3 + 2])];
    if (r0 == r1 || r1 == r2 || r0 == r2) continue;
    faces[nf * 3 + 0] = r0;
    faces[nf * 3 + 1] = r1;
    faces[nf * 3 + 2] = r2;
    ++nf;
  }
  return nf;
}

}  // extern "C"
