// The tile rasterizer's raster step, forward and backward, for sm_90a.
//
// Stands for the XLA raster of icon_tpu/ops/raster.py:rasterize (l.123-206:
// edge functions of every (pixel, face) pair of a 32x32 tile, a z-buffer by
// argmin depth, barycentric interpolation of the winning face, and the
// SoftRas silhouette over every face of the tile, all differentiable). The
// per-tile face list [tiles, K] comes from the binning in PyTorch
// (icon_tpu_torch/ops/raster.py:_bin_faces); -1 slots never win and never add
// to the silhouette.
//
// raster_fwd: one block of 256 threads per quarter tile (8 rows of 32
// pixels), one thread per pixel. The block stages its tile's K slots in
// shared memory once (vertex xy and z, the clamped signed area, its sign, the
// three edge lengths), then every thread walks the slots in list order: the
// first face with the strictly smallest depth wins, as torch.argmin keeps the
// first minimum; the silhouette's log(1 - sigmoid) terms are summed over every
// valid slot. Besides the images it keeps, per pixel, the winning slot and the
// log-sum for the backward.
//
// raster_bwd: the same grid, recomputing from the saved winner. The attr and
// depth grads go to the winner's attributes and depths and, through
// w_i = e_i / area, to its vertices (area is a constant where it was
// clamped). The silhouette grad (1 - sil) * sigmoid(z) flows through
// z = sign(s) s^2 / sigma and s = min(d_i * sgn) / scale to the edge that sets
// the minimum (ties split equally at each of the two nested minima, as
// torch.minimum and lax.min do); it is summed over a warp before one
// atomicAdd per slot and vertex coordinate. All grads land in [F, 3, .] by
// atomicAdd; the gather by face outside the kernel sums them per vertex.
//
// Bit-identical edge functions: the edge functions, the area, the
// barycentrics, the depth and the attribute interpolation are written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the plain version's order,
// so no multiply-add contraction moves a pixel's inside test or depth tie
// away from the plain PyTorch version (whose ops each round on their own).
//
// What bounds it on the card: FP32 ALU work, about 40 flops per (pixel, slot)
// pair in the forward (262,144 pixels x 96-256 slots at 512^2), plus the
// expf/log1pf of the silhouette. Device memory sees only the face data once
// per block and the images once. Later work: per-tile dynamic face lists
// (warp-level binning) instead of the dense [tiles, F] overlap matrix, and
// skipping the silhouette's far faces whose sigmoid underflows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e9f;
constexpr int kMaxC = 16;

struct Slot {
  float x0, y0, x1, y1, x2, y2;  // pixel-space vertices
  float z0, z1, z2;
  float area;                    // signed area, clamped to 1e-9 when tiny
  float sgn;                     // sign(area) after the clamp
  float l0, l1, l2;              // |v2 - v1|, |v0 - v2|, |v1 - v0| (+1e-12)
  int face;                      // face id, -1 for an empty slot
  int clamped;                   // area was clamped: no grad through it
};

// (b - a) x (p - a), rounded op by op as the plain version computes it
__device__ __forceinline__ float edge_fn(float ax, float ay, float bx, float by,
                                         float px, float py) {
  return __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(py, ay)),
                   __fmul_rn(__fsub_rn(by, ay), __fsub_rn(px, ax)));
}

__device__ __forceinline__ float edge_len(float ax, float ay, float bx,
                                          float by) {
  const float dx = __fsub_rn(bx, ax), dy = __fsub_rn(by, ay);
  return __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), 1e-12f));
}

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// Stage the K slots of tile t: every thread of the block loads some.
__device__ void stage_slots(const int* __restrict__ face_list,
                            const float* __restrict__ xy,
                            const float* __restrict__ tz, int K, int t,
                            Slot* slots) {
  for (int s = threadIdx.x; s < K; s += blockDim.x) {
    Slot q;
    q.face = face_list[static_cast<size_t>(t) * K + s];
    if (q.face >= 0) {
      const float* v = xy + static_cast<size_t>(q.face) * 6;
      const float* z = tz + static_cast<size_t>(q.face) * 3;
      q.x0 = v[0]; q.y0 = v[1]; q.x1 = v[2]; q.y1 = v[3];
      q.x2 = v[4]; q.y2 = v[5];
      q.z0 = z[0]; q.z1 = z[1]; q.z2 = z[2];
      float area = edge_fn(q.x0, q.y0, q.x1, q.y1, q.x2, q.y2);
      q.clamped = fabsf(area) < 1e-9f;
      if (q.clamped) area = 1e-9f;
      q.area = area;
      q.sgn = sign_of(area);
      q.l0 = edge_len(q.x1, q.y1, q.x2, q.y2);
      q.l1 = edge_len(q.x2, q.y2, q.x0, q.y0);
      q.l2 = edge_len(q.x0, q.y0, q.x1, q.y1);
    } else {
      q.x0 = q.y0 = q.x1 = q.y1 = q.x2 = q.y2 = 0.f;
      q.z0 = q.z1 = q.z2 = 0.f;
      q.area = 1.f; q.sgn = 0.f; q.l0 = q.l1 = q.l2 = 1.f;
      q.clamped = 1;
    }
    slots[s] = q;
  }
}

struct Pixel {
  int x, y, t;
  float px, py;
  bool active;
};

__device__ __forceinline__ Pixel pixel_of(int tile, int tiles_x, int H,
                                          int W) {
  Pixel p;
  p.t = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int r = i / tile, c = i % tile;
  const int ox = (p.t % tiles_x) * tile, oy = (p.t / tiles_x) * tile;
  p.x = ox + c;
  p.y = oy + r;
  p.active = i < tile * tile && p.x < W && p.y < H;
  // pixel centres: (c + 0.5) + tile origin, as the plain version adds them
  p.px = __fadd_rn(static_cast<float>(c) + 0.5f, static_cast<float>(ox));
  p.py = __fadd_rn(static_cast<float>(r) + 0.5f, static_cast<float>(oy));
  return p;
}

// The slot's soft-silhouette logit z and its pieces for the backward.
struct SilTerm {
  float d[3];     // normalized edge functions
  float m1, c;    // min(d0 sgn, d1 sgn), d2 sgn
  float a, b;     // d0 sgn, d1 sgn
  float s;        // signed distance min(...) / scale
  float z;
};

__device__ __forceinline__ SilTerm sil_term(const Slot& q, float e0, float e1,
                                            float e2, float scale,
                                            float sigma) {
  SilTerm o;
  o.d[0] = __fdiv_rn(e0, q.l0);
  o.d[1] = __fdiv_rn(e1, q.l1);
  o.d[2] = __fdiv_rn(e2, q.l2);
  o.a = __fmul_rn(o.d[0], q.sgn);
  o.b = __fmul_rn(o.d[1], q.sgn);
  o.c = __fmul_rn(o.d[2], q.sgn);
  o.m1 = fminf(o.a, o.b);
  o.s = __fdiv_rn(fminf(o.m1, o.c), scale);
  o.z = __fdiv_rn(__fmul_rn(__fmul_rn(sign_of(o.s), o.s), o.s), sigma);
  return o;
}

__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const int* __restrict__ face_list,
                  const float* __restrict__ xy, const float* __restrict__ tz,
                  const float* __restrict__ tattr, int K, int C, int H, int W,
                  int tile, int tiles_x, float scale, float sigma,
                  float* __restrict__ out_attr, float* __restrict__ out_depth,
                  float* __restrict__ out_mask, float* __restrict__ out_sil,
                  long long* __restrict__ out_p2f, int* __restrict__ out_win,
                  float* __restrict__ out_logsum) {
  extern __shared__ Slot slots[];
  const Pixel p = pixel_of(tile, tiles_x, H, W);
  stage_slots(face_list, xy, tz, K, p.t, slots);
  __syncthreads();
  if (!p.active) return;

  int best = -1;
  float bz = kBig, bw0 = 0.f, bw1 = 0.f, bw2 = 0.f, lsum = 0.f;
  for (int s = 0; s < K; ++s) {
    const Slot& q = slots[s];
    if (q.face < 0) continue;
    const float e0 = edge_fn(q.x1, q.y1, q.x2, q.y2, p.px, p.py);
    const float e1 = edge_fn(q.x2, q.y2, q.x0, q.y0, p.px, p.py);
    const float e2 = edge_fn(q.x0, q.y0, q.x1, q.y1, p.px, p.py);
    const float w0 = __fdiv_rn(e0, q.area);
    const float w1 = __fdiv_rn(e1, q.area);
    const float w2 = __fdiv_rn(e2, q.area);
    if (w0 >= -1e-6f && w1 >= -1e-6f && w2 >= -1e-6f) {
      const float zp = __fadd_rn(
          __fadd_rn(__fmul_rn(w0, q.z0), __fmul_rn(w1, q.z1)),
          __fmul_rn(w2, q.z2));
      if (zp < bz) {
        bz = zp; best = s; bw0 = w0; bw1 = w1; bw2 = w2;
      }
    }
    const float z = sil_term(q, e0, e1, e2, scale, sigma).z;
    // log(1 - sigmoid(z)) = -logaddexp(z, 0)
    lsum -= fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
  }

  const size_t o = static_cast<size_t>(p.y) * W + p.x;
  if (best >= 0) {
    const int f = slots[best].face;
    const float* a = tattr + static_cast<size_t>(f) * 3 * C;
    for (int c = 0; c < C; ++c) {
      out_attr[o * C + c] = __fadd_rn(
          __fadd_rn(__fmul_rn(bw0, a[c]), __fmul_rn(bw1, a[C + c])),
          __fmul_rn(bw2, a[2 * C + c]));
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

// g * d|b - a| (the edge length with its 1e-12) into gv
__device__ __forceinline__ void add_len_grad(float g, float len, int ia,
                                             int ib, float ax, float ay,
                                             float bx, float by, float* gv) {
  const float k = g / len;            // d sqrt(q) = dq / (2 len), dq = 2 d
  const float dx = bx - ax, dy = by - ay;
  gv[2 * ib + 0] += k * dx;
  gv[2 * ib + 1] += k * dy;
  gv[2 * ia + 0] -= k * dx;
  gv[2 * ia + 1] -= k * dy;
}

__global__ void __launch_bounds__(kThreads)
raster_bwd_kernel(const int* __restrict__ face_list,
                  const float* __restrict__ xy, const float* __restrict__ tz,
                  const float* __restrict__ tattr, int K, int C, int H, int W,
                  int tile, int tiles_x, float scale, float sigma,
                  const float* __restrict__ g_attr,
                  const float* __restrict__ g_depth,
                  const float* __restrict__ g_sil,
                  const int* __restrict__ win,
                  const float* __restrict__ logsum, float* __restrict__ g_xy,
                  float* __restrict__ g_z, float* __restrict__ g_tattr) {
  extern __shared__ Slot slots[];
  const Pixel p = pixel_of(tile, tiles_x, H, W);
  stage_slots(face_list, xy, tz, K, p.t, slots);
  __syncthreads();
  const size_t o = static_cast<size_t>(p.y) * W + p.x;

  // the winner: attr and depth
  const int best = p.active ? win[o] : -1;
  if (best >= 0 && (g_attr != nullptr || g_depth != nullptr)) {
    const Slot& q = slots[best];
    const int f = q.face;
    const float e[3] = {edge_fn(q.x1, q.y1, q.x2, q.y2, p.px, p.py),
                        edge_fn(q.x2, q.y2, q.x0, q.y0, p.px, p.py),
                        edge_fn(q.x0, q.y0, q.x1, q.y1, p.px, p.py)};
    const float w[3] = {__fdiv_rn(e[0], q.area), __fdiv_rn(e[1], q.area),
                        __fdiv_rn(e[2], q.area)};
    const float zv[3] = {q.z0, q.z1, q.z2};
    const float gd = g_depth != nullptr ? g_depth[o] : 0.f;
    float G[3];
    for (int i = 0; i < 3; ++i) {
      G[i] = gd * zv[i];
      if (gd != 0.f) atomicAdd(g_z + static_cast<size_t>(f) * 3 + i, gd * w[i]);
    }
    if (g_attr != nullptr) {
      const float* a = tattr + static_cast<size_t>(f) * 3 * C;
      float* ga_out = g_tattr + static_cast<size_t>(f) * 3 * C;
      for (int c = 0; c < C; ++c) {
        const float ga = g_attr[o * C + c];
        if (ga == 0.f) continue;
        for (int i = 0; i < 3; ++i) {
          G[i] += ga * a[i * C + c];
          atomicAdd(ga_out + i * C + c, ga * w[i]);
        }
      }
    }
    // w_i = e_i / area
    float gv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float ge0 = G[0] / q.area, ge1 = G[1] / q.area, ge2 = G[2] / q.area;
    add_edge_grad(ge0, 1, 2, q.x1, q.y1, q.x2, q.y2, p.px, p.py, gv);
    add_edge_grad(ge1, 2, 0, q.x2, q.y2, q.x0, q.y0, p.px, p.py, gv);
    add_edge_grad(ge2, 0, 1, q.x0, q.y0, q.x1, q.y1, p.px, p.py, gv);
    if (!q.clamped) {
      // area = edge(v0, v1) at v2
      const float ga = -(G[0] * w[0] + G[1] * w[1] + G[2] * w[2]) / q.area;
      add_edge_grad(ga, 0, 1, q.x0, q.y0, q.x1, q.y1, q.x2, q.y2, gv);
      gv[4] += ga * (q.y0 - q.y1);
      gv[5] += ga * (q.x1 - q.x0);
    }
    float* out = g_xy + static_cast<size_t>(f) * 6;
    for (int k = 0; k < 6; ++k)
      if (gv[k] != 0.f) atomicAdd(out + k, gv[k]);
  }

  if (g_sil == nullptr) return;       // uniform over the grid
  // d sil / d z_s = (1 - sil) sigmoid(z_s), 1 - sil = exp(log-sum)
  const float gs = p.active ? g_sil[o] * expf(logsum[o]) : 0.f;
  const unsigned full = 0xffffffffu;
  for (int s = 0; s < K; ++s) {
    const Slot& q = slots[s];
    if (q.face < 0) continue;          // uniform: the slot is the block's
    float gv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gs != 0.f) {
      const float e0 = edge_fn(q.x1, q.y1, q.x2, q.y2, p.px, p.py);
      const float e1 = edge_fn(q.x2, q.y2, q.x0, q.y0, p.px, p.py);
      const float e2 = edge_fn(q.x0, q.y0, q.x1, q.y1, p.px, p.py);
      const SilTerm t = sil_term(q, e0, e1, e2, scale, sigma);
      const float sig = 1.f / (1.f + expf(-t.z));
      // dz/ds = 2 sign(s) s / sigma; s = min(m1, c) / scale
      const float gmin = gs * sig * 2.f * sign_of(t.s) * t.s / sigma / scale;
      if (gmin != 0.f) {
        const float cm1 = t.m1 < t.c ? 1.f : (t.m1 == t.c ? 0.5f : 0.f);
        const float cc = t.c < t.m1 ? 1.f : (t.m1 == t.c ? 0.5f : 0.f);
        const float ca = t.a < t.b ? 1.f : (t.a == t.b ? 0.5f : 0.f);
        const float cb = t.b < t.a ? 1.f : (t.a == t.b ? 0.5f : 0.f);
        const float gd[3] = {gmin * cm1 * ca * q.sgn, gmin * cm1 * cb * q.sgn,
                             gmin * cc * q.sgn};
        const float ee[3] = {e0, e1, e2};
        const float ll[3] = {q.l0, q.l1, q.l2};
        const float vx[3] = {q.x0, q.x1, q.x2}, vy[3] = {q.y0, q.y1, q.y2};
        for (int j = 0; j < 3; ++j) {
          if (gd[j] == 0.f) continue;
          // edge j runs from vertex (j + 1) % 3 to (j + 2) % 3; d = e / l
          const int ia = (j + 1) % 3, ib = (j + 2) % 3;
          add_edge_grad(gd[j] / ll[j], ia, ib, vx[ia], vy[ia], vx[ib], vy[ib],
                        p.px, p.py, gv);
          add_len_grad(-gd[j] * ee[j] / (ll[j] * ll[j]), ll[j], ia, ib,
                       vx[ia], vy[ia], vx[ib], vy[ib], gv);
        }
      }
    }
    bool any = false;
    for (int k = 0; k < 6; ++k) any |= gv[k] != 0.f;
    if (!__any_sync(full, any)) continue;
    for (int k = 0; k < 6; ++k) {
      float v = gv[k];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(full, v, off);
      gv[k] = v;
    }
    if ((threadIdx.x & 31) == 0) {
      float* out = g_xy + static_cast<size_t>(q.face) * 6;
      for (int k = 0; k < 6; ++k)
        if (gv[k] != 0.f) atomicAdd(out + k, gv[k]);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel* kernel, int K, size_t* smem) {
  *smem = static_cast<size_t>(K) * sizeof(Slot);
  if (*smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  }
  return cudaSuccess;
}

bool bad_shape(int n_tiles, int K, int C, int H, int W, int tile,
               int tiles_x) {
  return n_tiles <= 0 || n_tiles > 65535 || K < 1 || K > 2048 || C < 1 ||
         C > kMaxC || H < 1 || W < 1 || tile < 1 || tile > 256 ||
         tiles_x < 1;
}

}  // namespace

extern "C" {

// face_list [n_tiles, K] int32 (-1 = empty), xy [F, 3, 2], z [F, 3],
// attr [F, 3, C] f32, all contiguous on the device. Writes attr [H, W, C],
// depth, mask, sil [H, W] f32, p2f [H, W] int64, win [H, W] int32 and
// logsum [H, W] f32. Returns a cudaError_t.
int icon_raster_fwd_f32(const int* face_list, const float* xy, const float* z,
                        const float* attr, int n_tiles, int K, int C, int H,
                        int W, int tile, int tiles_x, float scale,
                        float sigma, float* out_attr, float* out_depth,
                        float* out_mask, float* out_sil, long long* out_p2f,
                        int* out_win, float* out_logsum, void* stream) {
  if (bad_shape(n_tiles, K, C, H, W, tile, tiles_x))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = prepare(raster_fwd_kernel, K, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tile * tile + kThreads - 1) / kThreads, n_tiles);
  raster_fwd_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      face_list, xy, z, attr, K, C, H, W, tile, tiles_x, scale, sigma,
      out_attr, out_depth, out_mask, out_sil, out_p2f, out_win, out_logsum);
  return static_cast<int>(cudaGetLastError());
}

// The backward of icon_raster_fwd_f32: g_attr [H, W, C], g_depth and g_sil
// [H, W] (each may be null: no grad), win and logsum as the forward wrote
// them. Adds into g_xy [F, 3, 2], g_z [F, 3] and g_tattr [F, 3, C], which the
// caller zeroes. Returns a cudaError_t.
int icon_raster_bwd_f32(const int* face_list, const float* xy, const float* z,
                        const float* attr, int n_tiles, int K, int C, int H,
                        int W, int tile, int tiles_x, float scale,
                        float sigma, const float* g_attr,
                        const float* g_depth, const float* g_sil,
                        const int* win, const float* logsum, float* g_xy,
                        float* g_z, float* g_tattr, void* stream) {
  if (bad_shape(n_tiles, K, C, H, W, tile, tiles_x))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = prepare(raster_bwd_kernel, K, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tile * tile + kThreads - 1) / kThreads, n_tiles);
  raster_bwd_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      face_list, xy, z, attr, K, C, H, W, tile, tiles_x, scale, sigma, g_attr,
      g_depth, g_sil, win, logsum, g_xy, g_z, g_tattr);
  return static_cast<int>(cudaGetLastError());
}

const char* icon_raster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
