// Tile z-buffer rasterizer for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel audio2photoreal_tpu/ops/pallas_raster.py
// (rasterize_pallas -> _raster_kernel): for every pixel centre (integer
// coordinates) of a [B, H, W] image, the nearest face whose barycentric
// inside test passes, its depth, and its barycentrics or its interpolated
// per-corner UV.  Semantics are those of the plain version
// (kernels/raster.py:rasterize_reference):
//   w0 = (A0*dx + B0*dy) * inv_det, w1 = (A1*dx + B1*dy) * inv_det,
//   w2 = (1 - w0) - w1, z = (w0*za + w1*zb) + w2*zc,
//   inside: w0, w1, w2 >= 0, |det| > 1e-12, z > 1e-6; nearest z wins and
//   ties go to the lowest face id.
// Every product, sum and quotient is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot contract them into FMAs and the
// kernel takes exactly the plain version's rounding steps: face ids equal
// the plain version's on the card bit for bit.
//
// Design: per-tile face worklists, built on the device in every call with no
// host sync.  One C call puts a memset and four kernels on the caller's
// stream.
//  1. raster_setup_kernel, one thread per (frame, face): the face's 64-byte
//     record (corner terms, 1/det, depths, corner UVs, in the plain version's
//     rounding steps; the TPU kernel does this per face in its body,
//     pallas_raster.py:186-197) and its tile rectangle: the 16x16 tiles whose
//     pixel centres, widened by one pixel, its screen bbox reaches, clamped to
//     the image's tiles.  Tile t of a row is reached when x_min <= 16t + 16 and
//     x_max >= 16t - 1; the bbox is clamped to [-32, 16 ntx + 32] before it is
//     scaled, rounded or turned into an integer, which changes no tile (a
//     corner at +-1e30 cannot overflow) and x_max + 1 rounds to nearest, so a
//     face is never dropped at a tile edge: the rectangle is the tiles the
//     sweep of the earlier design listed, or a superset.  Faces that can never
//     pass (|det| <= 1e-12, a non-finite corner, a corner index outside
//     [0, V)) reach no tile.  A face that reaches at most kSmallTiles tiles
//     adds one to each of their counts; a larger face is appended to the list
//     of every coarse bin (bin_tiles x bin_tiles tiles, at most kMaxBins bins a
//     frame) that its rectangle reaches.  A bin lists each face at most once,
//     so its F entries cannot overflow.
//  2. raster_scan_kernel, one block per frame: the exclusive scan of the
//     frame's tile counts gives each tile its start in the frame's part of
//     the worklist buffer, which holds F x kSmallTiles ids and so cannot
//     overflow either.
//  3. raster_fill_kernel, one thread per (frame, face): each small face writes
//     its id into the list of every tile it reaches (an atomic cursor per
//     tile; the cursor ends at the list's end).
//  4. raster_kernel, one block of 256 threads per tile of one frame, one
//     thread per pixel; ragged H and W are masked at the store.  The block
//     stages its tile's list, kStage records a shared-memory stage (cp.async),
//     then its coarse bin's large faces whose rectangle holds the tile, and
//     every pixel tests the staged faces against a running (z, face id) kept
//     in registers, with one store per output plane at the end.  A crowded
//     tile takes as many stages as it needs; a tile with empty lists reads no
//     face data and writes background.
// The (z, id) compare makes the result independent of the order in which a
// tile's faces are listed, so the atomics leave the outputs bit-identical
// from run to run.  The TPU kernel's Morton sort, VMEM budget clamp and
// 8-row worklist padding are TPU constraints and are not carried over.
//
// What bounds it.  Each (pixel, face) test costs 17 f32 arithmetic
// operations (9 mul, 8 add/sub, none fusable) and 4 compares, the record read
// from shared memory as a broadcast; the test stops at the first of its
// steps that fails in all 32 pixels of a warp.  The function needs the tests
// of each face's bbox widened by one pixel (the plain version's window); the
// kernel tests every in-image pixel of each listed tile, a few times more
// for small faces.  Output: 4 + 4 + 8 (uv) or 12 (barys) bytes per pixel.
// Scratch traffic: per (frame, face) a 64-byte record and a 16-byte
// rectangle written once and read once per listed tile, plus 4 bytes per
// listed (tile, face) and per (bin, large face); per tile three ints.  At
// the render's shapes (B 8, 1024x667, 9,322 faces, about 2 tiles a face)
// that is under 10 MB against 87 MB of output, so the output bytes bound it,
// on the 85,562-face mesh too.  The earlier design had every tile sweep the
// bbox of every face of its frame: 9,322 x 16 bytes for each of 21,504
// tiles, 3.2 GB through L1/L2 per call, growing with tiles x faces; that
// sweep is gone.  Scratch size (raster_scratch_bytes, which the caller
// allocates): 64 + 16 + 4 kSmallTiles + 4 nbins bytes per (frame, face) and
// 12 bytes per tile.  On an H100 the output stores take the largest part of
// the tile kernel's time, then the tests (tools/torch_raster_variants.py
// takes the parts out one by one; PERF.md).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 16;             // tile is kTile x kTile pixels
constexpr int kThreads = kTile * kTile;  // one thread per pixel
constexpr int kStage = kThreads;      // face records staged in shared memory at a time
constexpr int kSmallTiles = 16;       // a face reaching more tiles goes to the coarse bins
constexpr int kMaxBins = 16;          // coarse bins per frame, at most (bin_tiles is chosen for it)
constexpr int kScanThreads = 1024;

struct Grid {
  int ntx, nty;     // tiles per row and per column
  int bin_tiles;    // a coarse bin is bin_tiles x bin_tiles tiles
  int nbx, nbins;   // bins per row; bins per frame
};

// First and last tile of n whose widened pixel centres a bbox edge reaches.
// Clamped first: any value outside [-32, 16 n + 32] gives the same tile after
// the clamp to [0, n - 1], and the clamped value is small enough to convert.
__device__ __forceinline__ int first_tile(float lo, int n) {
  const float c = fminf(fmaxf(lo, -32.f), static_cast<float>(n * kTile + 32));
  return max(static_cast<int>(ceilf(__fmul_rn(c, 1.f / kTile))) - 1, 0);
}

__device__ __forceinline__ int last_tile(float hi, int n) {
  const float c = fminf(fmaxf(hi, -32.f), static_cast<float>(n * kTile + 32));
  return min(static_cast<int>(floorf(__fmul_rn(__fadd_rn(c, 1.f), 1.f / kTile))), n - 1);
}

__device__ __forceinline__ bool is_small(const int4& r) {
  return (r.y - r.x + 1) * (r.w - r.z + 1) <= kSmallTiles;
}

// Face record, 16 floats:
//   0 xc  1 yc  2 A0=yb-yc  3 B0=xc-xb  4 A1=yc-ya  5 B1=xa-xc  6 inv_det
//   7 za  8 zb  9 zc  10 ua 11 va 12 ub 13 vb 14 uc 15 vc
// rect: first and last tile column, first and last tile row; (0, -1, 0, -1)
// where the face reaches no tile.
__global__ void raster_setup_kernel(const float2* __restrict__ pix, const float* __restrict__ depth,
                                    const long long* __restrict__ faces, const float* __restrict__ face_uv,
                                    int B, int V, int F, Grid g, float4* __restrict__ rec,
                                    int4* __restrict__ rect, int* __restrict__ tile_count,
                                    int* __restrict__ bin_count, int* __restrict__ bin_list) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * F) return;
  const int b = static_cast<int>(i / F);
  const int f = static_cast<int>(i % F);
  const long long* fi = faces + static_cast<size_t>(f) * 3;
  const long long ia = fi[0], ib = fi[1], ic = fi[2];
  const bool in_range = ia >= 0 && ia < V && ib >= 0 && ib < V && ic >= 0 && ic < V;
  const size_t vb = static_cast<size_t>(b) * V;
  const float2 pa = in_range ? pix[vb + ia] : make_float2(0.f, 0.f);
  const float2 pb = in_range ? pix[vb + ib] : make_float2(0.f, 0.f);
  const float2 pc = in_range ? pix[vb + ic] : make_float2(0.f, 0.f);
  const float za = in_range ? depth[vb + ia] : 0.f;
  const float zb = in_range ? depth[vb + ib] : 0.f;
  const float zc = in_range ? depth[vb + ic] : 0.f;
  // det = (yb - yc) * (xa - xc) + (xc - xb) * (ya - yc), as the plain version
  const float A0 = __fsub_rn(pb.y, pc.y), B0 = __fsub_rn(pc.x, pb.x);
  const float A1 = __fsub_rn(pc.y, pa.y), B1 = __fsub_rn(pa.x, pc.x);
  const float det = __fadd_rn(__fmul_rn(A0, B1), __fmul_rn(B0, __fsub_rn(pa.y, pc.y)));
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = ok ? __fdiv_rn(1.0f, det) : 0.f;
  float4* r = rec + i * 4;
  r[0] = make_float4(pc.x, pc.y, A0, B0);
  r[1] = make_float4(A1, B1, inv_det, za);
  if (face_uv != nullptr) {
    const float* u = face_uv + static_cast<size_t>(f) * 6;
    r[2] = make_float4(zb, zc, u[0], u[1]);
    r[3] = make_float4(u[2], u[3], u[4], u[5]);
  } else {
    r[2] = make_float4(zb, zc, 0.f, 0.f);
    r[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const bool live = in_range && ok && isfinite(pa.x) && isfinite(pa.y) && isfinite(pb.x) &&
                    isfinite(pb.y) && isfinite(pc.x) && isfinite(pc.y);
  int4 t = make_int4(0, -1, 0, -1);
  if (live) {
    t = make_int4(first_tile(fminf(fminf(pa.x, pb.x), pc.x), g.ntx),
                  last_tile(fmaxf(fmaxf(pa.x, pb.x), pc.x), g.ntx),
                  first_tile(fminf(fminf(pa.y, pb.y), pc.y), g.nty),
                  last_tile(fmaxf(fmaxf(pa.y, pb.y), pc.y), g.nty));
    if (t.x > t.y || t.z > t.w) t = make_int4(0, -1, 0, -1);
  }
  rect[i] = t;
  if (t.x > t.y) return;
  if (is_small(t)) {
    int* count = tile_count + static_cast<size_t>(b) * g.ntx * g.nty;
    for (int ty = t.z; ty <= t.w; ++ty)
      for (int tx = t.x; tx <= t.y; ++tx) atomicAdd(count + ty * g.ntx + tx, 1);
  } else {
    for (int by = t.z / g.bin_tiles; by <= t.w / g.bin_tiles; ++by)
      for (int bx = t.x / g.bin_tiles; bx <= t.y / g.bin_tiles; ++bx) {
        const int bin = b * g.nbins + by * g.nbx + bx;
        bin_list[static_cast<size_t>(bin) * F + atomicAdd(bin_count + bin, 1)] = f;
      }
  }
}

// One block per frame: start[t] = the frame's base (frame x cap) + the sum of
// the counts of the tiles before t; end[t] = start[t], the fill's cursor.
__global__ void __launch_bounds__(kScanThreads)
raster_scan_kernel(const int* __restrict__ tile_count, int T, int cap, int* __restrict__ start,
                   int* __restrict__ end) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int b = blockIdx.x;
  const int per = (T + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, T), hi = min(lo + per, T);
  const int* count = tile_count + static_cast<size_t>(b) * T;
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += count[t];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;  // inclusive scan within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int run = b * cap + (incl - sum) + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int t = lo; t < hi; ++t) {
    const size_t k = static_cast<size_t>(b) * T + t;
    start[k] = run;
    end[k] = run;
    run += count[t];
  }
}

__global__ void raster_fill_kernel(const int4* __restrict__ rect, int B, int F, Grid g,
                                   int* __restrict__ end, int* __restrict__ tile_list) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * F) return;
  const int4 t = rect[i];
  if (t.x > t.y || !is_small(t)) return;
  const int b = static_cast<int>(i / F);
  const int f = static_cast<int>(i % F);
  int* cursor = end + static_cast<size_t>(b) * g.ntx * g.nty;
  for (int ty = t.z; ty <= t.w; ++ty)
    for (int tx = t.x; tx <= t.y; ++tx) tile_list[atomicAdd(cursor + ty * g.ntx + tx, 1)] = f;
}

// cp.async of one 64-byte record into shared memory (16 bytes a copy).
__device__ __forceinline__ void stage_record(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * k), "l"(src + k) : "memory");
}

__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A pixel's running nearest face.
struct Nearest {
  float z;
  int f;
  float w0, w1, w2, u, v;

  // Test the n staged faces at pixel centre (px, py).  Each step of the
  // inside test is taken only while it can still pass, so a warp whose 32
  // pixels all fail an edge skips the rest; the values are the same.
  __device__ __forceinline__ void test(const float4 (*s_rec)[4], const int* s_id, int n, float px,
                                       float py, bool with_uv) {
    for (int i = 0; i < n; ++i) {
      const float4 r0 = s_rec[i][0];  // xc yc A0 B0
      const float4 r1 = s_rec[i][1];  // A1 B1 inv_det za
      const float dx = __fsub_rn(px, r0.x);
      const float dy = __fsub_rn(py, r0.y);
      const float a = __fmul_rn(__fadd_rn(__fmul_rn(r0.z, dx), __fmul_rn(r0.w, dy)), r1.z);
      if (!(a >= 0.f)) continue;
      const float b = __fmul_rn(__fadd_rn(__fmul_rn(r1.x, dx), __fmul_rn(r1.y, dy)), r1.z);
      if (!(b >= 0.f)) continue;
      const float c = __fsub_rn(__fsub_rn(1.0f, a), b);
      if (!(c >= 0.f)) continue;
      const float4 r2 = s_rec[i][2];  // zb zc ua va
      const float zz = __fadd_rn(__fadd_rn(__fmul_rn(a, r1.w), __fmul_rn(b, r2.x)), __fmul_rn(c, r2.y));
      if (!(zz > 1e-6f)) continue;
      const int id = s_id[i];
      if (zz < z || (zz == z && id < f)) {
        z = zz;
        f = id;
        w0 = a;
        w1 = b;
        w2 = c;
        if (with_uv) {
          const float4 r3 = s_rec[i][3];  // ub vb uc vc
          u = __fadd_rn(__fadd_rn(__fmul_rn(a, r2.z), __fmul_rn(b, r3.x)), __fmul_rn(c, r3.z));
          v = __fadd_rn(__fadd_rn(__fmul_rn(a, r2.w), __fmul_rn(b, r3.y)), __fmul_rn(c, r3.w));
        }
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float4* __restrict__ rec, const int4* __restrict__ rect,
              const int* __restrict__ start, const int* __restrict__ end,
              const int* __restrict__ tile_list, const int* __restrict__ bin_count,
              const int* __restrict__ bin_list, int F, int H, int W, Grid g,
              int* __restrict__ face_out, float* __restrict__ depth_out,
              float* __restrict__ bary_out, float* __restrict__ uv_out) {
  __shared__ float4 s_rec[kStage][4];
  __shared__ int s_id[kStage];
  __shared__ int s_count;

  const int b = blockIdx.z, tx = blockIdx.x, ty = blockIdx.y;
  const int x = tx * kTile + (threadIdx.x % kTile);
  const int y = ty * kTile + (threadIdx.x / kTile);
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const bool with_uv = uv_out != nullptr;
  const float4* frec = rec + static_cast<size_t>(b) * F * 4;
  const int4* frect = rect + static_cast<size_t>(b) * F;

  const size_t tile = static_cast<size_t>(b) * g.ntx * g.nty + static_cast<size_t>(ty) * g.ntx + tx;
  const int begin = start[tile], stop = end[tile];
  const int bin = b * g.nbins + (ty / g.bin_tiles) * g.nbx + tx / g.bin_tiles;
  const int n_large = bin_count[bin];
  const int* large = bin_list + static_cast<size_t>(bin) * F;

  Nearest best{CUDART_INF_F, -1, 0.f, 0.f, 0.f, 0.f, 0.f};
  // the tile's own list: every face on it reaches this tile
  for (int base = begin; base < stop; base += kStage) {
    const int n = min(kStage, stop - base);
    if (static_cast<int>(threadIdx.x) < n) {
      const int f = tile_list[base + threadIdx.x];
      s_id[threadIdx.x] = f;
      stage_record(s_rec[threadIdx.x], frec + static_cast<size_t>(f) * 4);
    }
    stage_wait();
    __syncthreads();
    best.test(s_rec, s_id, n, px, py, with_uv);
    __syncthreads();
  }
  // the coarse bin's large faces, those whose rectangle holds this tile
  for (int base = 0; base < n_large; base += kStage) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    if (base + static_cast<int>(threadIdx.x) < n_large) {
      const int f = large[base + threadIdx.x];
      const int4 t = frect[f];
      if (tx >= t.x && tx <= t.y && ty >= t.z && ty <= t.w) {
        const int slot = atomicAdd(&s_count, 1);
        s_id[slot] = f;
        stage_record(s_rec[slot], frec + static_cast<size_t>(f) * 4);
      }
    }
    stage_wait();
    __syncthreads();
    best.test(s_rec, s_id, s_count, px, py, with_uv);
    __syncthreads();
  }

  if (x < W && y < H) {
    const size_t p = (static_cast<size_t>(b) * H + y) * W + x;
    face_out[p] = best.f;
    depth_out[p] = best.z;
    if (bary_out != nullptr) {
      bary_out[p * 3 + 0] = best.w0;
      bary_out[p * 3 + 1] = best.w1;
      bary_out[p * 3 + 2] = best.w2;
    }
    if (with_uv) reinterpret_cast<float2*>(uv_out)[p] = make_float2(best.u, best.v);
  }
}

// The tile grid of an H x W frame and its coarse bins: the smallest square
// bins of which a frame has at most kMaxBins.
Grid make_grid(int H, int W) {
  Grid g;
  g.ntx = (W + kTile - 1) / kTile;
  g.nty = (H + kTile - 1) / kTile;
  int bt = 1;
  while (((g.ntx + bt - 1) / bt) * ((g.nty + bt - 1) / bt) > kMaxBins) ++bt;
  g.bin_tiles = bt;
  g.nbx = (g.ntx + bt - 1) / bt;
  g.nbins = g.nbx * ((g.nty + bt - 1) / bt);
  return g;
}

// The scratch arrays of one call, in one buffer, each at a 16-byte aligned
// byte offset; off[kArrays] is the buffer's size.  The tile counts and the
// bin counts are adjacent (one memset clears both).
enum ScratchArray { kRec, kRect, kTileCount, kBinCount, kStart, kEnd, kTileList, kBinList, kArrays };

struct ScratchLayout {
  size_t off[kArrays + 1];
};

ScratchLayout scratch_layout(int B, int F, const Grid& g) {
  const size_t bf = static_cast<size_t>(B) * F, bt = static_cast<size_t>(B) * g.ntx * g.nty;
  const size_t bins = static_cast<size_t>(B) * g.nbins;
  const size_t bytes[kArrays] = {
      bf * 64,                // rec: [B, F] 64-byte face records
      bf * 16,                // rect: [B, F] int4 tile rectangles
      bt * 4,                 // tile_count: [B, T]
      bins * 4,               // bin_count: [B, nbins]
      bt * 4,                 // start: [B, T]
      bt * 4,                 // end: [B, T]
      bf * kSmallTiles * 4,   // tile_list: [B, F * kSmallTiles] ids
      bins * F * 4,           // bin_list: [B, nbins, F] ids
  };
  ScratchLayout s;
  s.off[0] = 0;
  for (int k = 0; k < kArrays; ++k) s.off[k + 1] = (s.off[k] + bytes[k] + 15) / 16 * 16;
  return s;
}

bool valid_shape(int B, int F, int H, int W) { return B > 0 && H > 0 && W > 0 && F >= 0; }

}  // namespace

// Bytes of device scratch that raster_fwd needs for these shapes (-1 for
// shapes it does not take).  The caller allocates them, 16-byte aligned.
extern "C" long long raster_scratch_bytes(int B, int F, int H, int W) {
  if (!valid_shape(B, F, H, W)) return -1;
  return static_cast<long long>(scratch_layout(B, F, make_grid(H, W)).off[kArrays]);
}

// The worklist layout for these shapes, for tests and diagnostics:
// out[0..3] kTile, kSmallTiles, kStage, kMaxBins; out[4..8] ntx, nty,
// bin_tiles, nbx, nbins; out[9..17] the byte offsets of rec, rect,
// tile_count, bin_count, start, end, tile_list, bin_list and the scratch
// size.  Returns 0, or cudaErrorInvalidValue.
extern "C" int raster_layout(int B, int F, int H, int W, long long* out) {
  if (!valid_shape(B, F, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const Grid g = make_grid(H, W);
  const ScratchLayout s = scratch_layout(B, F, g);
  const long long head[] = {kTile, kSmallTiles, kStage, kMaxBins, g.ntx, g.nty, g.bin_tiles, g.nbx, g.nbins};
  for (int k = 0; k < 9; ++k) out[k] = head[k];
  for (int k = 0; k <= kArrays; ++k) out[9 + k] = static_cast<long long>(s.off[k]);
  return 0;
}

// pix [B, V, 2] f32, depth [B, V] f32, faces [F, 3] i64, face_uv [F, 3, 2]
// f32 (or null), scratch: raster_scratch_bytes(B, F, H, W) bytes, 16-byte
// aligned -> face [B, H, W] i32, depth [B, H, W] f32, bary [B, H, W, 3] f32
// (or null), uv [B, H, W, 2] f32 (or null).  Puts a memset of the counts and
// four kernels on ``stream``; returns the first error, or cudaGetLastError()
// after them (0 = launched).
extern "C" int raster_fwd(const void* pix, const void* depth, const void* faces, const void* face_uv,
                          int B, int V, int F, int H, int W, void* scratch, void* face, void* depth_out,
                          void* bary, void* uv, void* stream) {
  if (!valid_shape(B, F, H, W) || V < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Grid g = make_grid(H, W);
  const ScratchLayout lay = scratch_layout(B, F, g);
  char* base = static_cast<char*>(scratch);
  float4* rec = reinterpret_cast<float4*>(base + lay.off[kRec]);
  int4* rect = reinterpret_cast<int4*>(base + lay.off[kRect]);
  int* tile_count = reinterpret_cast<int*>(base + lay.off[kTileCount]);
  int* bin_count = reinterpret_cast<int*>(base + lay.off[kBinCount]);
  int* start = reinterpret_cast<int*>(base + lay.off[kStart]);
  int* end = reinterpret_cast<int*>(base + lay.off[kEnd]);
  int* tile_list = reinterpret_cast<int*>(base + lay.off[kTileList]);
  int* bin_list = reinterpret_cast<int*>(base + lay.off[kBinList]);
  const int T = g.ntx * g.nty;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(tile_count, 0, lay.off[kStart] - lay.off[kTileCount], s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(B) * F;
  const unsigned face_blocks = static_cast<unsigned>((n + 255) / 256);
  if (F > 0) {
    raster_setup_kernel<<<face_blocks, 256, 0, s>>>(
        static_cast<const float2*>(pix), static_cast<const float*>(depth),
        static_cast<const long long*>(faces), static_cast<const float*>(face_uv), B, V, F, g, rec, rect,
        tile_count, bin_count, bin_list);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  raster_scan_kernel<<<B, kScanThreads, 0, s>>>(tile_count, T, F * kSmallTiles, start, end);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (F > 0) {
    raster_fill_kernel<<<face_blocks, 256, 0, s>>>(rect, B, F, g, end, tile_list);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(g.ntx, g.nty, B);
  raster_kernel<<<grid, kThreads, 0, s>>>(rec, rect, start, end, tile_list, bin_count, bin_list, F, H, W, g,
                                          static_cast<int*>(face), static_cast<float*>(depth_out),
                                          static_cast<float*>(bary), static_cast<float*>(uv));
  return static_cast<int>(cudaGetLastError());
}
