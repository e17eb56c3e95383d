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
// Design.  Two kernels on the caller's stream, one C call.  A setup kernel,
// one thread per (frame, face), gathers the face's corners and computes its
// edge terms, 1/det and screen bbox in the plain version's rounding steps
// into a 64-byte record (the TPU kernel does this per face in its body,
// pallas_raster.py:186-197).  The raster kernel runs one block of 256
// threads per 16x16 tile of one frame, one thread per pixel; ragged H and W
// are masked at the store.  The faces are swept in chunks of 256: each
// thread reads one face's bbox (16 bytes), and the faces whose bbox touches
// the tile (one pixel of margin) are appended to a shared-memory list (their
// records, staged once per block).  Every pixel then tests the listed faces
// against a running (z, face id) kept in registers, with one store per
// output plane at the end.  Faces that can never pass (|det| <= 1e-12, a
// non-finite corner, or a corner index outside [0, V)) get an empty bbox.
// The TPU kernel's Morton sort, VMEM budget clamp and 8-row worklist padding
// are TPU constraints and are not carried over: the (z, id) compare makes
// the result independent of the order in which faces are listed.
//
// What bounds it.  Each listed (pixel, face) test costs 17 f32 arithmetic
// operations (9 mul, 8 add/sub, none fusable) and 4 compares; a face record
// is read from shared memory as a broadcast.  The bbox sweep reads F x 16
// bytes per block through L2.  Output: 4 + 4 + 8 (uv) or 12 (barys) bytes
// per pixel.  At the render's shapes (1024x667, 9,322 faces) the bbox sweep
// and the listed tests dominate; the setup kernel is B x F threads.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 16;             // tile is kTile x kTile pixels
constexpr int kThreads = kTile * kTile;
constexpr int kChunk = kThreads;      // faces swept per pass, one per thread

// Face record, 16 floats (written by raster_setup_kernel):
//   0 xc  1 yc  2 A0=yb-yc  3 B0=xc-xb  4 A1=yc-ya  5 B1=xa-xc  6 inv_det
//   7 za  8 zb  9 zc  10 ua 11 va 12 ub 13 vb 14 uc 15 vc
// bbox: x_min, x_max, y_min, y_max (empty: +inf, -inf, +inf, -inf).
__global__ void raster_setup_kernel(const float2* __restrict__ pix, const float* __restrict__ depth,
                                    const long long* __restrict__ faces, const float* __restrict__ face_uv,
                                    int B, int V, int F, float4* __restrict__ rec,
                                    float4* __restrict__ bbox) {
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
  bbox[i] = live ? make_float4(fminf(fminf(pa.x, pb.x), pc.x), fmaxf(fmaxf(pa.x, pb.x), pc.x),
                               fminf(fminf(pa.y, pb.y), pc.y), fmaxf(fmaxf(pa.y, pb.y), pc.y))
                 : make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float4* __restrict__ rec, const float4* __restrict__ bbox,
              int F, int H, int W,
              int* __restrict__ face_out, float* __restrict__ depth_out,
              float* __restrict__ bary_out, float* __restrict__ uv_out) {
  __shared__ float4 s_rec[kChunk][4];
  __shared__ int s_id[kChunk];
  __shared__ int s_count;

  const int b = blockIdx.z;
  const int x = blockIdx.x * kTile + (threadIdx.x % kTile);
  const int y = blockIdx.y * kTile + (threadIdx.x / kTile);
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  // the tile's pixel centres, widened by one pixel
  const float tx0 = static_cast<float>(blockIdx.x * kTile) - 1.0f;
  const float tx1 = static_cast<float>(blockIdx.x * kTile + kTile - 1) + 1.0f;
  const float ty0 = static_cast<float>(blockIdx.y * kTile) - 1.0f;
  const float ty1 = static_cast<float>(blockIdx.y * kTile + kTile - 1) + 1.0f;

  const float4* frec = rec + static_cast<size_t>(b) * F * 4;
  const float4* fbox = bbox + static_cast<size_t>(b) * F;

  float best_z = CUDART_INF_F;
  int best_f = -1;
  float bw0 = 0.f, bw1 = 0.f, bw2 = 0.f, bu = 0.f, bv = 0.f;

  for (int base = 0; base < F; base += kChunk) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    const int f = base + threadIdx.x;
    if (f < F) {
      const float4 bx = fbox[f];  // x_min, x_max, y_min, y_max
      if (bx.x <= tx1 && bx.y >= tx0 && bx.z <= ty1 && bx.w >= ty0) {
        const int slot = atomicAdd(&s_count, 1);
        s_id[slot] = f;
#pragma unroll
        for (int k = 0; k < 4; ++k) s_rec[slot][k] = frec[static_cast<size_t>(f) * 4 + k];
      }
    }
    __syncthreads();
    const int n = s_count;
    for (int i = 0; i < n; ++i) {
      const float4 r0 = s_rec[i][0];  // xc yc A0 B0
      const float4 r1 = s_rec[i][1];  // A1 B1 inv_det za
      const float4 r2 = s_rec[i][2];  // zb zc ua va
      const float dx = __fsub_rn(px, r0.x);
      const float dy = __fsub_rn(py, r0.y);
      const float w0 = __fmul_rn(__fadd_rn(__fmul_rn(r0.z, dx), __fmul_rn(r0.w, dy)), r1.z);
      const float w1 = __fmul_rn(__fadd_rn(__fmul_rn(r1.x, dx), __fmul_rn(r1.y, dy)), r1.z);
      const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(w0, r1.w), __fmul_rn(w1, r2.x)),
                                __fmul_rn(w2, r2.y));
      if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f && z > 1e-6f) {
        const int id = s_id[i];
        if (z < best_z || (z == best_z && id < best_f)) {
          best_z = z;
          best_f = id;
          bw0 = w0;
          bw1 = w1;
          bw2 = w2;
          if (uv_out != nullptr) {
            const float4 r3 = s_rec[i][3];  // ub vb uc vc
            bu = __fadd_rn(__fadd_rn(__fmul_rn(w0, r2.z), __fmul_rn(w1, r3.x)), __fmul_rn(w2, r3.z));
            bv = __fadd_rn(__fadd_rn(__fmul_rn(w0, r2.w), __fmul_rn(w1, r3.y)), __fmul_rn(w2, r3.w));
          }
        }
      }
    }
    __syncthreads();
  }

  if (x < W && y < H) {
    const size_t p = (static_cast<size_t>(b) * H + y) * W + x;
    face_out[p] = best_f;
    depth_out[p] = best_z;
    if (bary_out != nullptr) {
      bary_out[p * 3 + 0] = bw0;
      bary_out[p * 3 + 1] = bw1;
      bary_out[p * 3 + 2] = bw2;
    }
    if (uv_out != nullptr) {
      uv_out[p * 2 + 0] = bu;
      uv_out[p * 2 + 1] = bv;
    }
  }
}

}  // namespace

// pix [B, V, 2] f32, depth [B, V] f32, faces [F, 3] i64, face_uv [F, 3, 2]
// f32 (or null); scratch rec [B, F, 16] f32 and bbox [B, F, 4] f32 -> face
// [B, H, W] i32, depth [B, H, W] f32, bary [B, H, W, 3] f32 (or null), uv
// [B, H, W, 2] f32 (or null).  Launches both kernels on ``stream``; returns
// cudaGetLastError() after them (0 = launched).
extern "C" int raster_fwd(const void* pix, const void* depth, const void* faces, const void* face_uv,
                          int B, int V, int F, int H, int W, void* rec, void* bbox,
                          void* face, void* depth_out, void* bary, void* uv, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || F < 0 || V < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F > 0) {
    const long long n = static_cast<long long>(B) * F;
    raster_setup_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        static_cast<const float2*>(pix), static_cast<const float*>(depth),
        static_cast<const long long*>(faces), static_cast<const float*>(face_uv), B, V, F,
        static_cast<float4*>(rec), static_cast<float4*>(bbox));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  raster_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float4*>(rec), static_cast<const float4*>(bbox), F, H, W,
      static_cast<int*>(face), static_cast<float*>(depth_out), static_cast<float*>(bary),
      static_cast<float*>(uv));
  return static_cast<int>(cudaGetLastError());
}
