// One-pass display finalisation of the render's 2048^2 texture, for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel audio2photoreal_tpu/ops/pallas/display_pack.py
// (finalize_display_packed -> _finalize_kernel).  For every texel of a
// [B, 3, H, W] raw texture (before x std + mean), with a [B, 1, H, W] shadow
// and a [3, H, W] per-person mean, in the order of the plain version
// (kernels/display_pack.py:finalize_display_reference, the render's composed
// chain mesh_vae.forward_tex -> color.linear2display_batch -> round, clamp):
//   t      = (tex * std + mean) * shadow               -> tex_rec
//   scaled = clamp((t * (1/255) - black) * (1/(white - black)), 0, 1)
//   srgb   = scaled <= 0.0031308 ? scaled * 12.92
//                                : 1.055 * powf(max(scaled, 1e-12), 1/2.4) - 0.055
//   q      = clamp(rint(clamp(srgb * 255, 0, 255)), 0, 255)   (half to even)
// The divisions are products with f32 reciprocals because that is how
// PyTorch divides a CUDA tensor by a Python scalar, so the kernel takes the
// plain version's rounding steps on the card; on the CPU PyTorch divides,
// which can move a value by one ulp.  Every step is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn): nvcc contracts nothing into
// an FMA, as the plain version's separate kernels cannot.
//
// Two output modes from one C entry: packed (int32 R | G<<8 | B<<16 per
// texel, what the JAX function returns) or planar (the display values 0..255
// as f32 [B, 3, H, W], what the display-space seam pass and the sampler take,
// and, when asked, tex_rec [B, 3, H, W], which render_view returns).
//
// Design.  The texture is a flat plane of n = H*W texels; every thread owns
// VEC consecutive texels (VEC = 4, 16-byte loads and stores, when n and
// every pointer allow it, else 1), reads their three mean values once and
// loops over the frame batch, so the 50 MB mean is read once per launch and
// not B times.  Any H and W are covered: a thread owns whole texels of the
// flat plane and the grid covers ceil(n / VEC) of them (the TPU kernel
// leaves the rows past the last whole block_h unwritten).
//
// What bounds it.  Bytes: per texel and frame 12 in (tex) + 4 (shadow) and,
// planar, 12 out (display) + 12 (tex_rec), or, packed, 4 out; the mean once.
// About 24 f32 operations and one powf per channel texel: at 3.35 TB/s
// against 67 TFLOP/s the kernel is bound by bytes by a wide margin.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the exponent as PyTorch passes 1.0 / 2.4 to pow: the double quotient rounded to f32
constexpr float kInvGamma = static_cast<float>(1.0 / 2.4);

struct Params {
  float std;        // texture std (scalar)
  float black;      // black point, float32(black)
  float inv_range;  // float32(1) / float32(white - black)
  int B;
  long long n;      // H * W
};

__device__ __forceinline__ float display_value(float tex, float mean, float shadow, const Params& p,
                                               float* t_out) {
  const float t = __fmul_rn(__fadd_rn(__fmul_rn(tex, p.std), mean), shadow);
  *t_out = t;
  float scaled = __fmul_rn(__fsub_rn(__fmul_rn(t, 1.0f / 255.0f), p.black), p.inv_range);
  scaled = fminf(fmaxf(scaled, 0.0f), 1.0f);
  const float lin = __fmul_rn(scaled, 12.92f);
  const float ex = __fsub_rn(__fmul_rn(1.055f, powf(fmaxf(scaled, 1e-12f), kInvGamma)), 0.055f);
  const float srgb = scaled <= 0.0031308f ? lin : ex;
  const float v = fminf(fmaxf(__fmul_rn(srgb, 255.0f), 0.0f), 255.0f);
  return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using F = float;
  using I = int;
  __device__ static float get(const F& v, int) { return v; }
  __device__ static void set(F& v, int, float x) { v = x; }
  __device__ static void seti(I& v, int, int x) { v = x; }
};
template <>
struct Vec<4> {
  using F = float4;
  using I = int4;
  __device__ static float get(const F& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }
  __device__ static void set(F& v, int i, float x) {
    if (i == 0) v.x = x; else if (i == 1) v.y = x; else if (i == 2) v.z = x; else v.w = x;
  }
  __device__ static void seti(I& v, int i, int x) {
    if (i == 0) v.x = x; else if (i == 1) v.y = x; else if (i == 2) v.z = x; else v.w = x;
  }
};

// tex [B, 3, n], shadow [B, n], mean [3, n] -> packed [B, n] int32, or
// display [B, 3, n] f32 and, when tex_rec is not null, tex_rec [B, 3, n].
// Pointers are to VEC-texel groups; n_groups = n / VEC.
template <int VEC, bool PACKED>
__global__ void __launch_bounds__(kThreads) display_pack_kernel(
    const typename Vec<VEC>::F* __restrict__ tex, const typename Vec<VEC>::F* __restrict__ shadow,
    const typename Vec<VEC>::F* __restrict__ mean, void* __restrict__ out,
    typename Vec<VEC>::F* __restrict__ tex_rec, Params p) {
  using V = Vec<VEC>;
  const long long groups = p.n / VEC;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= groups) return;
  const typename V::F m[3] = {mean[g], mean[groups + g], mean[2 * groups + g]};
  for (int b = 0; b < p.B; ++b) {
    const long long base = static_cast<long long>(b) * 3 * groups + g;
    const typename V::F sh = shadow[static_cast<long long>(b) * groups + g];
    const typename V::F tx[3] = {tex[base], tex[base + groups], tex[base + 2 * groups]};
    typename V::F q[3], tr[3];
    typename V::I packed;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      int word = 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float t;
        const float v = display_value(V::get(tx[c], i), V::get(m[c], i), V::get(sh, i), p, &t);
        V::set(q[c], i, v);
        V::set(tr[c], i, t);
        word |= static_cast<int>(v) << (8 * c);
      }
      V::seti(packed, i, word);
    }
    if (PACKED) {
      static_cast<typename V::I*>(out)[static_cast<long long>(b) * groups + g] = packed;
    } else {
      typename V::F* disp = static_cast<typename V::F*>(out);
#pragma unroll
      for (int c = 0; c < 3; ++c) disp[base + c * groups] = q[c];
      if (tex_rec != nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) tex_rec[base + c * groups] = tr[c];
      }
    }
  }
}

template <int VEC, bool PACKED>
int launch(const void* tex, const void* shadow, const void* mean, void* out, void* tex_rec, const Params& p,
           cudaStream_t s) {
  using F = typename Vec<VEC>::F;
  const long long groups = p.n / VEC;
  const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  display_pack_kernel<VEC, PACKED><<<blocks, kThreads, 0, s>>>(
      static_cast<const F*>(tex), static_cast<const F*>(shadow), static_cast<const F*>(mean), out,
      static_cast<F*>(tex_rec), p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return ptr == nullptr || (reinterpret_cast<unsigned long long>(ptr) & 15) == 0; }

}  // namespace

// tex [B, 3, H, W] f32, shadow [B, 1, H, W] f32, mean [3, H, W] f32, all
// contiguous, n = H * W.  packed != 0: out is int32 [B, H, W] and tex_rec
// must be null; packed == 0: out is f32 [B, 3, H, W] display values and
// tex_rec is f32 [B, 3, H, W] or null.  black = float32(black), inv_range =
// float32(1) / float32(white - black).  Launches one kernel on ``stream``
// and returns cudaGetLastError() after it (0 = launched).
extern "C" int display_pack(const void* tex, const void* shadow, const void* mean, void* out, void* tex_rec,
                            int B, long long n, float std, float black, float inv_range, int packed,
                            void* stream) {
  if (B <= 0 || n <= 0 || out == nullptr || (packed && tex_rec != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{std, black, inv_range, B, n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = n % 4 == 0 && aligned16(tex) && aligned16(shadow) && aligned16(mean) && aligned16(out) &&
                    aligned16(tex_rec);
  if (packed) {
    return vec4 ? launch<4, true>(tex, shadow, mean, out, nullptr, p, s)
                : launch<1, true>(tex, shadow, mean, out, nullptr, p, s);
  }
  return vec4 ? launch<4, false>(tex, shadow, mean, out, tex_rec, p, s)
              : launch<1, false>(tex, shadow, mean, out, tex_rec, p, s);
}
