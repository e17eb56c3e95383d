// One-pass display finalisation of the render's 2048^2 texture, for Hopper
// (sm_90a), bound with ctypes; one instantiation for an f32 texture and one
// for a bf16 texture (the renderer's bf16 compute mode).
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
// The bf16 instantiation reads tex and shadow in bf16 and writes tex_rec in
// bf16.  t is the texture chain of the JAX package's bf16 render
// (mesh_vae.py:forward_tex, its casts as written, each op rounded as XLA
// rounds with excess precision off and as eager PyTorch rounds): std and the
// mean rounded to bf16, each of the three ops computed in f32 and rounded to
// bf16 (after x std, after + mean, after x shadow).  The display chain then
// runs in f32 on float(t), exactly as in the f32 instantiation
// (mesh_vae.py:513, linear2display_batch(tex_rec.astype(f32))).
//
// Two output modes from one C entry each: packed (int32 R | G<<8 | B<<16 per
// texel, what the JAX function returns) or planar (the display values 0..255
// as f32 [B, 3, H, W], what the display-space seam pass and the sampler take,
// and, when asked, tex_rec [B, 3, H, W] in the texture's type, which
// render_view returns).
//
// Design.  The texture is a flat plane of n = H*W texels; every thread owns
// VEC consecutive texels (VEC = 4, one vector load or store a tensor: 16
// bytes of f32, 8 of bf16, when n and every pointer allow it, else 1), reads
// their three mean values once and loops over the frame batch, so the 50 MB
// mean is read once per launch and not B times.  Any H and W are covered: a
// thread owns whole texels of the flat plane and the grid covers
// ceil(n / VEC) of them (the TPU kernel leaves the rows past the last whole
// block_h unwritten).
//
// What bounds it.  Bytes: per texel and frame, f32: 12 in (tex) + 4
// (shadow) and, planar, 12 out (display) + 12 (tex_rec), or, packed, 4 out;
// bf16: 6 in (tex) + 2 (shadow) = 8 read instead of 16, and, planar, 12 out
// (display) + 6 (tex_rec); the f32 mean once.  At the render's B8 3 x 2048^2
// planar with tex_rec that is 1.39 GB (f32) or 0.92 GB (bf16): 0.416 or
// 0.275 ms at 3.35 TB/s.  About 24 f32 operations and one powf per channel
// texel (the bf16 chain adds four roundings): against 67 TFLOP/s the kernel
// is bound by bytes by a wide margin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
// the exponent as PyTorch passes 1.0 / 2.4 to pow: the double quotient rounded to f32
constexpr float kInvGamma = static_cast<float>(1.0 / 2.4);

struct Params {
  float std;        // texture std (scalar), already in the texture's type
  float black;      // black point, float32(black)
  float inv_range;  // float32(1) / float32(white - black)
  int B;
  long long n;      // H * W
};

// The texture's type: its loads as f32 and the rounding of the texture
// chain's steps to it (the identity for f32).
template <typename T>
struct Carrier;
template <>
struct Carrier<float> {
  __device__ static float load(float x) { return x; }
  __device__ static float round(float x) { return x; }
  __device__ static float store(float x) { return x; }
};
template <>
struct Carrier<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

// VEC consecutive elements, loaded and stored as one vector
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T>
__device__ __forceinline__ float display_value(float tex, float mean, float shadow, const Params& p,
                                               float* t_out) {
  using C = Carrier<T>;
  const float t = C::round(__fmul_rn(C::round(__fadd_rn(C::round(__fmul_rn(tex, p.std)), C::round(mean))),
                                     shadow));
  *t_out = t;
  float scaled = __fmul_rn(__fsub_rn(__fmul_rn(t, 1.0f / 255.0f), p.black), p.inv_range);
  scaled = fminf(fmaxf(scaled, 0.0f), 1.0f);
  const float lin = __fmul_rn(scaled, 12.92f);
  const float ex = __fsub_rn(__fmul_rn(1.055f, powf(fmaxf(scaled, 1e-12f), kInvGamma)), 0.055f);
  const float srgb = scaled <= 0.0031308f ? lin : ex;
  const float v = fminf(fmaxf(__fmul_rn(srgb, 255.0f), 0.0f), 255.0f);
  return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

// tex [B, 3, n], shadow [B, n] (T), mean [3, n] (f32) -> packed [B, n] int32,
// or display [B, 3, n] f32 and, when tex_rec is not null, tex_rec [B, 3, n]
// (T).  Pointers are to VEC-texel groups; groups = n / VEC.
template <typename T, int VEC, bool PACKED>
__global__ void __launch_bounds__(kThreads) display_pack_kernel(
    const Pack<T, VEC>* __restrict__ tex, const Pack<T, VEC>* __restrict__ shadow,
    const Pack<float, VEC>* __restrict__ mean, void* __restrict__ out, Pack<T, VEC>* __restrict__ tex_rec,
    Params p) {
  using C = Carrier<T>;
  const long long groups = p.n / VEC;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= groups) return;
  const Pack<float, VEC> m[3] = {mean[g], mean[groups + g], mean[2 * groups + g]};
  for (int b = 0; b < p.B; ++b) {
    const long long base = static_cast<long long>(b) * 3 * groups + g;
    const Pack<T, VEC> sh = shadow[static_cast<long long>(b) * groups + g];
    const Pack<T, VEC> tx[3] = {tex[base], tex[base + groups], tex[base + 2 * groups]};
    Pack<float, VEC> q[3];
    Pack<T, VEC> tr[3];
    Pack<int, VEC> packed;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      int word = 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float t;
        const float v = display_value<T>(C::load(tx[c].v[i]), m[c].v[i], C::load(sh.v[i]), p, &t);
        q[c].v[i] = v;
        tr[c].v[i] = C::store(t);
        word |= static_cast<int>(v) << (8 * c);
      }
      packed.v[i] = word;
    }
    if (PACKED) {
      static_cast<Pack<int, VEC>*>(out)[static_cast<long long>(b) * groups + g] = packed;
    } else {
      Pack<float, VEC>* disp = static_cast<Pack<float, VEC>*>(out);
#pragma unroll
      for (int c = 0; c < 3; ++c) disp[base + c * groups] = q[c];
      if (tex_rec != nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) tex_rec[base + c * groups] = tr[c];
      }
    }
  }
}

template <typename T, int VEC, bool PACKED>
int launch(const void* tex, const void* shadow, const void* mean, void* out, void* tex_rec, const Params& p,
           cudaStream_t s) {
  const long long groups = p.n / VEC;
  const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  display_pack_kernel<T, VEC, PACKED><<<blocks, kThreads, 0, s>>>(
      static_cast<const Pack<T, VEC>*>(tex), static_cast<const Pack<T, VEC>*>(shadow),
      static_cast<const Pack<float, VEC>*>(mean), out, static_cast<Pack<T, VEC>*>(tex_rec), p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, unsigned long long bytes) {
  return ptr == nullptr || (reinterpret_cast<unsigned long long>(ptr) % bytes) == 0;
}

template <typename T>
int display_pack_impl(const void* tex, const void* shadow, const void* mean, void* out, void* tex_rec, int B,
                      long long n, float std, float black, float inv_range, int packed, void* stream) {
  if (B <= 0 || n <= 0 || out == nullptr || (packed && tex_rec != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{std, black, inv_range, B, n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr unsigned long long kIn = sizeof(T) * kVec, kF32 = sizeof(float) * kVec;
  const bool vec = n % kVec == 0 && aligned(tex, kIn) && aligned(shadow, kIn) && aligned(mean, kF32) &&
                   aligned(out, kF32) && aligned(tex_rec, kIn);
  if (packed) {
    return vec ? launch<T, kVec, true>(tex, shadow, mean, out, nullptr, p, s)
               : launch<T, 1, true>(tex, shadow, mean, out, nullptr, p, s);
  }
  return vec ? launch<T, kVec, false>(tex, shadow, mean, out, tex_rec, p, s)
             : launch<T, 1, false>(tex, shadow, mean, out, tex_rec, p, s);
}

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
  return display_pack_impl<float>(tex, shadow, mean, out, tex_rec, B, n, std, black, inv_range, packed, stream);
}

// The same with tex, shadow and tex_rec in bf16 (mean f32, out as above) and
// std already rounded to bf16.
extern "C" int display_pack_bf16(const void* tex, const void* shadow, const void* mean, void* out,
                                 void* tex_rec, int B, long long n, float std, float black, float inv_range,
                                 int packed, void* stream) {
  return display_pack_impl<__nv_bfloat16>(tex, shadow, mean, out, tex_rec, B, n, std, black, inv_range, packed,
                                          stream);
}
