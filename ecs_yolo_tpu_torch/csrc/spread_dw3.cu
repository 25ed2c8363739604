// Binary depthwise 3x3 SAME convolution plus bias for Hopper (sm_90a).
//
// Replaces ecs_yolo_tpu/snn/pallas_dw.py:binary_dw3_conv (the TPU kernel
// `_dw3_kernel`): the spike plane s [N, H, W, C] holds 0 or 1 and is read as
// int8; per output element the sum starts from the bias in f32, adds the up
// to nine taps k[dy, dx, c] whose neighbour spiked (zero outside the image),
// and is rounded once to the output dtype.
//
// What bounds it: bytes.  It reads one byte and writes one element per
// position and does 18 operations for them, far below the card's ratio of
// operations to bytes.  The TPU kernel holds one whole image per grid step;
// an SM cannot, and needs not: there is no reuse beyond the 3x3 window, which
// L1/L2 serve.
//
// Design: one thread per 8 consecutive channels of one pixel (C % 8 == 0, so
// a group never straddles pixels): 8-byte spike loads, 16- or 32-byte weight
// and output accesses, neighbouring threads on neighbouring addresses.  The
// weights (9 * C elements) stay in L1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  #pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// k is [9, C] (the [3, 3, 1, C] kernel, contiguous), b is [C]
template <typename T>
__global__ void __launch_bounds__(kThreads)
spread_dw3_kernel(const int8_t* __restrict__ s, const T* __restrict__ k,
                  const T* __restrict__ b, T* __restrict__ out,
                  long long groups, int H, int W, int C) {
  const int gpp = C / 8;  // channel groups per pixel
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kThreads) {
    const int c = (int)(g % gpp) * 8;
    const long long pix = g / gpp;
    const int w = (int)(pix % W);
    const int h = (int)((pix / W) % H);
    float acc[8];
    load8(b + c, acc);
    #pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int hh = h + dy - 1;
      if (hh < 0 || hh >= H) continue;
      #pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ww = w + dx - 1;
        if (ww < 0 || ww >= W) continue;
        const long long src = pix + (long long)(dy - 1) * W + (dx - 1);
        const uint2 raw = *reinterpret_cast<const uint2*>(s + src * C + c);
        const int8_t* sv = reinterpret_cast<const int8_t*>(&raw);
        float kw[8];
        load8(k + (dy * 3 + dx) * C + c, kw);
        #pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf((float)sv[i], kw[i], acc[i]);
      }
    }
    store8(out + pix * C + c, acc);
  }
}

template <typename T>
cudaError_t launch(const void* s, const void* k, const void* b, void* out, int N,
                   int H, int W, int C, cudaStream_t stream) {
  const long long groups = (long long)N * H * W * (C / 8);
  if (groups == 0) return cudaSuccess;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  spread_dw3_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(s), static_cast<const T*>(k),
      static_cast<const T*>(b), static_cast<T*>(out), groups, H, W, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of k, b and out).  s is int8 [N, H, W, C],
// contiguous, 16-byte aligned; C % 8 == 0.  Returns the launch's cudaError_t.
int spread_dw3_fwd(int dtype, const void* s, const void* k, const void* b, void* out,
                   int N, int H, int W, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(s, k, b, out, N, H, W, C, st);
  if (dtype == 1) return (int)launch<bf16>(s, k, b, out, N, H, W, C, st);
  return (int)cudaErrorInvalidValue;
}

const char* spread_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
