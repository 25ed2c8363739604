// Fused plain-LIF forward for Hopper (sm_90a): the whole T-step recurrence
// of one neuron site in one launch.
//
// Replaces ecs_yolo_tpu/snn/pallas_kernels.py:lif_fused (the TPU kernel
// `_lif_kernel`).  Same recurrence, step for step, in the input dtype:
//   mem   = mem * decay * (1 - spike_prev) + x_t
//   spike = (float(mem) > thresh)            (SiLU when act)
// Each operation rounds to the storage dtype and nothing is contracted into
// an FMA, as PyTorch's elementwise kernels and the plain loop
// (snn/neuron.py:lif_scan) do: mem*decay, 1-spike, their product, + x_t.
//
// Design.  The site is a flat plane of M = N*H*W*C elements per step.  One
// thread owns 16 bytes of consecutive elements (8 bf16 / 4 f32), keeps their
// mem and spike in registers over the T steps, reads x[t] once and writes
// out[t] once.  The TPU kernel pads the plane to 32k-element blocks with a
// copy; here a plane whose size or address does not allow 16-byte accesses
// takes the scalar variant of the same kernel, so nothing is copied.  x's T
// axis may be a broadcast (x_tstride 0).
//
// What bounds it.  Bytes: T*M elements read (M when x is a broadcast) and
// T*M written; five operations an element and step.  There is no reuse, so
// the design only has to keep enough 16-byte accesses in flight.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<bf16> { static constexpr int n = 8; };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// VEC consecutive elements through one 16-byte access
__device__ __forceinline__ void ldv(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void ldv(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void stv(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void stv(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  #pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// round a float to the storage dtype and back
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one step of one element; mem and spk are carried in registers
template <typename T>
__device__ __forceinline__ void step(float& mem, float& spk, float x, float decay,
                                     float thresh, int act) {
  const float gate = rnd<T>(__fsub_rn(1.0f, spk));
  const float m = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(mem, decay)), gate));
  mem = rnd<T>(__fadd_rn(m, x));
  spk = act ? rnd<T>(__fdiv_rn(mem, __fadd_rn(1.0f, expf(-mem))))
            : (mem > thresh ? 1.0f : 0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lif_fused_vec_kernel(const T* __restrict__ x, long long x_tstride, T* __restrict__ out,
                     long long M, int Tn, float thresh, float decay, int act) {
  constexpr int V = Vec<T>::n;
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e >= M) return;
  float mem[V] = {}, spk[V] = {};
  for (int t = 0; t < Tn; ++t) {
    float xv[V];
    ldv(x + t * x_tstride + e, xv);
    #pragma unroll
    for (int i = 0; i < V; ++i) step<T>(mem[i], spk[i], xv[i], decay, thresh, act);
    stv(out + t * M + e, spk);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lif_fused_scalar_kernel(const T* __restrict__ x, long long x_tstride, T* __restrict__ out,
                        long long M, int Tn, float thresh, float decay, int act) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= M) return;
  float mem = 0.0f, spk = 0.0f;
  for (int t = 0; t < Tn; ++t) {
    step<T>(mem, spk, ld(x + t * x_tstride + e), decay, thresh, act);
    st(out + t * M + e, spk);
  }
}

template <typename T>
cudaError_t launch(const void* x, long long x_tstride, void* out, long long M, int Tn,
                   float thresh, float decay, int act, cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (M <= 0 || Tn <= 0) return cudaSuccess;
  const bool vec = M % V == 0 && x_tstride % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const long long blocks = (M / V + kThreads - 1) / kThreads;
    lif_fused_vec_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, x_tstride, op, M, Tn, thresh, decay, act);
  } else {
    const long long blocks = (M + kThreads - 1) / kThreads;
    lif_fused_scalar_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, x_tstride, op, M, Tn, thresh, decay, act);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x holds Tn planes of M elements,
// x_tstride elements apart (0 = one plane broadcast over T); out is
// [Tn, M] contiguous.  M <= (2^31 - 1) * 256 (the wrapper checks).  decay is
// already rounded to the dtype by the caller.  Returns the cudaError_t of the
// launch (0 = launched).
int lif_fused_fwd(int dtype, const void* x, long long x_tstride, void* out,
                  long long M, int Tn, float thresh, float decay, int act,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, x_tstride, out, M, Tn, thresh, decay, act, s);
  if (dtype == 1) return (int)launch<bf16>(x, x_tstride, out, M, Tn, thresh, decay, act, s);
  return (int)cudaErrorInvalidValue;
}

const char* lif_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
