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
// bf16 runs on bf16 pairs (mul/sub/add.rn.bf16x2 give the float32
// operation's value rounded to bf16, ecs_lif_common.cuh), without the
// float-to-bf16 conversions.
//
// Design.  The site is a flat plane of M = N*H*W*C elements per step.  A
// thread owns one 16-byte vector of it (8 bf16 / 4 f32 elements), keeps its
// mem and spike in registers over the T steps, and issues the loads of up
// to four planes of x before the first of their spikes is stored (all of
// them at T <= 4), so that no load waits behind a store; where x is a
// broadcast over T (x_tstride 0) it loads one plane.  One block per 256
// vectors, every block of the plane in one launch: a thread owning several
// vectors, or a grid of one to four waves walking the plane, read slower at
// every site shape in a trial build.  Spikes are stored with the default
// cache policy, as the next layer reads them (evict-first stores timed the
// same within the spread at every site shape, kernel alone, in a trial
// build).  The TPU
// kernel pads the plane to 32k-element blocks with a copy; here a plane
// whose size or address does not allow 16-byte accesses takes the scalar
// variant of the same arithmetic, so nothing is copied.
//
// What bounds it.  Bytes: T*M elements read (M when x is a broadcast) and
// T*M written; five operations an element and step.  There is no reuse, so
// the design only has to keep enough 16-byte accesses in flight.  At the
// model's small sites the launch itself (a few microseconds) is most of the
// time; the wrapper (snn/fused.py:lif_fused) passes one argument block to a
// function bound once.

#include "ecs_lif_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 4;   // planes of x loaded before their spikes are stored

struct Params {
  const void* x;          // Tn planes of M elements, x_ts elements apart (0: a broadcast)
  long long x_ts;
  void* out;              // [Tn][M]
  long long M;
  int Tn, act;
  float thresh, decay;    // decay rounded to the dtype by the caller
};

// one step of one element; mem and spk are carried in registers
template <typename T>
__device__ __forceinline__ void step(float& mem, float& spk, float x, const Params& p) {
  const float gate = sub<T>(1.0f, spk);
  mem = add<T>(mul<T>(mul<T>(mem, p.decay), gate), x);
  spk = fire<T>(mem, p.thresh, p.act);
}

// one step of a 32-bit word: a bf16 pair, or one f32 element
__device__ __forceinline__ void step_word(uint32_t& m, uint32_t& s, uint32_t x, const Params& p,
                                          bf16) {
  const uint32_t gate = hsub2(0x3F803F80u, s);
  m = hadd2(hmul2(hmul2(m, pack_bf16x2(p.decay, p.decay)), gate), x);
  const float m0 = lo_f(m), m1 = hi_f(m);
  if (p.act)
    s = pack_bf16x2(__fdiv_rn(m0, __fadd_rn(1.0f, expf(-m0))),
                    __fdiv_rn(m1, __fadd_rn(1.0f, expf(-m1))));
  else
    s = (m0 > p.thresh ? 0x3F80u : 0u) | (m1 > p.thresh ? 0x3F800000u : 0u);
}
__device__ __forceinline__ void step_word(uint32_t& m, uint32_t& s, uint32_t x, const Params& p,
                                          float) {
  float mv = __uint_as_float(m), sv = __uint_as_float(s);
  step<float>(mv, sv, __uint_as_float(x), p);
  m = __float_as_uint(mv);
  s = __float_as_uint(sv);
}

// one step of a 16-byte vector: four words
template <typename T>
__device__ __forceinline__ void step_vec(uint4& m, uint4& s, const uint4& x, const Params& p) {
  step_word(m.x, s.x, x.x, p, T{});
  step_word(m.y, s.y, x.y, p, T{});
  step_word(m.z, s.z, x.z, p, T{});
  step_word(m.w, s.w, x.w, p, T{});
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lif_fused_vec_kernel(const __grid_constant__ Params p) {
  constexpr int E = 16 / sizeof(T);
  const long long nv = p.M / E;                          // 16-byte vectors a plane
  const uint4* x = static_cast<const uint4*>(p.x);
  uint4* out = static_cast<uint4*>(p.out);
  const long long xs = p.x_ts / E;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < nv;
       v += (long long)gridDim.x * kThreads) {
    uint4 mem = make_uint4(0u, 0u, 0u, 0u), spk = mem;
    for (int t0 = 0; t0 < p.Tn; t0 += kSteps) {
      // the loads of up to four steps first; a broadcast reuses its one plane
      const uint4* xp = x + t0 * xs + v;
      const uint4 x0 = __ldg(xp);
      const uint4 x1 = t0 + 1 < p.Tn && xs != 0 ? __ldg(xp + xs) : x0;
      const uint4 x2 = t0 + 2 < p.Tn && xs != 0 ? __ldg(xp + 2 * xs) : x0;
      const uint4 x3 = t0 + 3 < p.Tn && xs != 0 ? __ldg(xp + 3 * xs) : x0;
      uint4* op = out + t0 * nv + v;
      step_vec<T>(mem, spk, x0, p);
      op[0] = spk;
      if (t0 + 1 < p.Tn) { step_vec<T>(mem, spk, x1, p); op[nv] = spk; }
      if (t0 + 2 < p.Tn) { step_vec<T>(mem, spk, x2, p); op[2 * nv] = spk; }
      if (t0 + 3 < p.Tn) { step_vec<T>(mem, spk, x3, p); op[3 * nv] = spk; }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lif_fused_scalar_kernel(const __grid_constant__ Params p) {
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < p.M;
       e += (long long)gridDim.x * kThreads) {
    float mem = 0.0f, spk = 0.0f;
    for (int t = 0; t < p.Tn; ++t) {
      step<T>(mem, spk, ld1<kNc>(x + t * p.x_ts + e), p);
      st1(out + t * p.M + e, spk);
    }
  }
}

// one block a kThreads units of work, no more than the grid's x extent (the
// kernels walk the rest in strides of the grid)
inline unsigned blocks(long long units) {
  const long long b = (units + kThreads - 1) / kThreads;
  return (unsigned)(b < 0x7fffffffLL ? b : 0x7fffffffLL);
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = p.M % E == 0 && p.x_ts % E == 0 &&
                   reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  if (vec)
    lif_fused_vec_kernel<T><<<blocks(p.M / E), kThreads, 0, st>>>(p);
  else
    lif_fused_scalar_kernel<T><<<blocks(p.M), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: 8 int64 values (snn/fused.py:lif_fused): dtype (0 = float32,
// 1 = bfloat16), x, x's T stride in elements (0: one plane broadcast over
// T), out ([Tn, M] contiguous), M, Tn, act, stream.  k: thresh, decay
// (rounded to the dtype by the caller).  Returns the launch's cudaError_t
// (0 = launched).
int lif_fused_fwd(const long long* a, const float* k) {
  Params p;
  const int dtype = (int)a[0];
  p.x = reinterpret_cast<const void*>(a[1]);
  p.x_ts = a[2];
  p.out = reinterpret_cast<void*>(a[3]);
  p.M = a[4];
  p.Tn = (int)a[5];
  p.act = (int)a[6];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a[7]);
  p.thresh = k[0];
  p.decay = k[1];
  if (p.M < 0 || p.Tn < 0 || p.x_ts < 0) return (int)cudaErrorInvalidValue;
  if (p.M == 0 || p.Tn == 0) return (int)cudaSuccess;
  if (dtype == 0) return (int)launch<float>(p, st);
  if (dtype == 1) return (int)launch<bf16>(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* lif_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
