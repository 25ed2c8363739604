// Fused ECS-LIF forward for Hopper (sm_90a) with the recurrence's state held
// in shared memory: the whole T-step recurrence of one site in one launch,
// for any H, W, C and any strides of x.
//
// Replaces ecs_yolo_tpu/snn/pallas_kernels.py:ecs_lif_fused_v2 (the TPU
// kernel `_ecs_kernel_v2`), which is `_ecs_kernel`'s arithmetic with its
// state in on-chip scratch.  Step for step, in the input dtype:
//   fecs  = beta * tanh(ecs)
//   mem   = mem * decay * (1 - spike_prev) + x_t + fecs
//   spike = (float(mem) > thresh)            (SiLU when act)
//   d     = 0; for dy, dx in row-major order: d += spike[r+dy, w+dx] * dw[dy, dx]
//           (product and sum each rounded to the dtype), then d += dwb
//   p     = round(sum over ci of d[ci] * pw[ci, co]) + pwb
//   ecs   = alpha * p + (1 - 1/tau) * ecs
// Every elementwise operation rounds to the storage dtype and nothing of it
// is contracted into an FMA, as in csrc/ecs_lif_rows.cu, whose plain version
// (snn/fused.py:ecs_lif_rows_reference) is this kernel's too.  The 1x1 sum is
// where the two differ, by choice: this kernel runs it as csrc/ecs_lif.cu
// does, on the tensor cores for bf16 (mma.sync m16n8k16, f32 accumulation)
// and as an f32 FMA chain in channel order for float32, so its gates against
// the plain version are K1's (a spike-mismatch share), not exactness.  The
// product's order over the channels never depends on the tiling, so the
// result is the same, bit for bit, for every tiling.  The update of ecs after
// the last step, which nobody observes, is skipped.
//
// Design.  One block per (tile, channel slice), with the slices of a tile in
// one thread-block cluster.  A tile of `br` x `bc` output pixels is computed
// on its window, grown by halo = T-1 pixels on all four sides and clipped to
// the image: the 3x3 widens the receptive field one pixel per step, so after
// T steps the interior is exact.  Out-of-image pixels are absent from the
// window, which is SAME zero padding.  The state of the window never leaves
// the block's shared memory during the T steps: mem, ecs and the depthwise
// sum d, three planes of `pitch` elements a pixel; the spike of a step is a
// function of its mem and is not stored.  x is read once per step from
// device memory, and each interior spike is written once.
//   Where one block cannot hold a useful window of all C channels, the
// cluster's `cs` blocks split C: each owns `cl` channels of the same tile.
// The depthwise sum is per channel and stays local; the 1x1 mixes all
// channels, so each step a block reads its peers' d planes through
// distributed shared memory (cluster.map_shared_rank).  Per step:
//   (1) d of the block's channels over the window, one element a thread;
//       cluster barrier (every d of the tile is complete);
//   (2) p = d @ pw for the block's output channels over all C inputs, whose
//       epilogue finishes the ecs update and the next step's membrane and
//       spike for the same element, in place; cluster barrier (no peer still
//       reads this block's d when the next step overwrites it, and no block
//       exits while a peer reads it).
// The wrapper pads pw to [cs*cl, cs*cl] with zeros and the kernel keeps d of
// padded channels at zero, so a C that is no multiple of 16 adds only zero
// products.
//
// What bounds it.  The function moves 2 * T*N*H*W*C elements and does
// (T-1)*N*H*W*(2*C*C + 18*C) operations: bytes up to C ~ 128 in bf16, the
// product beyond.  This first version pays, beyond that: the halo recompute
// of its windows (smaller than K1's and K2's, whose tiles span the full
// width), one block an SM (the planes take most of the 227 KB) whose
// threads wait on dependent chains, the A operand loaded through generic
// addresses with no ldmatrix, the B operand streamed from L2 for every
// 16-row tile, and scalar, strided x reads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// threads a block: the planes leave room for one block an SM, and its
// recurrence is a chain of dependent, rounded operations, so latency is
// hidden by threads alone (the 24 sites of one res10@640 b8 forward in bf16
// took 67.5 ms at 256 threads and 34.7 ms at 1024 on the H100, chip_smoke.py;
// 1024 caps registers at 64)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// round a float to the storage dtype and back
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one operation, rounded like the dtype's own arithmetic (no FMA contraction)
template <typename T> __device__ __forceinline__ float mul(float a, float b) { return rnd<T>(__fmul_rn(a, b)); }
template <typename T> __device__ __forceinline__ float add(float a, float b) { return rnd<T>(__fadd_rn(a, b)); }
template <typename T> __device__ __forceinline__ float sub(float a, float b) { return rnd<T>(__fsub_rn(a, b)); }

struct Consts {
  float thresh, decay, alpha, beta, leak;  // already rounded to the dtype
};

// element strides of x: [T, N, H, W, C]
struct Strides {
  long long t, n, h, w, c;
};

// spike (or SiLU) of a membrane value
template <typename T>
__device__ __forceinline__ float fire(float m, float thresh, int act) {
  if (act) return rnd<T>(__fdiv_rn(m, __fadd_rn(1.0f, expf(-m))));
  return m > thresh ? 1.0f : 0.0f;
}

// What one block holds and where its tile lies.
template <typename T>
struct Tile {
  T* mem;        // [M][pitch] state planes in shared memory
  T* ecs;
  T* d;
  int M, nc;     // window pixels, window columns
  int wr0, wc0;  // window origin in the image
  int r0, r1, c0, c1;  // interior rows [r0, r1), columns [c0, c1)
  int ch0, nch;  // this block's first channel and how many are real
};

// The per-element tail of a step for window pixel p, channel slot j: the ecs
// update from the 1x1 sum `acc`, then step t+1's membrane and spike.
template <typename T>
__device__ __forceinline__ void finish(const Tile<T>& tl, int pitch, int p, int j,
                                       float acc, const T* __restrict__ pwb,
                                       const T* xn, Strides xs, T* on, int H, int W,
                                       int C, const Consts& k, int act) {
  const int e = p * pitch + j;
  const int r = p / tl.nc, c = p % tl.nc;
  const int ch = tl.ch0 + j;
  const int hh = tl.wr0 + r, ww = tl.wc0 + c;
  const float ev = add<T>(rnd<T>(acc), ld(pwb + ch));
  const float en = add<T>(mul<T>(k.alpha, ev), mul<T>(k.leak, ld(tl.ecs + e)));
  const float fecs = mul<T>(k.beta, rnd<T>(tanhf(en)));
  const float mo = ld(tl.mem + e);
  const float gate = sub<T>(1.0f, fire<T>(mo, k.thresh, act));
  const float xv = ld(xn + hh * xs.h + ww * xs.w + ch * xs.c);
  const float mn = add<T>(add<T>(mul<T>(mul<T>(mo, k.decay), gate), xv), fecs);
  st(tl.ecs + e, en);
  st(tl.mem + e, mn);
  if (hh >= tl.r0 && hh < tl.r1 && ww >= tl.c0 && ww < tl.c1)
    st(on + ((long long)hh * W + ww) * C + ch, fire<T>(mn, k.thresh, act));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (2) for bf16: each warp takes 16-row tiles of the window in turn and 64
// output channels at a time; K runs over the cluster's slices in rank order
// and over each slice in steps of 16, so every output sums its channels in
// one fixed order.  pwp is [cs*cl][cs*cl] as [Cout][Cin].
__device__ __forceinline__ void product_and_finish(
    const Tile<bf16>& tl, cg::cluster_group& cluster, int cs, int cl, int pitch,
    const bf16* __restrict__ pwp, const bf16* __restrict__ pwb, const bf16* xn,
    Strides xs, bf16* on, int H, int W, int C, const Consts& k, int act) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  const int cp = cs * cl;
  for (int m0 = warp * 16; m0 < tl.M; m0 += kWarps * 16) {
    const int pa = m0 + g, pb = pa + 8;
    for (int n0 = 0; n0 < cl; n0 += 64) {
      const int nts = min(8, (cl - n0) / 8);
      float acc[8][4] = {};
      for (int kr = 0; kr < cs; ++kr) {
        const bf16* dr = cluster.map_shared_rank(tl.d, kr);
        const bf16* ra = dr + pa * pitch + q2;
        const bf16* rb = dr + pb * pitch + q2;
        const bf16* bk = pwp + (long long)(tl.ch0 + n0 + g) * cp + kr * cl + q2;
        for (int kk = 0; kk < cl; kk += 16) {
          uint32_t a[4];
          a[0] = pa < tl.M ? ld32(ra + kk) : 0u;
          a[1] = pb < tl.M ? ld32(rb + kk) : 0u;
          a[2] = pa < tl.M ? ld32(ra + kk + 8) : 0u;
          a[3] = pb < tl.M ? ld32(rb + kk + 8) : 0u;
          #pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt >= nts) break;
            const bf16* bp = bk + (long long)nt * 8 * cp + kk;
            mma_bf16(acc[nt], a, ld32(bp), ld32(bp + 8));
          }
        }
      }
      // accumulator fragment: rows g and g + 8, columns q2 and q2 + 1
      #pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= nts) break;
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = h ? pb : pa;
          if (p >= tl.M) continue;
          #pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = n0 + nt * 8 + q2 + i;
            if (j < tl.nch)
              finish<bf16>(tl, pitch, p, j, acc[nt][2 * h + i], pwb, xn, xs, on, H, W,
                           C, k, act);
          }
        }
      }
    }
  }
}

// (2) for float32: CUDA-core FMA in full f32, 4 pixels x 4 output channels a
// thread, channels summed one by one in ascending order.  pwp is
// [cs*cl][cs*cl] as [Cin][Cout].
__device__ __forceinline__ void product_and_finish(
    const Tile<float>& tl, cg::cluster_group& cluster, int cs, int cl, int pitch,
    const float* __restrict__ pwp, const float* __restrict__ pwb, const float* xn,
    Strides xs, float* on, int H, int W, int C, const Consts& k, int act) {
  // thread grid: ntx groups of 4 output channels by nty groups of 4 pixels
  const int ntx = cl % 64 == 0 ? 16 : (cl % 32 == 0 ? 8 : 4);
  const int nty = kThreads / ntx;
  const int tx = threadIdx.x % ntx, ty = threadIdx.x / ntx;
  const int cp = cs * cl;
  for (int m0 = 0; m0 < tl.M; m0 += nty * 4) {
    for (int n0 = 0; n0 < cl; n0 += ntx * 4) {
      const int j0 = n0 + tx * 4;
      float acc[4][4] = {};
      for (int kr = 0; kr < cs; ++kr) {
        const float* dr = cluster.map_shared_rank(tl.d, kr);
        const float* bk = pwp + (long long)kr * cl * cp + tl.ch0 + j0;
        for (int kk = 0; kk < cl; ++kk) {
          const float4 b = *reinterpret_cast<const float4*>(bk + (long long)kk * cp);
          const float bv[4] = {b.x, b.y, b.z, b.w};
          #pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int p = m0 + ty * 4 + i;
            const float a = p < tl.M ? dr[p * pitch + kk] : 0.0f;
            #pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a, bv[jj], acc[i][jj]);
          }
        }
      }
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = m0 + ty * 4 + i;
        if (p >= tl.M) continue;
        #pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (j0 + jj < tl.nch)
            finish<float>(tl, pitch, p, j0 + jj, acc[i][jj], pwb, xn, xs, on, H, W, C,
                          k, act);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ecs_lif_v2_kernel(const T* __restrict__ x, Strides xs, T* __restrict__ out,
                  const T* __restrict__ dw, const T* __restrict__ dwb,
                  const T* __restrict__ pwp, const T* __restrict__ pwb,
                  int Tn, int H, int W, int C, int cs, int cl, int pitch, int br, int bc,
                  int halo, Consts k, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.z;

  Tile<T> tl;
  tl.r0 = blockIdx.y * br;
  tl.r1 = min(H, tl.r0 + br);
  tl.c0 = (blockIdx.x / cs) * bc;
  tl.c1 = min(W, tl.c0 + bc);
  tl.wr0 = max(0, tl.r0 - halo);
  tl.wc0 = max(0, tl.c0 - halo);
  const int nr = min(H, tl.r1 + halo) - tl.wr0;
  tl.nc = min(W, tl.c1 + halo) - tl.wc0;
  tl.M = nr * tl.nc;
  tl.ch0 = rank * cl;
  tl.nch = min(cl, C - tl.ch0);
  // every block of a cluster has the same window, so the same plane offsets
  tl.mem = reinterpret_cast<T*>(smem);
  tl.ecs = tl.mem + tl.M * pitch;
  tl.d = tl.ecs + tl.M * pitch;
  const int plane = tl.M * cl;            // elements a block updates

  // offsets inside one image fit in an int (the wrapper checks H*W*C < 2^31)
  const long long img = (long long)H * W * C;
  const T* xi = x + n * xs.n;             // image n, step 0
  T* oi = out + n * img;

  // step 0: mem = x_0, ecs = 0
  for (int e = tid; e < plane; e += kThreads) {
    const int p = e / cl, j = e % cl;
    const int hh = tl.wr0 + p / tl.nc, ww = tl.wc0 + p % tl.nc;
    const int ch = tl.ch0 + j;
    const float m = j < tl.nch ? ld(xi + hh * xs.h + ww * xs.w + ch * xs.c) : 0.0f;
    st(tl.mem + p * pitch + j, m);
    st(tl.ecs + p * pitch + j, 0.0f);
    if (j < tl.nch && hh >= tl.r0 && hh < tl.r1 && ww >= tl.c0 && ww < tl.c1)
      st(oi + ((long long)hh * W + ww) * C + ch, fire<T>(m, k.thresh, act));
  }
  __syncthreads();

  for (int t = 0; t + 1 < Tn; ++t) {
    // (1) depthwise 3x3 of this step's spikes: tap by tap in the dtype, from
    // zero, row-major; a tap outside the window adds nothing
    for (int e = tid; e < plane; e += kThreads) {
      const int p = e / cl, j = e % cl;
      float dv = 0.0f;
      if (j < tl.nch) {
        const int r = p / tl.nc, c = p % tl.nc;
        const int ch = tl.ch0 + j;
        #pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int rr = r + dy - 1;
          if (rr < 0 || rr >= nr) continue;
          #pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int cc = c + dx - 1;
            if (cc < 0 || cc >= tl.nc) continue;
            const float s = fire<T>(ld(tl.mem + (rr * tl.nc + cc) * pitch + j), k.thresh, act);
            dv = add<T>(dv, mul<T>(s, ld(dw + (dy * 3 + dx) * C + ch)));
          }
        }
        dv = add<T>(dv, ld(dwb + ch));
      }
      st(tl.d + p * pitch + j, dv);
    }
    cluster.sync();

    // (2) p = d @ pw, then the per-element tail: ecs update, step t+1's
    // membrane and spike
    product_and_finish(tl, cluster, cs, cl, pitch, pwp, pwb, xi + (long long)(t + 1) * xs.t,
                       xs, oi + (long long)(t + 1) * gridDim.z * img, H, W, C, k, act);
    cluster.sync();
  }
}

template <typename T>
cudaError_t launch(const void* x, Strides xs, void* out, const void* dw, const void* dwb,
                   const void* pwp, const void* pwb, int Tn, int N, int H, int W, int C,
                   int cs, int cl, int pitch, int br, int bc, int halo, Consts k, int act,
                   int smem, cudaStream_t stream) {
  auto kernel = ecs_lif_v2_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((W + bc - 1) / bc) * cs, (H + br - 1) / br, N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), xs, static_cast<T*>(out),
                           static_cast<const T*>(dw), static_cast<const T*>(dwb),
                           static_cast<const T*>(pwp), static_cast<const T*>(pwb), Tn, H, W,
                           C, cs, cl, pitch, br, bc, halo, k, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Pointers are device pointers.  x is
// [Tn, N, H, W, C] with the element strides xs_*; out is contiguous; dw is
// [3, 3, C]; pwp is the 1x1 kernel padded with zeros to [cs*cl, cs*cl], as
// [Cin][Cout] for float32 and [Cout][Cin] for bfloat16.  cs blocks of a
// cluster split C into slices of cl channels (cl % 16 == 0, cs * cl >= C);
// each block's three state planes take smem bytes (pitch elements a window
// pixel).  The constants are already rounded to the dtype by the caller.
// Returns the cudaError_t of the launch (0 = launched).
int ecs_lif_v2_fwd(int dtype, const void* x, long long xs_t, long long xs_n,
                   long long xs_h, long long xs_w, long long xs_c, void* out,
                   const void* dw, const void* dwb, const void* pwp, const void* pwb,
                   int Tn, int N, int H, int W, int C, int cs, int cl, int pitch, int br,
                   int bc, int halo, float thresh, float decay, float alpha, float beta,
                   float leak, int act, int smem, void* stream) {
  if (cs < 1 || cs > 8 || cl % 16 != 0 || cs * cl < C || br < 1 || bc < 1)
    return (int)cudaErrorInvalidValue;
  Consts k{thresh, decay, alpha, beta, leak};
  Strides xs{xs_t, xs_n, xs_h, xs_w, xs_c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, xs, out, dw, dwb, pwp, pwb, Tn, N, H, W, C, cs, cl, pitch,
                              br, bc, halo, k, act, smem, s);
  if (dtype == 1)
    return (int)launch<bf16>(x, xs, out, dw, dwb, pwp, pwb, Tn, N, H, W, C, cs, cl, pitch,
                             br, bc, halo, k, act, smem, s);
  return (int)cudaErrorInvalidValue;
}

const char* ecs_lif_v2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
