// General-shape fused ECS-LIF forward for Hopper (sm_90a): the whole T-step
// recurrence of one MemUpdate site in ONE COOPERATIVE LAUNCH, with T-1
// grid-wide barriers and no halo recompute, for any H, W, C and any strides
// of x.
//
// Replaces ecs_yolo_tpu/snn/pallas_kernels.py:ecs_lif_fused (the TPU kernel
// `_ecs_kernel`).  Its arithmetic, step for step, in the input dtype:
//   fecs  = beta * tanh(ecs)
//   mem   = mem * decay * (1 - spike_prev) + x_t + fecs
//   spike = (float(mem) > thresh)            (SiLU when act)
//   d     = 0; for dy, dx in row-major order: d += spike[r+dy, w+dx] * dw[dy, dx]
//           (product and sum each rounded to the dtype), then d += dwb
//   p     = round(sum over ci, in f32, of d[ci] * pw[ci, co]) + pwb
//   ecs   = alpha * p + (1 - 1/tau) * ecs
// Every elementwise operation rounds to the storage dtype, and no rounding
// is skipped: a fused multiply-add appears only where its product is exact
// (a bf16 x bf16 product in f32, a Heaviside spike times a weight).  The 1x1
// sum runs over ci = 0..C-1 in that order, each product and each partial
// sum rounded to f32: the plain version (snn/fused.py:ecs_lif_rows_reference)
// sums in the same order, so the two agree bit for bit apart from tanh/exp.
// The TPU kernel also updates ecs after the last step; nobody can observe
// that and it is skipped.
//
// Design.  The spikes of step t-1 are the output plane out[t-1], and the
// only thing step t needs from another pixel is the one-pixel halo of those
// spikes.  So the launch runs all T steps with one grid-wide barrier between
// steps (an arrival counter and a generation word in a small device buffer,
// left ready for the next launch; the grid is sized from the occupancy query
// so that cudaLaunchCooperativeKernel guarantees every block is resident),
// and nothing is recomputed across tiles.
//   * Work items are (pixel tile x Cout slice): 128 consecutive pixels of the
//     flattened N*H*W plane times a slice of 64 output channels, masked
//     past C (snn/fused.py:plan_k2 decides the grid and the shared
//     memory).  Block b owns the slice b % slices and every
//     (grid/slices)-th tile from b / slices for the whole launch: the
//     membrane and ECS state of its items never leave it.  They live between
//     steps in an owner-only workspace [2, P, C] in x's dtype (mem, ecs),
//     which step 1 does not read (mem_0 = x_0, ecs = 0) and the last step
//     does not write.  out is always dense [T, N, H, W, C] (the wrapper
//     allocates it), so the window's layout never depends on x's strides;
//     x itself is read once an element a step, in the tail, through its
//     strides.
//   * Step 0: spike_0 = fire(x_0), written to out[0].
//   * Step t >= 1, per item, K-chunk by K-chunk of 32 input channels: the
//     window of out[t-1] the tile's 3x3 taps reach -- three runs of 130
//     pixels, or one run of 2W + 130 where they overlap -- comes into a
//     2-stage ring in shared memory, by cp.async.cg in 16-byte pieces
//     XOR-swizzled by the slot where C % 8 == 0 (every model site), else by
//     guarded scalar L2 loads (ld.global.cg); out is read and written by
//     different blocks inside the launch, so it is never read through the
//     non-coherent path.  The chunk's depthwise weights and its rows of pw
//     (converted to f32) are staged beside it, read through the caller's
//     strides (16-byte runs along ci or co where the layout has them) a
//     chunk ahead: no parameter is copied on the host.
//       d = dw3x3(spike) + dwb for the tile's 128 pixels x 32 channels, tap by
//       tap in the dtype (bf16 on bf16 pairs), into a [32][128] f32 tile;
//       a tap outside the image reads a slot of zeros instead of branching;
//       then the 1x1 on CUDA cores, never tensor cores: a register-tiled
//       outer product, 8 pixels x slice/16 channels a thread, over the
//       chunk's 32 channels in index order.  Every accumulator receives its
//       products in ci order: no split-K, no reduction across threads.
//       bf16 takes fmaf (a bf16 x bf16 product is exact in f32, so one
//       rounding, as the plain version's separate multiply and add); f32
//       takes __fmul_rn then __fadd_rn (nvcc would contract a * b + c).
//     Epilogue: each warp stages its outputs, rounded to the dtype, in its
//     own rows of the window stage the chunk has consumed and reads them
//     back as 8 channels of one pixel a lane, so that the tail moves 16-byte
//     runs: e = rnd(acc) + pwb, then ecs,
//     fecs, mem and spike in the order above; spike_{t-1} read from out[t-1]
//     (ld.global.cg), spike_t written to out[t].  bf16 runs the tail on bf16
//     pairs (add/sub/mul.rn.bf16x2 give the float32 operation's value
//     rounded to bf16, see hadd2), without the float-to-bf16 conversions,
//     which run at a quarter of the FMA rate.  C % 8 != 0 or an x without
//     unit channel stride takes a scalar tail of the same arithmetic.
//
// What bounds it.  The function moves 2 * T*N*H*W*C elements (x in, spikes
// out; x once where it is a broadcast over T) and does (T-1)*N*H*W*C*C
// multiply-adds in the 1x1 -- on CUDA cores, because a tensor core sums a
// k-step's products as a group and this function fixes the order -- plus
// some 18*C elementwise operations an element and step.  From C >= 64 the
// product bounds it, at one FFMA a multiply-add in bf16 and two instructions
// in f32.  Beyond that this version pays the state round trip through the
// workspace (HBM at 320x320 and 160x160), the window's halo (up to 3x the
// tile's pixels from L2 at W >= 130), the depthwise pass repeated once per
// Cout slice, the f32 staging of pw, items that do not divide evenly over
// the grid (up to a quarter of the time at the 20x20 and 40x40 sites), and
// the barriers.  Wider slices (128) or more tail loads in flight spill
// registers at two blocks an SM and read slower.

#include "ecs_lif_common.cuh"

namespace {

constexpr int kThreads = 256;     // 16 x 16 threads over a 128 x slice product tile
constexpr int kTile = 128;        // pixels of a work item
constexpr int kRun = kTile + 2;   // pixels of one row run of a window
constexpr int KC = 32;            // input channels of a K-chunk
constexpr int kSlice = 64;        // output channels of a work item (fused.py:K2_SLICE)

struct Params {
  const void* x;          // x[t][n][h][w][c] at t*xs_t + n*xs_n + h*xs_h + w*xs_w + c*xs_c
  long long xs_t, xs_n, xs_h, xs_w, xs_c;
  int x_vec;              // xs_c == 1, the others and x 16-byte aligned in 8-element runs
  void* out;              // [T][P][C]; out[t-1] is read by every block at step t
  const void* dw;         // dw[dy][dx][c] at dy*dw_sy + dx*dw_sx + c*dw_sc
  long long dw_sy, dw_sx, dw_sc;
  const void* dwb;
  long long dwb_s;
  const void* pw;         // pw[ci][co] at ci*pw_si + co*pw_so
  long long pw_si, pw_so;
  int pw_vec;             // 16-byte reads: 1 along ci (pw_si == 1), 2 along co; 0 none
  const void* pwb;
  long long pwb_s;
  void* ws;               // [2][P][C]: mem, ecs between steps (T > 2)
  unsigned* bar;          // [2]: arrivals, generation
  long long P;            // N*H*W
  int Tn, H, W, C, slices, tiles, act;
  float thresh, decay, alpha, beta, leak;   // rounded to the dtype by the caller
};

// --- loads, stores, roundings ----------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// a run of V floats (V = 1, 2 or 4; aligned to its size)
template <int V, int L>
__device__ __forceinline__ void ldf(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 a = ldg<L, float4>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = ldg<L, float2>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = ldg<L, float>(p);
  }
}
template <int V>
__device__ __forceinline__ void stf(float* p, const float* v) {
  if constexpr (V == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else *p = v[0];
}

// one multiply-add of the 1x1, as the plain version's f32 multiply then add:
// a bf16 x bf16 product is exact in f32, so fmaf rounds once as they do
template <typename T> __device__ __forceinline__ float mac(float a, float b, float acc);
template <> __device__ __forceinline__ float mac<bf16>(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
template <> __device__ __forceinline__ float mac<float>(float a, float b, float acc) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// --- the window --------------------------------------------------------------------

// Byte offset of 16-byte piece c16 of window slot `slot`: a slot holds the
// chunk's 32 channels of one pixel (64 bytes bf16, 128 f32); the pieces are
// XOR-swizzled so that the depthwise pass's reads, one slot a thread, fall
// on distinct banks.
template <typename T>
__device__ __forceinline__ int piece_at(int slot, int c16) {
  if constexpr (sizeof(T) == 2) return slot * 64 + ((c16 ^ ((slot >> 1) & 3)) << 4);
  else return slot * 128 + ((c16 ^ (slot & 7)) << 4);
}

// the flat pixel of window slot `slot` of the tile at p0 (S = min(W, kRun))
__device__ __forceinline__ long long slot_pixel(int slot, long long p0, const Params& p) {
  return p.W <= kRun ? p0 - p.W - 1 + slot
                     : p0 + (long long)(slot / kRun - 1) * p.W - 1 + slot % kRun;
}

// The window of out[t-1] that the 3x3 taps of the tile [p0, p0 + 128) reach,
// input channels [kc*32, kc*32 + 32): the flat pixel p + dy*W + dx lies in
// slot (dy+1)*S + (p - p0) + dx + 1.  Slots outside the plane (and channels
// past C) are zeros; pixels of a neighbouring row or image are loaded but
// masked by the taps.  `vec` (C % 8 == 0): cp.async in 16-byte pieces, else
// element by element through L2, at once.
template <typename T>
__device__ __forceinline__ void load_window(const T* prev, uint8_t* win, uint32_t dst,
                                            long long p0, int kc, const Params& p, int NS,
                                            bool vec) {
  constexpr int E = 16 / sizeof(T);
  constexpr int NP = KC / E;
  if (vec) {
    for (int i = threadIdx.x; i < NS * NP; i += kThreads) {
      const int slot = i / NP, c16 = i % NP;
      const long long px = slot_pixel(slot, p0, p);
      const int c = kc * KC + c16 * E;
      const bool in = px >= 0 && px < p.P && c < p.C;
      cp_async16(dst + piece_at<T>(slot, c16), in ? prev + px * p.C + c : prev, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < NS * KC; i += kThreads) {
      const int slot = i / KC, c = i % KC;
      const long long px = slot_pixel(slot, p0, p);
      const int cc = kc * KC + c;
      T v{};
      if (px >= 0 && px < p.P && cc < p.C) {
        const T* src = prev + px * p.C + cc;
        if constexpr (sizeof(T) == 2) {
          const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(src));
          v = *reinterpret_cast<const bf16*>(&u);
        } else {
          v = __ldcg(src);
        }
      }
      *reinterpret_cast<T*>(win + piece_at<T>(slot, c / E) + (c % E) * sizeof(T)) = v;
    }
  }
}

// --- the chunk's weights -------------------------------------------------------------

// The thread's share of a chunk's weights in registers: rows [k0, k0 + 32)
// of the block's slice of pw in 16-byte pieces (where pw has 16-byte runs
// along ci or co, Params::pw_vec), and two of the chunk's 9 x 32 depthwise
// weights and 32 biases.  Loaded a chunk ahead, so that their latency
// overlaps the depthwise pass; stored to shared memory after it.
template <typename T, int BN>
struct Weights {
  static constexpr int E = 16 / sizeof(T);                          // elements of a piece
  static constexpr int NV = (BN * KC / E + kThreads - 1) / kThreads;
  uint4 pv[NV];
  T dv[2];
};

template <typename T, int BN>
__device__ __forceinline__ void load_weights(const Params& p, int k0, int co0, Weights<T, BN>& r) {
  constexpr int E = Weights<T, BN>::E;
  const T* pw = static_cast<const T*>(p.pw);
  const int C = p.C, tid = threadIdx.x;
  #pragma unroll
  for (int q = 0; q < Weights<T, BN>::NV; ++q) {
    const int i = tid + q * kThreads;
    r.pv[q] = make_uint4(0u, 0u, 0u, 0u);
    if (p.pw_vec == 1 && i < BN * (KC / E)) {          // E input channels of one output
      const int ci = k0 + i / BN * E, co = co0 + i % BN;
      if (co < C && ci < C) r.pv[q] = __ldg(reinterpret_cast<const uint4*>(pw + co * p.pw_so + ci));
    } else if (p.pw_vec == 2 && i < KC * (BN / E)) {   // E output channels of one input
      const int ci = k0 + i / (BN / E), co = co0 + i % (BN / E) * E;
      if (co < C && ci < C) r.pv[q] = __ldg(reinterpret_cast<const uint4*>(pw + ci * p.pw_si + co));
    }
  }
  const T* dw = static_cast<const T*>(p.dw);
  const T* dwb = static_cast<const T*>(p.dwb);
  #pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = tid + q * kThreads, tap = i / KC, ci = k0 + i % KC;
    r.dv[q] = T{};
    if (i < 10 * KC && ci < C)
      r.dv[q] = tap < 9 ? dw[(tap / 3) * p.dw_sy + (tap % 3) * p.dw_sx + ci * p.dw_sc]
                        : dwb[ci * p.dwb_s];
  }
}

// The chunk's weights into shared memory: pw rows as f32 into Bs [32][BN]
// (zeros past C; element by element through the strides where pw has no
// 16-byte runs), the depthwise weights into dws [9][32] and the bias after
// them [32].
template <typename T, int BN>
__device__ __forceinline__ void store_weights(const Params& p, int k0, int co0,
                                              const Weights<T, BN>& r, float* Bs, T* dws) {
  constexpr int E = Weights<T, BN>::E;
  const int C = p.C, tid = threadIdx.x;
  if (p.pw_vec) {
    #pragma unroll
    for (int q = 0; q < Weights<T, BN>::NV; ++q) {
      const int i = tid + q * kThreads;
      const T* v = reinterpret_cast<const T*>(&r.pv[q]);
      if (p.pw_vec == 1 && i < BN * (KC / E)) {
        const int k = i / BN * E, n = i % BN;
        #pragma unroll
        for (int e = 0; e < E; ++e) Bs[(k + e) * BN + n] = to_f(v[e]);
      } else if (p.pw_vec == 2 && i < KC * (BN / E)) {
        const int k = i / (BN / E), n = i % (BN / E) * E;
        #pragma unroll
        for (int e = 0; e < E; ++e) Bs[k * BN + n + e] = to_f(v[e]);
      }
    }
  } else {
    const T* pw = static_cast<const T*>(p.pw);
    for (int i = tid; i < KC * BN; i += kThreads) {
      // read along the unit stride of pw where it has one
      const int k = p.pw_si == 1 ? i % KC : i / BN, n = p.pw_si == 1 ? i / KC : i % BN;
      const int ci = k0 + k, co = co0 + n;
      Bs[k * BN + n] = ci < C && co < C ? to_f(pw[ci * p.pw_si + co * p.pw_so]) : 0.f;
    }
  }
  #pragma unroll
  for (int q = 0; q < 2; ++q)
    if (tid + q * kThreads < 10 * KC) dws[tid + q * kThreads] = r.dv[q];
}

// --- the depthwise pass ----------------------------------------------------------------

// d of pixel r of the tile and channels 16*half .. +16 of the chunk, tap by
// tap in the dtype from zero, then + dwb, into As [32][128] as f32.  dws:
// [9][32] weights, then [32] biases.  A tap outside the image reads a slot
// of zeros (`zero`), so that it adds +-0, as the plain version's zero
// padding does, without a branch.  Heaviside spikes (ACT false) multiply
// exactly, so the product and sum take one fused operation with the same
// result.
template <bool ACT>
__device__ __forceinline__ void depthwise(const uint8_t* win, const uint8_t* zero, const bf16* dws,
                                          int S, int r, int half, uint32_t valid, float* As) {
  uint32_t d[8];
  #pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = 0u;
  #pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int slot = (tap / 3) * S + r + tap % 3;
    const bool in = (valid >> tap) & 1u;
    const uint8_t* base = in ? win + slot * 64 : zero;
    const int swz = in ? (slot >> 1) & 3 : 0;
    const uint4 s0 = *reinterpret_cast<const uint4*>(base + (((2 * half) ^ swz) << 4));
    const uint4 s1 = *reinterpret_cast<const uint4*>(base + (((2 * half + 1) ^ swz) << 4));
    const uint4 w0 = *reinterpret_cast<const uint4*>(dws + tap * KC + 16 * half);
    const uint4 w1 = *reinterpret_cast<const uint4*>(dws + tap * KC + 16 * half + 8);
    const uint32_t sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const uint32_t wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    #pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = ACT ? hadd2(d[i], hmul2(sv[i], wv[i])) : hfma2(sv[i], wv[i], d[i]);
  }
  const uint4 b0 = *reinterpret_cast<const uint4*>(dws + 9 * KC + 16 * half);
  const uint4 b1 = *reinterpret_cast<const uint4*>(dws + 9 * KC + 16 * half + 8);
  const uint32_t bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  #pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t v = hadd2(d[i], bv[i]);
    As[(16 * half + 2 * i) * kTile + r] = lo_f(v);
    As[(16 * half + 2 * i + 1) * kTile + r] = hi_f(v);
  }
}
template <bool ACT>
__device__ __forceinline__ void depthwise(const uint8_t* win, const uint8_t* zero, const float* dws,
                                          int S, int r, int half, uint32_t valid, float* As) {
  depthwise_f32<ACT, kTile>(win, zero, dws, KC, dws + 9 * KC, S, r, half, valid, As);
}

// --- the 1x1 product -------------------------------------------------------------------

// Thread (tm, tn) holds pixels 4*tm + {0..3} and 64 + 4*tm + {0..3} of the
// tile (rows i of acc) and the R = BN/16 channels R*tn + {0..R} of the slice
// (columns j): a 16- or 8-byte B read, on distinct banks across the warp's 8
// tn.  Each k adds its products into every accumulator in ci order.
template <typename T, int BN>
__device__ __forceinline__ void kstep(const float* As, const float* Bs, float (&acc)[8][BN / 16],
                                      int tm, int tn, int k) {
  constexpr int R = BN / 16;
  const float4 a0 = *reinterpret_cast<const float4*>(As + k * kTile + 4 * tm);
  const float4 a1 = *reinterpret_cast<const float4*>(As + k * kTile + 64 + 4 * tm);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  float b[R];
  ldf<R, kPlain>(Bs + k * BN + R * tn, b);
  #pragma unroll
  for (int i = 0; i < 8; ++i)
    #pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = mac<T>(a[i], b[j], acc[i][j]);
}

template <typename T, int BN>
__device__ __forceinline__ void product(const float* As, const float* Bs, float (&acc)[8][BN / 16],
                                        int tm, int tn, int kn) {
  if (kn == KC) {
    #pragma unroll 4
    for (int k = 0; k < KC; ++k) kstep<T, BN>(As, Bs, acc, tm, tn, k);
  } else {
    #pragma unroll 1
    for (int k = 0; k < kn; ++k) kstep<T, BN>(As, Bs, acc, tm, tn, k);
  }
}

// --- the epilogue ----------------------------------------------------------------------

// Warp w's outputs of an item: pixels 16*(w/2) + {0..15} and 64 + the same
// (tm's rows), channels (w%2)*WC + {0..WC}, WC = BN/2 (tn's columns).  The
// warp stages them, rounded to the dtype (the tail's first operation), in
// its own PITCH-byte rows of the window stage that chunk's depthwise pass
// has consumed, and reads them back as groups of 8 channels of one pixel,
// one group at a time: the tail then moves 16-byte runs and the
// accumulators are dead (two or four groups' loads in flight at once spill
// registers and read slower).
template <typename T, int BN> struct Epi {
  static constexpr int WC = BN / 2;                      // channels of a warp's block
  static constexpr int PITCH = WC * (int)sizeof(T) + 16; // bytes of a staged pixel
  static constexpr int BYTES = 32 * PITCH;               // a warp's staging
  static constexpr int G = WC / 8;                       // groups of 8 channels a lane
};

template <typename T, int BN>
__device__ __forceinline__ void stage_acc(const float (&acc)[8][BN / 16], uint8_t* stg, int lane) {
  constexpr int R = BN / 16, PITCH = Epi<T, BN>::PITCH;
  const int tml = lane >> 3, tnl = lane & 7;
  #pragma unroll
  for (int i = 0; i < 8; ++i) {
    T* d = reinterpret_cast<T*>(stg + ((i >> 2) * 16 + 4 * tml + (i & 3)) * PITCH) + R * tnl;
    const float* a = acc[i];
    if constexpr (sizeof(T) == 2) {
      if constexpr (R == 4)
        *reinterpret_cast<uint2*>(d) = make_uint2(pack_bf16x2(a[0], a[1]), pack_bf16x2(a[2], a[3]));
      else
        *reinterpret_cast<uint32_t*>(d) = pack_bf16x2(a[0], a[1]);
    } else {
      stf<R>(reinterpret_cast<float*>(d), a);
    }
  }
}

// The item's tail of step t from the warp's staging: ecs, mem and spike; mem
// and ecs kept in the workspace for the next step (none after the last).
// `vec`: C % 8 == 0 and x read in runs (Params::x_vec), so a group moves in
// 16-byte pieces, and bf16 computes in bf16 pairs; else element by element.
template <typename T, int BN>
__device__ __forceinline__ void epilogue(const Params& p, const uint8_t* stg, int t, long long p0,
                                         int co0, const T* pwb_s, int warp, int lane, bool vec) {
  using E = Epi<T, BN>;
  constexpr int NWD = 8 * sizeof(T) / 4;     // 32-bit words of a group
  T* out = static_cast<T*>(p.out);
  const long long pc = p.P * p.C;
  T* mem_ws = static_cast<T*>(p.ws);
  T* ecs_ws = mem_ws + pc;
  const bool keep = t + 1 < p.Tn;
  #pragma unroll
  for (int q = 0; q < E::G; ++q) {
    const int g = lane + 32 * q, pxw = g / E::G, cw8 = g % E::G * 8;
    const long long px = p0 + (pxw >> 4) * 64 + 16 * (warp >> 1) + (pxw & 15);
    const int ch = (warp & 1) * E::WC + cw8, co = co0 + ch;
    if (px >= p.P || co >= p.C) continue;
    const long long e = px * p.C + co;
    const T* xp = x_at<T>(p, px) + co * p.xs_c;
    const T* ev = reinterpret_cast<const T*>(stg + pxw * E::PITCH) + cw8;
    if (vec) {
      uint32_t xw[NWD], sw[NWD], mw[NWD], cw[NWD], ew[NWD], bw[NWD];
      ld8w<kNc>(xp + t * p.xs_t, xw);
      ld8w<kCg>(out + (t - 1) * pc + e, sw);
      if (t == 1) {                       // mem_0 = x_0, no field yet
        ld8w<kNc>(xp, mw);
        #pragma unroll
        for (int m = 0; m < NWD; ++m) cw[m] = 0u;
      } else {
        ld8w<kPlain>(mem_ws + e, mw);
        ld8w<kPlain>(ecs_ws + e, cw);
      }
      ld8w<kPlain>(ev, ew);
      ld8w<kPlain>(pwb_s + ch, bw);
      if constexpr (sizeof(T) == 2) {
        const Pairs k2 = pairs(p);
        #pragma unroll
        for (int m = 0; m < NWD; ++m)
          finish2(ew[m], bw[m], cw[m], mw[m], sw[m], xw[m], k2, p.thresh, p.act);
      } else {
        #pragma unroll
        for (int m = 0; m < NWD; ++m) {
          float cv = __uint_as_float(cw[m]), mv = __uint_as_float(mw[m]);
          float sv = __uint_as_float(sw[m]);
          finish<T>(__uint_as_float(ew[m]), __uint_as_float(bw[m]), cv, mv, sv,
                    __uint_as_float(xw[m]), p);
          cw[m] = __float_as_uint(cv); mw[m] = __float_as_uint(mv); sw[m] = __float_as_uint(sv);
        }
      }
      st8w(out + t * pc + e, sw);
      if (keep) {
        st8w(mem_ws + e, mw);
        st8w(ecs_ws + e, cw);
      }
      continue;
    }
    #pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (co + m >= p.C) break;
      const long long em = e + m;
      float xv = ld1<kNc>(xp + t * p.xs_t + m * p.xs_c);
      float sv = ld1<kCg>(out + (t - 1) * pc + em);
      float mv, cv;
      if (t == 1) {
        mv = ld1<kNc>(xp + m * p.xs_c);
        cv = 0.f;
      } else {
        mv = ld1<kPlain>(mem_ws + em);
        cv = ld1<kPlain>(ecs_ws + em);
      }
      finish<T>(to_f(ev[m]), to_f(pwb_s[ch + m]), cv, mv, sv, xv, p);
      st1(out + t * pc + em, sv);
      if (keep) {
        st1(mem_ws + em, mv);
        st1(ecs_ws + em, cv);
      }
    }
  }
}

// --- the kernel --------------------------------------------------------------------------

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 2) ecs_lif_rows_kernel(const __grid_constant__ Params p) {
  static_assert(BN == kSlice, "one instance: a slice of 64 output channels");
  constexpr int SB = KC * sizeof(T);        // bytes of a window slot
  extern __shared__ __align__(16) uint8_t smem[];
  const int C = p.C;
  const long long pc = p.P * C;
  const int nk = (C + KC - 1) / KC;
  const int S = min(p.W, kRun), NS = 2 * S + kRun;
  // a window stage, large enough to hold the eight warps' staged outputs
  const int STG = max(NS * SB, 8 * Epi<T, BN>::BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tn = (warp & 1) * 8 + (lane & 7), tm = (warp >> 1) * 4 + (lane >> 3);
  const int r = tid & (kTile - 1), half = tid >> 7;
  const int slice = blockIdx.x % p.slices, per = gridDim.x / p.slices;
  const int j0 = blockIdx.x / p.slices;
  const int mine = j0 < p.tiles ? (p.tiles - 1 - j0) / per + 1 : 0;
  const int co0 = slice * BN;
  const bool vec = C % 8 == 0;              // the window in 16-byte pieces
  const bool xvec = vec && p.x_vec;         // x, out and the workspace in runs

  // shared memory (snn/fused.py:k2_smem): [2 window stages of STG bytes]
  // [As f32 32 x 128] [2 x Bs f32 32 x BN] [2 x (dw 9 x 32, dwb 32)] [the
  // slice's pwb BN] [a slot of zeros]
  uint8_t* win = smem;
  float* As = reinterpret_cast<float*>(smem + 2 * STG);
  float* Bs = As + KC * kTile;
  T* dws = reinterpret_cast<T*>(Bs + 2 * KC * BN);
  T* pwb_s = dws + 2 * 10 * KC;
  uint8_t* zero = reinterpret_cast<uint8_t*>(pwb_s + BN);   // one window slot of zeros
  for (int i = tid; i < SB / 4; i += kThreads) reinterpret_cast<uint32_t*>(zero)[i] = 0u;

  const T* pwb = static_cast<const T*>(p.pwb);
  for (int i = tid; i < BN; i += kThreads)
    pwb_s[i] = co0 + i < C ? pwb[(co0 + i) * p.pwb_s] : T{};

  T* out = static_cast<T*>(p.out);

  // step 0: spike_0 = fire(x_0), the block's own items
  if (xvec) {
    constexpr int NG = kTile * (BN / 8);       // groups of 8 channels of an item
    #pragma unroll 4
    for (int g = tid; g < mine * NG; g += kThreads) {
      const long long px = (long long)(j0 + g / NG * per) * kTile + g % NG / (BN / 8);
      const int co = co0 + g % (BN / 8) * 8;
      if (px >= p.P || co >= C) continue;
      float v[8];
      load8<kNc>(x_at<T>(p, px) + co, v);
      #pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = fire<T>(v[i], p.thresh, p.act);
      store8(out + px * C + co, v);
    }
  } else {
    for (int g = tid; g < mine * kTile * BN; g += kThreads) {
      const long long px = (long long)(j0 + g / (kTile * BN) * per) * kTile + g % (kTile * BN) / BN;
      const int co = co0 + g % BN;
      if (px >= p.P || co >= C) continue;
      st1(out + px * C + co, fire<T>(ld1<kNc>(x_at<T>(p, px) + co * p.xs_c), p.thresh, p.act));
    }
  }

  float acc[8][BN / 16];
  #pragma unroll
  for (int i = 0; i < 8; ++i)
    #pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
  uint32_t valid = 0u;
  const int total = mine * nk;
  const uint32_t win_addr = smem_addr(win);
  auto tile_p0 = [&](int s) { return (long long)(j0 + s / nk * per) * kTile; };
  Weights<T, BN> wr;

  // Per chunk s: [barrier] window s+1 issued; d of chunk s into As; the
  // weights of chunk s+1 (loaded before the depthwise pass) stored to their
  // stage; [barrier] the product of chunk s, and at an item's last chunk
  // its tail.  Chunk s's window and weights were issued one chunk ahead.
  for (int t = 1; t < p.Tn; ++t) {
    grid_sync(p.bar);                    // out[t-1] is complete
    const T* prev = out + (t - 1) * pc;
    if (total > 0) {
      load_window<T>(prev, win, win_addr, tile_p0(0), 0, p, NS, vec);
      load_weights<T, BN>(p, 0, co0, wr);
      store_weights<T, BN>(p, 0, co0, wr, Bs, dws);
    }
    cp_async_commit();
    for (int s = 0; s < total; ++s) {
      const int kc = s % nk, st = s & 1;
      const long long p0 = tile_p0(s);
      cp_async_wait<0>();
      __syncthreads();                   // window s and chunk s's weights are in; the
                                         // product of s-1 is done with As and Bs
      const bool next = s + 1 < total;
      if (next) {
        const int o = (st ^ 1) * STG;
        load_window<T>(prev, win + o, win_addr + o, tile_p0(s + 1), (s + 1) % nk, p, NS, vec);
        load_weights<T, BN>(p, (s + 1) % nk * KC, co0, wr);
      }
      cp_async_commit();
      if (kc == 0) valid = tap_mask(p0 + r, p);
      if (p.act)
        depthwise<true>(win + st * STG, zero, dws + st * 10 * KC, S, r, half, valid, As);
      else
        depthwise<false>(win + st * STG, zero, dws + st * 10 * KC, S, r, half, valid, As);
      if (next)
        store_weights<T, BN>(p, (s + 1) % nk * KC, co0, wr, Bs + (st ^ 1) * KC * BN,
                             dws + (st ^ 1) * 10 * KC);
      __syncthreads();                   // d of chunk s is in As
      product<T, BN>(As, Bs + st * KC * BN, acc, tm, tn, min(KC, C - kc * KC));
      if (kc == nk - 1) {
        // the window stage of chunk s is consumed: each warp stages its
        // outputs in its own part of it
        uint8_t* stg = win + st * STG + warp * Epi<T, BN>::BYTES;
        stage_acc<T, BN>(acc, stg, lane);
        __syncwarp();
        epilogue<T, BN>(p, stg, t, p0, co0, pwb_s, warp, lane, xvec);
        #pragma unroll
        for (int i = 0; i < 8; ++i)
          #pragma unroll
          for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
      }
    }
  }
}

template <typename T, int BN>
cudaError_t allow_smem(int smem) {
  static int allowed = 0;   // the dynamic shared memory this instance may take
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        ecs_lif_rows_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  return cudaSuccess;
}

template <typename T, int BN>
cudaError_t launch(Params& prm, int grid, int smem, cudaStream_t st) {
  const cudaError_t e = allow_smem<T, BN>(smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&prm};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ecs_lif_rows_kernel<T, BN>),
                                     dim3(grid), dim3(kThreads), args, (size_t)smem, st);
}

template <typename T, int BN>
int occupancy(int smem) {
  cudaError_t e = allow_smem<T, BN>(smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ecs_lif_rows_kernel<T, BN>,
                                                      kThreads, (size_t)smem);
  return e == cudaSuccess ? blocks : -(int)e;
}


}  // namespace

extern "C" {

// a: 35 int64 values (snn/fused.py:ecs_lif_fused_rows): dtype (0 = float32,
// 1 = bfloat16), slice N, x, x's five strides (t, n, h, w, c), x_vec, out,
// dw and its dy/dx/c strides, dwb and its stride, pw, its ci/co strides and
// 16-byte mode, pwb and its stride, the workspace, the barrier buffer, T,
// N, H, W, C, slices, tiles, grid, shared memory bytes, act, stream.  k:
// thresh, decay, alpha, beta, leak, already rounded to the dtype.  Returns
// the launch's cudaError_t (0 = launched).
int ecs_lif_rows_fwd(const long long* a, const float* k) {
  Params prm;
  const int dtype = (int)a[0], n = (int)a[1];
  prm.x = reinterpret_cast<const void*>(a[2]);
  prm.xs_t = a[3]; prm.xs_n = a[4]; prm.xs_h = a[5]; prm.xs_w = a[6]; prm.xs_c = a[7];
  prm.x_vec = (int)a[8];
  prm.out = reinterpret_cast<void*>(a[9]);
  prm.dw = reinterpret_cast<const void*>(a[10]);
  prm.dw_sy = a[11]; prm.dw_sx = a[12]; prm.dw_sc = a[13];
  prm.dwb = reinterpret_cast<const void*>(a[14]);
  prm.dwb_s = a[15];
  prm.pw = reinterpret_cast<const void*>(a[16]);
  prm.pw_si = a[17]; prm.pw_so = a[18];
  prm.pw_vec = (int)a[19];
  prm.pwb = reinterpret_cast<const void*>(a[20]);
  prm.pwb_s = a[21];
  prm.ws = reinterpret_cast<void*>(a[22]);
  prm.bar = reinterpret_cast<unsigned*>(a[23]);
  prm.Tn = (int)a[24];
  const long long images = a[25];
  prm.H = (int)a[26]; prm.W = (int)a[27]; prm.C = (int)a[28];
  prm.slices = (int)a[29]; prm.tiles = (int)a[30];
  const int grid = (int)a[31], smem = (int)a[32];
  prm.act = (int)a[33];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a[34]);
  prm.P = images * prm.H * prm.W;
  prm.thresh = k[0]; prm.decay = k[1]; prm.alpha = k[2]; prm.beta = k[3]; prm.leak = k[4];
  if (n != kSlice || prm.C <= 0 || prm.slices <= 0 || grid < prm.slices || grid % prm.slices ||
      (long long)prm.slices * n < prm.C || (long long)prm.tiles * kTile < prm.P ||
      (prm.pw_vec && prm.C % 8) || (prm.x_vec && prm.xs_c != 1))
    return (int)cudaErrorInvalidValue;
  if (prm.P == 0 || prm.Tn == 0) return (int)cudaSuccess;
  if (dtype == 0) return (int)launch<float, kSlice>(prm, grid, smem, st);
  if (dtype == 1) return (int)launch<bf16, kSlice>(prm, grid, smem, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the (dtype, slice N) instance one SM holds with `smem` bytes of
// dynamic shared memory; a negative cudaError_t on failure.
int ecs_lif_rows_occupancy(int dtype, int n, int smem) {
  if ((dtype != 0 && dtype != 1) || n != kSlice) return -(int)cudaErrorInvalidValue;
  return dtype == 1 ? occupancy<bf16, kSlice>(smem) : occupancy<float, kSlice>(smem);
}

const char* ecs_lif_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
