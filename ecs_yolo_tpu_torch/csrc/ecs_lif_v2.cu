// ECS-LIF forward for Hopper (sm_90a) with the state the TPU kernel keeps in
// scratch: the whole T-step recurrence of one site in ONE COOPERATIVE
// LAUNCH, with T-1 grid-wide barriers and no halo recompute, for any H, W,
// C and any strides of x.
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
// Every elementwise operation rounds to the storage dtype, as in
// csrc/ecs_lif_rows.cu (K2), whose plain version
// (snn/fused.py:ecs_lif_rows_reference) is this kernel's too.  The 1x1 sum
// is where the two differ, as the TPU kernel's MXU product does: bf16 runs
// it on the tensor cores (wgmma, f32 accumulation, K in channel order) and
// float32 as an FMA chain in channel order, so its gates against the plain
// version are a spike-mismatch share, not exactness.  The product's order
// over the channels never depends on the tiling, so the result is the same,
// bit for bit, for every block_rows.  The update of ecs after the last
// step, which nobody observes, is skipped.
//
// Design: K1's launch (csrc/ecs_lif.cu) with K2's depthwise rounding.  The
// spikes of step t-1 are the output plane out[t-1], and the only thing step
// t needs from another pixel is the one-pixel halo of those spikes; so all T
// steps run in one launch with a grid barrier between steps (the buffer of
// snn/ecs_lif.py:_barrier, shared with K1 and K2; the grid from the
// occupancy query, so that every block is resident), and nothing is
// recomputed across tiles.
//   * Work items are (pixel tile x Cout slice): `sub` runs of 128
//     consecutive pixels of the flattened N*H*W plane (block_rows * W pixels
//     rounded up to 128, or one run) times a slice of N = 32, 64 or 128
//     output channels (snn/fused.py:plan_k3 decides).  Block b owns slice
//     b % slices and every (grid/slices)-th tile from b / slices for the
//     whole launch.  The membrane and ECS state of its items is the block's
//     own: in f32, in its shared memory for all T steps where the plan finds
//     room beside the window stages (the TPU kernel's scratch; 3-7 % faster
//     at the 20x20 sites), else, and in bf16 (whose state reads no faster
//     there), in an owner-only workspace [2, P, C] in device memory, as K1
//     and K2 keep it.
//     Step 1 reads no state (mem_0 = x_0, ecs = 0); the last step writes
//     none.
//   * Step 0: spike_0 = fire(x_0), written to out[0] (always dense).
//   * Step t >= 1, per 128-pixel run, K-chunk by K-chunk (64 input channels
//     in bf16, 32 in f32): the window of out[t-1] the run's 3x3 taps reach
//     comes into a 2-stage ring in shared memory (cp.async.cg in 16-byte
//     pieces, XOR-swizzled by the slot, where C % 8 == 0; else guarded
//     scalar L2 loads), and d = dw3x3(spike) + dwb is computed from it tap by
//     tap in the dtype:
//       bf16: on bf16 pairs (fma.rn.bf16x2 for Heaviside spikes, whose
//       products are exact; mul then add for SiLU) straight into the A
//       fragments of wgmma m64nNk16 (two warpgroups of 64 pixels), K in
//       channel order; B is the block's slice of pw, resident in shared
//       memory for the whole launch in the 128-byte swizzle, read once from
//       pw through its strides.  Two A register sets alternate, so the
//       depthwise pass of chunk k+1 overlaps the wgmma of chunk k.
//       float32: d into a [32][128] tile in shared memory (a tap outside the
//       image reads a slot of zeros) and a CUDA-core FMA product in full f32
//       against the chunk of pw, in wgmma's accumulator layout.
//     Epilogue in the accumulator's layout (a 4x4 transpose within each
//     quad: each lane holds 8 consecutive channels of one pixel): e =
//     rnd(acc) + pwb, then ecs, fecs, mem and spike; x read through its
//     strides, spike_{t-1} from out[t-1] through L2 (out is written by other
//     blocks in the launch), spike_t written to out[t].  bf16 runs the tail
//     on bf16 pairs; C % 8 != 0 or an x without unit channel stride takes a
//     scalar tail of the same arithmetic.
//
// What bounds it.  The function moves 2 * T*N*H*W*C elements (x in, spikes
// out; x once where it is a broadcast over T) and does
// (T-1)*N*H*W*(2*C*C + 18*C) operations: bytes up to C ~ 128 in bf16, the
// product beyond.  Beyond that this version pays the state round trip
// where it lives in the workspace, the window's halo (up to 3x a run's
// pixels from L2 at W >= 130), the depthwise pass repeated once per Cout
// slice, and the barriers.

#include "ecs_lif_common.cuh"

namespace {

constexpr int kThreads = 256;     // two warpgroups
constexpr int kTile = 128;        // pixels of a run: 64 rows a warpgroup
constexpr int kRun = kTile + 2;   // pixels of one row run of a window
constexpr int kSlot = 128;        // bytes of one window pixel slot (one K-chunk)
// f32: taps of the depthwise pass unrolled together (all nine spill the
// product's accumulators at slices of 64 and 128)
constexpr int kTapUnroll = 3;

template <typename T> struct Chunk;   // input channels of a K-chunk: 128 bytes
template <> struct Chunk<bf16> { static constexpr int K = 64; };
template <> struct Chunk<float> { static constexpr int K = 32; };

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
  void* ws;               // [2][P][C]: mem, ecs between steps (state in the workspace, T > 2)
  unsigned* bar;          // [2]: arrivals, generation
  long long P;            // N*H*W
  int Tn, H, W, C, slices, tiles, sub, shared_state, act;
  float thresh, decay, alpha, beta, leak;   // rounded to the dtype by the caller
};

// --- bf16: the depthwise pass on pairs, into the A fragments -----------------------

// d of the thread's rows r0, r0 + 8 and the 16 channels of chunk kc that its
// A fragments hold (quad_channel), tap by tap from zero on bf16 pairs, then
// + dwb, in the A fragments of the chunk's four k-steps.  A tap outside the
// image is skipped: the plain version adds +-0 there, which leaves d as it
// is (d is never -0: it starts at +0, and a rounded sum is -0 only when both
// addends are).
template <bool ACT>
__device__ __forceinline__ void d_frags(const uint8_t* win, const bf16* dw_s, const bf16* dwb_s,
                                        int kc, int cp, int S, int r0, int q,
                                        const uint32_t valid[2], uint32_t a[4][4]) {
  uint32_t d[2][8];
  #pragma unroll
  for (int h = 0; h < 2; ++h)
    #pragma unroll
    for (int i = 0; i < 8; ++i) d[h][i] = 0u;
  #pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const uint4 w0 = ldg<kPlain>(dw_s + tap * cp + kc * 64 + 16 * q);
    const uint4 w1 = ldg<kPlain>(dw_s + tap * cp + kc * 64 + 16 * q + 8);
    const uint32_t wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!((valid[h] >> tap) & 1u)) continue;
      const int slot = (tap / 3) * S + r0 + 8 * h + tap % 3;
      const uint8_t* row = win + slot * kSlot + 4 * q;
      #pragma unroll
      for (int i = 0; i < 8; ++i) {     // word q of piece i: channels 8i + 2q, +1
        const uint32_t sv = *reinterpret_cast<const uint32_t*>(row + ((i ^ (slot & 7)) << 4));
        d[h][i] = ACT ? hadd2(d[h][i], hmul2(sv, wv[i])) : hfma2(sv, wv[i], d[h][i]);
      }
    }
  }
  const uint4 b0 = ldg<kPlain>(dwb_s + kc * 64 + 16 * q);
  const uint4 b1 = ldg<kPlain>(dwb_s + kc * 64 + 16 * q + 8);
  const uint32_t bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  #pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = hadd2(d[0][2 * ks], bw[2 * ks]);
    a[ks][1] = hadd2(d[1][2 * ks], bw[2 * ks]);
    a[ks][2] = hadd2(d[0][2 * ks + 1], bw[2 * ks + 1]);
    a[ks][3] = hadd2(d[1][2 * ks + 1], bw[2 * ks + 1]);
  }
}

// one chunk: its A fragments, then four async k-steps into acc
template <int N>
__device__ __forceinline__ void chunk_mma(float* acc, uint32_t a[4][4], const uint8_t* win,
                                          const bf16* dw_s, const bf16* dwb_s, int kc, int cp,
                                          int S, int r0, int q, const uint32_t valid[2],
                                          uint64_t desc0, int act) {
  if (act)
    d_frags<true>(win, dw_s, dwb_s, kc, cp, S, r0, q, valid, a);
  else
    d_frags<false>(win, dw_s, dwb_s, kc, cp, S, r0, q, valid, a);
  wgmma_fence();
  #pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs<N>(acc, a[ks], desc0 + ((kc * N * 128 + ks * 32) >> 4));
  wgmma_commit();
}

// --- the epilogue, in the accumulator layout --------------------------------------------

// Element (row, channel cl) of a run's state in shared memory: rows of N
// channels, each row's groups of 8 channels (a lane's share of the
// epilogue) XOR-swizzled by the row, so that the 8 rows a quad column
// touches at once spread over the banks (unswizzled, a row is a multiple
// of 128 bytes and all 8 collide).
template <typename T, int N>
__device__ __forceinline__ int state_at(int row, int cl) {
  constexpr int GROUPS = N / 8, MASK = (GROUPS < 8 ? GROUPS : 8) - 1;
  return row * N + (((cl >> 3) ^ (row & MASK)) << 3) + (cl & 7);
}

// The run's tail of step t: ecs, mem and spike from acc; mem and ecs kept
// for the next step (none after the last) at sm/se, the run's state: its
// rows x N channels in shared memory (`shared`, at state_at), or the
// workspace's [P][C].
// `vec`: C % 8 == 0 and x read in runs, so each lane's 8 channels move in
// 16-byte pieces (bf16 on pairs); else element by element.
template <typename T, int N>
__device__ __forceinline__ void epilogue(const Params& p, const float* acc, int t, long long p0,
                                         int slice, const T* pwb_s, int r0, int q, T* sm,
                                         T* se, bool shared, bool vec) {
  constexpr int NS = N / 32;
  T* out = static_cast<T*>(p.out);
  const long long pc = p.P * p.C;
  const bool keep = t + 1 < p.Tn;
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const long long px = p0 + row;
    float a[NS][8];
    row_sets<N>(acc, h, q, a);           // every lane: it shuffles within the warp
    if (px >= p.P) continue;
    const T* xp = x_at<T>(p, px);
    // the state of (px, channel co) and its offset from that of channel co0
    auto state = [&](int cl, int co, T*& m, T*& e) {
      if (shared) {
        m = sm + state_at<T, N>(row, cl);
        e = se + state_at<T, N>(row, cl);
      } else {
        m = sm + px * p.C + co;
        e = se + px * p.C + co;
      }
    };
    if (vec) {
      if constexpr (sizeof(T) == 2) {
        const Pairs k2 = pairs(p);
        uint4 xr[NS], sr[NS], mr[NS], cr[NS];
        #pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int cl = 32 * s + 8 * q, co = slice * N + cl;
          if (co >= p.C) continue;
          T *m, *e;
          state(cl, co, m, e);
          xr[s] = ldg<kNc>(xp + t * p.xs_t + co);
          sr[s] = ldg<kCg>(out + (t - 1) * pc + px * p.C + co);
          if (t == 1) {                     // mem_0 = x_0, no field yet
            mr[s] = ldg<kNc>(xp + co);
            cr[s] = make_uint4(0u, 0u, 0u, 0u);
          } else {
            mr[s] = ldg<kPlain>(m);
            cr[s] = ldg<kPlain>(e);
          }
        }
        #pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int cl = 32 * s + 8 * q, co = slice * N + cl;
          if (co >= p.C) continue;
          T *m, *e;
          state(cl, co, m, e);
          const uint4 b = ldg<kPlain>(pwb_s + co);
          const uint32_t bw[4] = {b.x, b.y, b.z, b.w}, xw[4] = {xr[s].x, xr[s].y, xr[s].z, xr[s].w};
          uint32_t sw[4] = {sr[s].x, sr[s].y, sr[s].z, sr[s].w};
          uint32_t mw[4] = {mr[s].x, mr[s].y, mr[s].z, mr[s].w};
          uint32_t cw[4] = {cr[s].x, cr[s].y, cr[s].z, cr[s].w};
          #pragma unroll
          for (int j = 0; j < 4; ++j)
            finish2(pack_bf16x2(a[s][2 * j], a[s][2 * j + 1]), bw[j], cw[j], mw[j], sw[j], xw[j],
                    k2, p.thresh, p.act);
          *reinterpret_cast<uint4*>(out + t * pc + px * p.C + co) =
              make_uint4(sw[0], sw[1], sw[2], sw[3]);
          if (keep) {
            *reinterpret_cast<uint4*>(m) = make_uint4(mw[0], mw[1], mw[2], mw[3]);
            *reinterpret_cast<uint4*>(e) = make_uint4(cw[0], cw[1], cw[2], cw[3]);
          }
        }
      } else {
        #pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int cl = 32 * s + 8 * q, co = slice * N + cl;
          if (co >= p.C) continue;
          T *m, *e;
          state(cl, co, m, e);
          float bias[8], xv[8], mv[8], cv[8], sv[8];
          load8<kPlain>(pwb_s + co, bias);
          load8<kNc>(xp + t * p.xs_t + co, xv);
          load8<kCg>(out + (t - 1) * pc + px * p.C + co, sv);
          if (t == 1) {
            load8<kNc>(xp + co, mv);
            #pragma unroll
            for (int i = 0; i < 8; ++i) cv[i] = 0.f;
          } else {
            load8<kPlain>(m, mv);
            load8<kPlain>(e, cv);
          }
          #pragma unroll
          for (int i = 0; i < 8; ++i) finish<T>(a[s][i], bias[i], cv[i], mv[i], sv[i], xv[i], p);
          store8(out + t * pc + px * p.C + co, sv);
          if (keep) {
            store8(m, mv);
            store8(e, cv);
          }
        }
      }
    } else {
      #pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int cl = 32 * s + 8 * q, co = slice * N + cl;
        #pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (co + i >= p.C) continue;
          T *m, *e;
          state(cl + i, co + i, m, e);
          const long long oe = px * p.C + co + i;
          const float xv = ld1<kNc>(xp + t * p.xs_t + (co + i) * p.xs_c);
          float sv = ld1<kCg>(out + (t - 1) * pc + oe), mv, cv;
          if (t == 1) {
            mv = ld1<kNc>(xp + (co + i) * p.xs_c);
            cv = 0.f;
          } else {
            mv = ld1<kPlain>(m);
            cv = ld1<kPlain>(e);
          }
          finish<T>(a[s][i], ld1<kPlain>(pwb_s + co + i), cv, mv, sv, xv, p);
          st1(out + t * pc + oe, sv);
          if (keep) {
            st1(m, mv);
            st1(e, cv);
          }
        }
      }
    }
  }
}

// --- the kernel --------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1) ecs_lif_v2_kernel(const __grid_constant__ Params p) {
  constexpr int K = Chunk<T>::K;
  constexpr bool kMma = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // B starts on the swizzle's 1024-byte atom (the plan's 1024 bytes of slack)
  uint8_t* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int C = p.C;
  const long long pc = p.P * C;
  const int nk = (C + K - 1) / K, cp = nk * K;
  const int S = min(p.W, kRun), NS = 2 * S + kRun;
  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3;
  const int r0 = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + (lane >> 2);   // rows r0, r0 + 8
  const int slice = blockIdx.x % p.slices, per = gridDim.x / p.slices;
  const int j0 = blockIdx.x / p.slices;
  const int mine = j0 < p.tiles ? (p.tiles - 1 - j0) / per + 1 : 0;
  const int most = (p.tiles + per - 1) / per;      // items of the busiest block
  const int item = p.sub * kTile;                  // pixels of an item
  const bool vec = C % 8 == 0;                     // the window in 16-byte pieces
  const bool xvec = vec && p.x_vec;                // x, out and the state in runs
  const bool shared = p.shared_state;

  // shared memory (snn/fused.py:k3_smem): [B (bf16)] [2 windows] [As, Bs
  // (f32)] [dw 9 x cp] [dwb cp] [pwb cp] [a slot of zeros (f32)] [the state:
  // mem, ecs of `most` items x N channels (shared state)]
  uint8_t* bmat = base;
  uint8_t* win = base + (kMma ? nk * N * 128 : 0);
  uint8_t* rest = win + 2 * NS * kSlot;
  float* As = reinterpret_cast<float*>(rest);            // f32: d chunk [K][kTile]
  float* Bs = As + K * kTile;                            // f32: pw chunk [K][N]
  T* dw_s = reinterpret_cast<T*>(kMma ? rest : reinterpret_cast<uint8_t*>(Bs + K * N));
  T* dwb_s = dw_s + 9 * cp;
  T* pwb_s = dwb_s + cp;
  uint8_t* zero = reinterpret_cast<uint8_t*>(pwb_s + cp);
  T* st_mem = reinterpret_cast<T*>(zero + (kMma ? 0 : kSlot));
  T* st_ecs = st_mem + (long long)most * item * N;
  if (!shared) {
    st_mem = static_cast<T*>(p.ws);
    st_ecs = st_mem + pc;
  }

  const T* dw = static_cast<const T*>(p.dw);
  const T* dwb = static_cast<const T*>(p.dwb);
  const T* pwb = static_cast<const T*>(p.pwb);
  const T* pw = static_cast<const T*>(p.pw);
  // bf16: the depthwise weights and bias in quad_channel's order
  auto channel = [&](int i) { return kMma ? i / 64 * 64 + quad_channel(i % 64) : i; };
  for (int i = tid; i < 9 * cp; i += kThreads) {
    const int tap = i / cp, c = channel(i % cp);
    dw_s[i] = c < C ? dw[(tap / 3) * p.dw_sy + (tap % 3) * p.dw_sx + c * p.dw_sc] : T{};
  }
  for (int i = tid; i < cp; i += kThreads) {
    const int c = channel(i);
    dwb_s[i] = c < C ? dwb[c * p.dwb_s] : T{};
    pwb_s[i] = i < C ? pwb[i * p.pwb_s] : T{};
  }
  if constexpr (!kMma)
    for (int i = tid; i < kSlot / 4; i += kThreads) reinterpret_cast<uint32_t*>(zero)[i] = 0u;
  if constexpr (kMma) load_b<N>(p, bmat, slice, nk);
  __syncthreads();

  T* out = static_cast<T*>(p.out);

  // step 0: spike_0 = fire(x_0), the block's own items
  for (int m = 0; m < mine; ++m) {
    const long long p0 = (long long)(j0 + m * per) * item;
    if (xvec) {
      for (int g = tid; g < item * (N / 8); g += kThreads) {
        const long long px = p0 + g / (N / 8);
        const int co = slice * N + g % (N / 8) * 8;
        if (px >= p.P || co >= C) continue;
        float v[8];
        load8<kNc>(x_at<T>(p, px) + co, v);
        #pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = fire<T>(v[i], p.thresh, p.act);
        store8(out + px * C + co, v);
      }
    } else {
      for (int g = tid; g < item * N; g += kThreads) {
        const long long px = p0 + g / N;
        const int co = slice * N + g % N;
        if (px >= p.P || co >= C) continue;
        st1(out + px * C + co, fire<T>(ld1<kNc>(x_at<T>(p, px) + co * p.xs_c), p.thresh, p.act));
      }
    }
  }

  const uint32_t win_addr = smem_addr(win);
  const uint64_t desc0 = smem_desc_sw128(smem_addr(bmat));
  float acc[N / 2];
  uint32_t a0[4][4], a1[4][4];
  uint32_t valid[2] = {0u, 0u};
  const int runs = mine * p.sub, total = runs * nk;
  // the first pixel of run u (of the block's runs, in order)
  auto run_p0 = [&](int u) {
    return (long long)(j0 + u / p.sub * per) * item + (long long)(u % p.sub) * kTile;
  };
  auto stage = [&](int s) { return (s & 1) * NS * kSlot; };

  for (int t = 1; t < p.Tn; ++t) {
    grid_sync(p.bar);                    // out[t-1] is complete
    const T* prev = out + (t - 1) * pc;
    if (total > 0) load_window128<T>(prev, win_addr, win, run_p0(0), 0, p, S, NS, kRun, vec);
    cp_async_commit();
    #pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < total; ++s) {
      const int kc = s % nk, u = s / nk;
      const long long p0 = run_p0(u);
      __syncthreads();                   // stage (s + 1) & 1 is read by no one
      if (s + 1 < total)
        load_window128<T>(prev, win_addr + stage(s + 1), win + stage(s + 1), run_p0((s + 1) / nk),
                          (s + 1) % nk * K, p, S, NS, kRun, vec);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();                   // window s is in, for every thread
      const uint8_t* w = win + stage(s);
      if constexpr (kMma) {
        if (kc == 0) {
          valid[0] = tap_mask(p0 + r0, p);
          valid[1] = tap_mask(p0 + r0 + 8, p);
        }
        wgmma_wait<1>();                 // the k-steps that read this A set are done
        if (s & 1)
          chunk_mma<N>(acc, a1, w, dw_s, dwb_s, kc, cp, S, r0, q, valid, desc0, p.act);
        else
          chunk_mma<N>(acc, a0, w, dw_s, dwb_s, kc, cp, S, r0, q, valid, desc0, p.act);
      } else {
        const int r = tid & (kTile - 1), half = tid >> 7;
        if (kc == 0) valid[0] = tap_mask(p0 + r, p);
        if (p.act)
          depthwise_f32<true, kTile, kTapUnroll>(w, zero, reinterpret_cast<const float*>(dw_s) + kc * K, cp,
                                     reinterpret_cast<const float*>(dwb_s) + kc * K, S, r, half,
                                     valid[0], As);
        else
          depthwise_f32<false, kTile, kTapUnroll>(w, zero, reinterpret_cast<const float*>(dw_s) + kc * K, cp,
                                      reinterpret_cast<const float*>(dwb_s) + kc * K, S, r, half,
                                      valid[0], As);
        for (int i = tid; i < K * N; i += kThreads) {
          // read along the unit stride of pw where it has one
          const int k = p.pw_si == 1 ? i % K : i / N, n = p.pw_si == 1 ? i / K : i % N;
          const int ci = kc * K + k, co = slice * N + n;
          Bs[k * N + n] = ci < C && co < C ? pw[ci * p.pw_si + co * p.pw_so] : 0.f;
        }
        __syncthreads();
        #pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float x0 = As[k * kTile + r0], x1 = As[k * kTile + r0 + 8];
          #pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const float2 b = *reinterpret_cast<const float2*>(Bs + k * N + 8 * j + 2 * q);
            acc[4 * j] = fmaf(x0, b.x, acc[4 * j]);
            acc[4 * j + 1] = fmaf(x0, b.y, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(x1, b.x, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(x1, b.y, acc[4 * j + 3]);
          }
        }
      }
      if (kc == nk - 1) {
        if constexpr (kMma) {
          wgmma_wait<0>();
          #pragma unroll
          for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
        }
        // the run's state: its rows of the block's shared planes, or the workspace
        const long long so = shared ? (long long)u * kTile * N : 0;
        epilogue<T, N>(p, acc, t, p0, slice, pwb_s, r0, q, st_mem + so, st_ecs + so, shared, xvec);
        #pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      }
    }
  }
}

template <typename T, int N>
cudaError_t allow_smem(int smem) {
  static int allowed = 0;   // the dynamic shared memory this instance may take
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        ecs_lif_v2_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  return cudaSuccess;
}

template <typename T, int N>
cudaError_t launch(Params& prm, int grid, int smem, cudaStream_t st) {
  const cudaError_t e = allow_smem<T, N>(smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&prm};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ecs_lif_v2_kernel<T, N>),
                                     dim3(grid), dim3(kThreads), args, (size_t)smem, st);
}

template <typename T, int N>
int occupancy(int smem) {
  cudaError_t e = allow_smem<T, N>(smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ecs_lif_v2_kernel<T, N>, kThreads,
                                                      (size_t)smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

template <typename T>
cudaError_t dispatch(Params& prm, int n, int grid, int smem, cudaStream_t st) {
  switch (n) {
    case 32: return launch<T, 32>(prm, grid, smem, st);
    case 64: return launch<T, 64>(prm, grid, smem, st);
    case 128: return launch<T, 128>(prm, grid, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// a: 37 int64 values (snn/fused.py:ecs_lif_fused_v2): dtype (0 = float32,
// 1 = bfloat16), slice N, x, x's five strides (t, n, h, w, c), x_vec, out,
// dw and its dy/dx/c strides, dwb and its stride, pw, its ci/co strides and
// 16-byte mode, pwb and its stride, the workspace, the barrier buffer, T,
// N, H, W, C, slices, tiles (items of a slice), sub (128-pixel runs of an
// item), shared state (1: in shared memory), grid, shared memory bytes,
// act, stream.  k: thresh, decay, alpha, beta, leak, already rounded to the
// dtype.  Returns the launch's cudaError_t (0 = launched).
int ecs_lif_v2_fwd(const long long* a, const float* k) {
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
  prm.slices = (int)a[29]; prm.tiles = (int)a[30]; prm.sub = (int)a[31];
  prm.shared_state = (int)a[32];
  const int grid = (int)a[33], smem = (int)a[34];
  prm.act = (int)a[35];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a[36]);
  prm.P = images * prm.H * prm.W;
  prm.thresh = k[0]; prm.decay = k[1]; prm.alpha = k[2]; prm.beta = k[3]; prm.leak = k[4];
  if (prm.C <= 0 || prm.slices <= 0 || prm.sub <= 0 || grid < prm.slices ||
      grid % prm.slices || (long long)prm.slices * n < prm.C ||
      (long long)prm.tiles * prm.sub * kTile < prm.P || (prm.pw_vec && prm.C % 8) ||
      (prm.x_vec && prm.xs_c != 1))
    return (int)cudaErrorInvalidValue;
  if (prm.P == 0 || prm.Tn == 0) return (int)cudaSuccess;
  if (dtype == 0) return (int)dispatch<float>(prm, n, grid, smem, st);
  if (dtype == 1) return (int)dispatch<bf16>(prm, n, grid, smem, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the (dtype, slice N) instance one SM holds with `smem` bytes of
// dynamic shared memory; a negative cudaError_t on failure.
int ecs_lif_v2_occupancy(int dtype, int n, int smem) {
  if (dtype != 0 && dtype != 1) return -(int)cudaErrorInvalidValue;
  const bool b = dtype == 1;
  switch (n) {
    case 32: return b ? occupancy<bf16, 32>(smem) : occupancy<float, 32>(smem);
    case 64: return b ? occupancy<bf16, 64>(smem) : occupancy<float, 64>(smem);
    case 128: return b ? occupancy<bf16, 128>(smem) : occupancy<float, 128>(smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}

const char* ecs_lif_v2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
