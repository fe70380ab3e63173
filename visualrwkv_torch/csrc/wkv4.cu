// RWKV-4 ("x040") WKV recurrence on Hopper: the sequence forward K17
// (wkv4_fwd) and its VJP K18 (wkv4_bwd), each a chunked scan over T. Neither
// replaces a TPU kernel: the JAX package computes this recurrence with a
// lax.scan of elementwise ops (visualrwkv_tpu/ops/wkv4.py::wkv4), which XLA
// fuses into one loop, and differentiates the scan with autodiff. Plain C
// interface, loaded with ctypes by visualrwkv_torch/ops/wkv4_cuda.py.
//
// The recurrence is per channel, with a log-domain state (aa, bb, pp):
//   ww = u + k_t; p = max(pp, ww)
//   y_t = (e^{pp-p} aa + e^{ww-p} v_t) / (e^{pp-p} bb + e^{ww-p})
//   ww = w + pp; p = max(ww, k_t)
//   aa = e^{ww-p} aa + e^{k_t-p} v_t; bb = e^{ww-p} bb + e^{k_t-p}; pp = p
// with w = -exp(time_decay) <= 0. Every exponent is <= 0, so nothing
// overflows fp32 whatever k is (the max tracking).
//
// What bounded the first design. One thread a (b, c) walked all
// T steps: 2048 threads at B=1, 16 blocks of 128 on 16 of the 132
// multiprocessors, 4 warps each. A step carries only pp -> max(w + pp, k_t)
// and one fma, so its ~185 ns a step (K17 0.1956 ms at B=1 T=1056 C=2048)
// was the load of the next k and v at almost no occupancy; deeper prefetch
// rings were 7-26 % slower. K18 walked T twice with a workspace [B, T, 3, C]
// of recomputed states (26 MB at B=1, 104 MB at B=4: past the 50 MB L2) and
// took 0.8608 ms there.
//
// The chunked scan. A state (x, p) stands for x e^p. A chunk of L steps
// walked from the zero state (aa = bb = 0, pp = -1e30) has a summary
// (a, b, p): a e^p = sum_i e^{(L-1-i) w + k_i} v_i, b the same without v. A
// state entering the chunk leaves it as
//   p' = max(pp + L w, p); aa' = e^{pp+Lw-p'} aa + e^{p-p'} a; bb' likewise
// (every exponent <= 0; -1e30 absorbs L w), and summaries compose by the
// same map, associatively. K17: (i) each chunk's summary, (ii) a scan of the
// summaries along the chunks gives the state entering each chunk, (iii) each
// chunk replays its steps from that state with the step arithmetic above
// (expf, IEEE divide), writing y; the last chunk writes the final state. The
// walks of a chunk run in a frame where pp is relative to a reference near it
// (frame(), below): the step is invariant under that shift, and it keeps the
// rounding of w + pp on a fine grid when pp is large.
//
// K18. A step's reverse map is affine in the cotangent g = (gaa, gbb, gpp)
// of the state it leaves: g_before = M g_after + c, M = [[f1, 0, 0],
// [0, f1, 0], [m_a, m_b, m_p]] with m_p in {0, 1/2, 1} (the share of
// max(w + pp, k_t) that goes to w + pp, ties included) and c from dy and the
// forward values only; a product of such maps keeps the form (F, A, B, P; c).
// (i) The state entering each chunk, by K17's steps (i) and (ii), into a
// workspace [B, chunks, 3, C] (with one round, T <= 512, the states stay in
// shared memory, and k, v, dy are staged once); (ii) each chunk composes its map walking its
// steps forward from its entering state, keeping the states entering its
// steps in shared memory; (iii) a scan of the maps from the last chunk
// (exit cotangent ds, or zero) back to the first gives each chunk's exit
// cotangent; (iv) each chunk replays the reverse walk of the first design
// (autograd's derivative of every operation: the max's to the larger
// argument, half to each on a tie; the running max pp differentiated like
// any other value, so that a cotangent of the final pp is honoured),
// writing dk, dv and its sums of dw, du; the first chunk's walk gives ds0.
//
// Layout. A block owns one row b and a tile of 16 channels across all
// chunks of T. Lanes sit on channels (a half-warp a chunk slot: coalesced
// 64-byte rows), warps on chunks: thread (c, s) walks chunk slot s, and a
// block has `slots` of them (K17 at most 64: 1024 threads; K18 at most 32).
// A round is `slots` consecutive chunks; T longer than one round takes
// several, each entering with the state (K18 backward: the cotangent) the
// previous round's replay left. Each warp stages its own two chunks' k, v
// (K18: and dy) in shared memory with 16-byte cp.async (one element a lane
// where a tile or a row is not 16-byte aligned), so the walks wait on
// shared memory, not device memory; a slot's rows are padded to an odd
// count, so the two half-warps of a warp read different banks. The scans
// run over the slots' summaries (maps) in shared memory, a channel's slots
// on min(slots, 32) lanes of one warp (a warp takes as many channels at
// once as fit), lane-local then Kogge-Stone across the lanes with shuffles. At B=1
// T=1056 C=2048, K17 runs 128 blocks of 64 chunks of 17 steps (K18: 128 of
// 32 chunks of 11 steps, three rounds): every multiprocessor has work.
//
// K18's workspace holds chunk states only, [B, ceil(T/L), 3, C] fp32, and
// only where T takes more than one round: 96 x 3 x 2048 x 4 B = 2.25 MiB at
// B=1 T=1056 (L=11), 9 MiB at B=4; none at the v4 adapter's B=8 T=64 (one
// round of 8 chunks of 8). The states entering a chunk's steps live
// in shared memory for the chunk's walks only. dw and du are sums over B and
// T: each thread sums its chunks' terms, a block sums its slots in order and
// writes a row's partial, and the wrapper sums the rows: no atomics, the
// result does not depend on the order blocks run in.
//
// Why no tensor cores: WKV4 has no matrix product. Each channel has its own
// decay, so a chunk's sum is a per-channel Toeplitz matrix times a vector
// with nothing shared across channels for wgmma; what counts is keeping
// every multiprocessor busy, shared memory and asynchronous copies.
//
// Bound: the bytes (k, v read, y written; K18 also dy read, dk, dv written),
// K17 0.0078 ms and K18 0.0129 ms at B=1 T=1056 fp32 on an H100 (3.35
// TB/s). Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit,
// in turns with the first design (chip_ab.py wkv4): K17 0.0153 ms at B=1
// T=1056 C=2048 fp32 (was 0.1938), 0.0724 at B=4 (0.4823); K18 0.0600 ms
// at B=1 (0.8591), 0.2157 at B=4 (0.9954), 0.0285 at the v4 adapter's B=8
// T=64 (0.0499). K17 reads half its bound; K18 is bound by issuing its ~250
// instructions a step (both walks recompute each step's forward values).
//
// Arithmetic is fp32, each step as the plain version's (expf, IEEE divide;
// nvcc may contract a product and a sum into one fma) in the chunk's frame;
// the chunk states differ from the sequential walk's by rounding, and at
// k near 80 are closer to the float64 walk than the fp32 walk is.

#include "hopper_tiles.cuh"

#include <type_traits>

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr float PP_INIT = -1e30f;
constexpr int CH = 16;                // channels a block: a lane each, a half-warp
constexpr int SPW = 32 / CH;          // chunk slots a warp
constexpr int FWD_SLOTS = 1024 / CH;  // chunk slots a K17 block at most (1024 threads)
constexpr int BWD_SLOTS = 512 / CH;   // a K18 block (512 threads)
constexpr int MAX_S = FWD_SLOTS > 32 ? FWD_SLOTS / 32 : 1;  // slots a lane of a scan holds at most
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// the k, v element type of a dtype code: 0 float, 1 bf16
template <int DT>
using KV = std::conditional_t<DT == 1, __nv_bfloat16, float>;

template <typename X>
__device__ __forceinline__ X zero_of() {
  if constexpr (std::is_same_v<X, float>) {
    return 0.f;
  } else {
    return __float2bfloat16(0.f);
  }
}

// a chunk slot's rows in shared memory: the chunk length made odd
__host__ __device__ constexpr int padded(int L) { return L | 1; }

// Shared memory of a block (bytes). K17: summaries (a, b, p, d) [4][CH][slots
// + 1], the carry [3][CH], then k and v [slots][Lp][CH] in X. K18: the maps
// (F, A, B, P, ca, cb, cp) [7][CH][slots + 1], the carry, dy and the states
// entering each step (aa, bb, pp) [slots][Lp][CH] fp32, then k and v.
template <typename X>
__host__ __device__ constexpr size_t fwd_smem(int slots, int L) {
  return (size_t)4 * CH * (slots + 1) * 4 + 3 * CH * 4 + (size_t)2 * slots * padded(L) * CH * sizeof(X);
}
template <typename X>
__host__ __device__ constexpr size_t bwd_smem(int slots, int L) {
  return (size_t)7 * CH * (slots + 1) * 4 + 3 * CH * 4 +
         (size_t)slots * padded(L) * CH * (16 + 2 * sizeof(X));
}

// Copies `rows` steps of one [B, T, C] stream (src: its row b at the warp's
// first step, channel 0) at channels [c0, c0 + CH) into the warp's SPW chunk
// slots (dst: the first slot's row 0; step j of the warp goes to slot j / L,
// row j % L), by the 32 lanes of one warp. vec: 16-byte cp.async (the tile
// inside C, the rows 16-byte aligned); else one element a lane at a time,
// zero past C. The caller commits and waits.
template <typename X>
__device__ __forceinline__ void stage(X* dst, const X* __restrict__ src, int rows, int L, int Lp, int C,
                                      int c0, bool vec, int lane) {
  if (vec) {
    constexpr int PER = 16 / sizeof(X), PIECES = CH / PER;
    for (int q = lane; q < rows * PIECES; q += 32) {
      const int j = q / PIECES, part = q - j * PIECES;
      const int h = j / L;
      cp_async16(dst + ((h * Lp) + j - h * L) * CH + part * PER, src + (size_t)j * C + c0 + part * PER, true);
    }
  } else {
    for (int e = lane; e < rows * CH; e += 32) {
      const int j = e / CH, ch = e - j * CH;
      const int h = j / L;
      dst[((h * Lp) + j - h * L) * CH + ch] = c0 + ch < C ? src[(size_t)j * C + c0 + ch] : zero_of<X>();
    }
  }
}

// ------------------------------------------------------------ the forward scan

// A chunk's summary (a, b, p) and decay d = its length times w; a state is a
// summary whose d is never read.
struct Sum {
  float a, b, p, d;
};
__device__ __forceinline__ Sum sum_ident() { return {0.f, 0.f, PP_INIT, 0.f}; }

// x, then y. From dlt = (x.p - y.p) + y.d, x's decayed p against y's: a
// difference of two nearby values and a small one, so that the weights do
// not round on a large p's grid. p' = x.p + y.d where x wins, else y.p;
// every exponent <= 0; -1e30 absorbs d.
__device__ __forceinline__ Sum combine(Sum x, Sum y) {
  const float dlt = (x.p - y.p) + y.d;
  const float e1 = expf(fminf(dlt, 0.f)), e2 = expf(-fmaxf(dlt, 0.f));
  return {e1 * x.a + e2 * y.a, e1 * x.b + e2 * y.b, dlt > 0.f ? x.p + y.d : y.p, x.d + y.d};
}

// within segments of `width` lanes
__device__ __forceinline__ Sum shfl_up(Sum s, int off, int width) {
  return {__shfl_up_sync(FULL, s.a, off, width), __shfl_up_sync(FULL, s.b, off, width),
          __shfl_up_sync(FULL, s.p, off, width), __shfl_up_sync(FULL, s.d, off, width)};
}

// The walk of one chunk (`len` steps of the staged kr, vr, a row CH apart)
// from the zero state: its summary. It runs in the frame of the chunk's first
// k (see frame()).
template <typename X>
__device__ __forceinline__ Sum summarise(const X* kr, const X* vr, int len, float wc) {
  const float R = len > 0 ? to_f(kr[0]) : 0.f;
  float a = 0.f, b = 0.f, p = PP_INIT;
  for (int i = 0; i < len; ++i) {
    const float kt = to_f(kr[i * CH]) - R, vt = to_f(vr[i * CH]);
    const float ww = wc + p;
    const float pn = fmaxf(ww, kt);
    const float e1 = expf(ww - pn), e2 = expf(kt - pn);
    a = e1 * a + e2 * vt;
    b = e1 * b + e2;
    p = pn;
  }
  return {a, b, p + R, (float)len * wc};
}

// The reference R of a chunk's walk from its entering pp: max(pp, the
// chunk's first k). The step is invariant under pp -> pp - R, k -> k - R;
// walked so, pp stays near 0, where adding w rounds on a fine grid. Walked at
// pp ~ 80 (k near 80), every w + pp rounds on a 7.6e-6 grid, by the same
// fraction of it at every step of a channel, and the stored aa, bb drift with
// it: the sequential fp32 walk's final state is 3.3e-5 from the float64 walk
// there (relative RMS, B=1 T=1056 C=2048), the chunks' 2e-6.
__device__ __forceinline__ float frame(float pp, float k0) { return fmaxf(pp, k0); }

// The lanes of a scan: a channel's slots sit on nl = min(slots, 32)
// consecutive lanes, S = slots / nl a lane; a warp scans 32 / nl channels at
// once, one segment of nl lanes each, in log2(nl) shuffle levels.
struct ScanLanes {
  int S, nl, per, seg, sl;
  __device__ ScanLanes(int slots, int lane) {
    S = slots > 32 ? slots / 32 : 1;
    nl = slots / S;
    per = 32 / nl;
    seg = lane / nl;
    sl = lane - seg * nl;
  }
};

// The warps scan the channels: sm holds each slot's summary (a, b, p, d at
// sm + m * CH * (slots + 1) + c * (slots + 1) + slot; an inactive slot's is
// the identity); on return (a, b, p) hold the state entering each slot,
// from the carry (carry + m * CH + c). advance: the carry becomes the state
// past the round's last slot.
__device__ __forceinline__ void scan_fwd(float* sm, float* carry, int slots, int warp, int nwarps, int lane,
                                         bool advance) {
  const int R1 = slots + 1;
  const ScanLanes L(slots, lane);
  for (int c0 = warp * L.per; c0 < CH; c0 += nwarps * L.per) {
    const int c = c0 + L.seg;
    const bool on = c < CH;
    float* row = sm + (on ? c : 0) * R1;
    Sum el[MAX_S], x = sum_ident();
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      const int j = L.sl * L.S + s;
      el[s] = sum_ident();
      if (on && s < L.S && j < slots)
        el[s] = {row[j], row[CH * R1 + j], row[2 * CH * R1 + j], row[3 * CH * R1 + j]};
      x = s == 0 ? el[0] : combine(x, el[s]);
    }
    for (int off = 1; off < L.nl; off *= 2) {
      const Sum y = shfl_up(x, off, L.nl);
      if (L.sl >= off) x = combine(y, x);
    }
    Sum e = shfl_up(x, 1, L.nl);
    if (L.sl == 0) e = sum_ident();
    const Sum cin = on ? Sum{carry[c], carry[CH + c], carry[2 * CH + c], 0.f} : sum_ident();
    Sum st = combine(cin, e);
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      const int j = L.sl * L.S + s;
      if (on && s < L.S && j < slots) {
        row[j] = st.a;
        row[CH * R1 + j] = st.b;
        row[2 * CH * R1 + j] = st.p;
        st = combine(st, el[s]);
      }
    }
    if (advance) {
      const int last = L.nl - 1;
      const Sum total = combine(cin, {__shfl_sync(FULL, x.a, last, L.nl), __shfl_sync(FULL, x.b, last, L.nl),
                                      __shfl_sync(FULL, x.p, last, L.nl), __shfl_sync(FULL, x.d, last, L.nl)});
      __syncwarp();
      if (L.sl == 0 && on) {
        carry[c] = total.a;
        carry[CH + c] = total.b;
        carry[2 * CH + c] = total.p;
      }
    }
  }
}

// The block's common frame: its row, channel tile, thread's slot and lane,
// the chunk geometry.
struct Frame {
  int lane, warp, nwarps, ch, slot, slots, b, c0, c, chunks, rounds, Lp;
  bool live;
  __device__ Frame(int T, int C, int L) {
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    nwarps = blockDim.x >> 5;
    ch = threadIdx.x % CH;
    slot = threadIdx.x / CH;
    slots = blockDim.x / CH;
    b = blockIdx.y;
    c0 = blockIdx.x * CH;
    c = c0 + ch;
    live = c < C;
    chunks = T > 0 ? (T + L - 1) / L : 0;
    rounds = (chunks + slots - 1) / slots;
    Lp = padded(L);
  }
};

// The initial state (or the zero state) into the carry, by the slot-0 threads.
__device__ __forceinline__ void load_carry(float* carry, const float* __restrict__ s, const Frame& f, int C,
                                           float pp_default) {
  if (f.slot == 0) {
    const bool has = s != nullptr && f.live;
    const size_t o = ((size_t)f.b * C + f.c) * 3;
    carry[f.ch] = has ? s[o] : 0.f;
    carry[CH + f.ch] = has ? s[o + 1] : 0.f;
    carry[2 * CH + f.ch] = has ? s[o + 2] : pp_default;
  }
}

// Round r's rows of k, v (and of dy where it is not null) for the warp's
// chunk slots, staged into kst, vst (dyst) and waited for by the warp.
template <typename X>
__device__ __forceinline__ void stage_round(const Frame& f, int r, int T, int C, int L, bool vec,
                                            const X* __restrict__ k, const X* __restrict__ v,
                                            const float* __restrict__ dy, X* kst, X* vst, float* dyst) {
  const int t0 = (r * f.slots + SPW * f.warp) * L;  // the warp's first step
  const int rows = max(0, min(SPW * L, T - t0));
  const size_t src = ((size_t)f.b * T + t0) * C;
  const int dst = SPW * f.warp * f.Lp * CH;
  __syncwarp();
  stage(kst + dst, k + src, rows, L, f.Lp, C, f.c0, vec, f.lane);
  stage(vst + dst, v + src, rows, L, f.Lp, C, f.c0, vec, f.lane);
  if (dy != nullptr) stage(dyst + dst, dy + src, rows, L, f.Lp, C, f.c0, vec, f.lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
}

// K17: k, v [B, T, C] in KV<DT>; w, u fp32 [C]; s0 (may be null) and s_out
// fp32 [B, C, 3] (aa, bb, pp); y fp32 [B, T, C]. A block (CH x slots
// threads) a (channel tile, b); chunks of L steps.
template <int DT>
__global__ void __launch_bounds__(CH* FWD_SLOTS, 1) wkv4_chunk_fwd_kernel(
    int T, int C, int L, int vec, const float* __restrict__ w, const float* __restrict__ u,
    const KV<DT>* __restrict__ k, const KV<DT>* __restrict__ v, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_out) {
  using X = KV<DT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Frame f(T, C, L);
  const int R1 = f.slots + 1, Lp = f.Lp;
  float* sm = reinterpret_cast<float*>(smem_raw);  // [4][CH][R1]
  float* carry = sm + 4 * CH * R1;                 // [3][CH]
  X* kst = reinterpret_cast<X*>(carry + 3 * CH);   // [slots][Lp][CH]
  X* vst = kst + f.slots * Lp * CH;
  const float wc = f.live ? w[f.c] : 0.f, uc = f.live ? u[f.c] : 0.f;
  const bool tile_vec = vec && f.c0 + CH <= C;
  const size_t row0 = (size_t)f.b * T;
  const int si = f.ch * R1 + f.slot;
  load_carry(carry, s0, f, C, PP_INIT);

  for (int r = 0; r < f.rounds; ++r) {
    stage_round(f, r, T, C, L, tile_vec, k, v, (const float*)nullptr, kst, vst, (float*)nullptr);
    const int n = r * f.slots + f.slot;
    const int len = n < f.chunks ? min(L, T - n * L) : 0;
    const X* kr = kst + f.slot * Lp * CH + f.ch;
    const X* vr = vst + f.slot * Lp * CH + f.ch;
    // (i) the chunk's summary
    const Sum s = summarise(kr, vr, len, wc);
    sm[si] = s.a;
    sm[CH * R1 + si] = s.b;
    sm[2 * CH * R1 + si] = s.p;
    sm[3 * CH * R1 + si] = s.d;
    __syncthreads();
    // (ii) the state entering each chunk of the round
    scan_fwd(sm, carry, f.slots, f.warp, f.nwarps, f.lane, false);
    __syncthreads();
    // (iii) the replay from it, writing y
    if (len > 0) {
      float aa = sm[si], bb = sm[CH * R1 + si], pp = sm[2 * CH * R1 + si];
      const float R = frame(pp, to_f(kr[0]));
      pp -= R;
      float* yp = y + (row0 + (size_t)n * L) * C + f.c;
      for (int i = 0; i < len; ++i) {
        const float kt = to_f(kr[i * CH]) - R, vt = to_f(vr[i * CH]);
        // output first: the bonus u applies to the current token only
        float ww = uc + kt;
        float p = fmaxf(pp, ww);
        float e1 = expf(pp - p);
        float e2 = expf(ww - p);
        if (f.live) yp[(size_t)i * C] = (e1 * aa + e2 * vt) / (e1 * bb + e2);
        // then decay and accumulate
        ww = wc + pp;
        p = fmaxf(ww, kt);
        e1 = expf(ww - p);
        e2 = expf(kt - p);
        aa = e1 * aa + e2 * vt;
        bb = e1 * bb + e2;
        pp = p;
      }
      pp += R;
      if (n == f.chunks - 1) {
        if (f.live) {
          const size_t o = ((size_t)f.b * C + f.c) * 3;
          s_out[o] = aa;
          s_out[o + 1] = bb;
          s_out[o + 2] = pp;
        }
      } else if (f.slot == f.slots - 1) {  // the next round's carry
        carry[f.ch] = aa;
        carry[CH + f.ch] = bb;
        carry[2 * CH + f.ch] = pp;
      }
    }
  }
  if (f.chunks == 0 && f.slot == 0 && f.live) {  // T = 0: the entering state
    const size_t o = ((size_t)f.b * C + f.c) * 3;
    s_out[o] = carry[f.ch];
    s_out[o + 1] = carry[CH + f.ch];
    s_out[o + 2] = carry[2 * CH + f.ch];
  }
}

// ----------------------------------------------------------- the reverse scan

// The affine map g -> M g + c of a chunk's reverse walk, M = [[F, 0, 0],
// [0, F, 0], [A, Bm, P]].
struct Aff {
  float F, A, Bm, P, ca, cb, cp;
};
__device__ __forceinline__ Aff aff_ident() { return {1.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f}; }

// q after y: g -> q(y(g))
__device__ __forceinline__ Aff compose(const Aff& q, const Aff& y) {
  return {q.F * y.F,          q.A * y.F + q.P * y.A,
          q.Bm * y.F + q.P * y.Bm, q.P * y.P,
          q.F * y.ca + q.ca,  q.F * y.cb + q.cb,
          q.A * y.ca + q.Bm * y.cb + q.P * y.cp + q.cp};
}

struct G3 {
  float a, b, p;
};
__device__ __forceinline__ G3 apply(const Aff& m, G3 g) {
  return {m.F * g.a + m.ca, m.F * g.b + m.cb, m.A * g.a + m.Bm * g.b + m.P * g.p + m.cp};
}

// within segments of `width` lanes
__device__ __forceinline__ Aff shfl_down(const Aff& m, int off, int width) {
  return {__shfl_down_sync(FULL, m.F, off, width),  __shfl_down_sync(FULL, m.A, off, width),
          __shfl_down_sync(FULL, m.Bm, off, width), __shfl_down_sync(FULL, m.P, off, width),
          __shfl_down_sync(FULL, m.ca, off, width), __shfl_down_sync(FULL, m.cb, off, width),
          __shfl_down_sync(FULL, m.cp, off, width)};
}

// The warps scan the channels (ScanLanes): mp holds each slot's map (field
// m at mp + m * CH * (slots + 1) + c * (slots + 1) + slot; an inactive
// slot's is the identity); on return fields 4..6 hold each slot's exit
// cotangent, from the carry (the cotangent leaving the round's last slot).
__device__ __forceinline__ void scan_bwd(float* mp, const float* carry, int slots, int warp, int nwarps,
                                         int lane) {
  const int R1 = slots + 1;
  const ScanLanes L(slots, lane);
  for (int c0 = warp * L.per; c0 < CH; c0 += nwarps * L.per) {
    const int c = c0 + L.seg;
    const bool on = c < CH;
    float* row = mp + (on ? c : 0) * R1;
    Aff el[MAX_S], q = aff_ident();
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      const int j = L.sl * L.S + s;
      el[s] = aff_ident();
      if (on && s < L.S && j < slots)
        el[s] = {row[j],           row[CH * R1 + j],     row[2 * CH * R1 + j], row[3 * CH * R1 + j],
                 row[4 * CH * R1 + j], row[5 * CH * R1 + j], row[6 * CH * R1 + j]};
      q = s == 0 ? el[0] : compose(q, el[s]);
    }
    for (int off = 1; off < L.nl; off *= 2) {
      const Aff y = shfl_down(q, off, L.nl);
      if (L.sl + off < L.nl) q = compose(q, y);
    }
    Aff e = shfl_down(q, 1, L.nl);
    if (L.sl == L.nl - 1) e = aff_ident();
    G3 g = apply(e, on ? G3{carry[c], carry[CH + c], carry[2 * CH + c]} : G3{0.f, 0.f, 0.f});
#pragma unroll
    for (int s = MAX_S - 1; s >= 0; --s) {
      const int j = L.sl * L.S + s;
      if (on && s < L.S && j < slots) {
        row[4 * CH * R1 + j] = g.a;
        row[5 * CH * R1 + j] = g.b;
        row[6 * CH * R1 + j] = g.p;
        g = apply(el[s], g);
      }
    }
  }
}

// K18: the VJP of K17. (The explicit minimum of one block a multiprocessor
// matters: with the bound on threads alone, ptxas (CUDA 12.8) held this
// kernel to 64 registers and spilled 4 and 12 bytes; with it, none spills.)
// k, v [B, T, C] in KV<DT>; w, u fp32 [C]; s0 (may be
// null) fp32 [B, C, 3]; dy fp32 [B, T, C]; ds (may be null: a zero
// cotangent) fp32 [B, C, 3], the final state's cotangent; ws fp32 workspace
// [B, chunks, 3, C], the state entering each chunk. Writes dk, dv fp32
// [B, T, C], the per-row partial sums dw_part, du_part fp32 [B, C], and,
// when ds0 is not null, ds0 fp32 [B, C, 3].
template <int DT>
__global__ void __launch_bounds__(CH* BWD_SLOTS, 1) wkv4_chunk_bwd_kernel(
    int T, int C, int L, int vec, const float* __restrict__ w, const float* __restrict__ u,
    const KV<DT>* __restrict__ k, const KV<DT>* __restrict__ v, const float* __restrict__ s0,
    const float* __restrict__ dy, const float* __restrict__ ds, float* __restrict__ ws,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw_part,
    float* __restrict__ du_part, float* __restrict__ ds0) {
  using X = KV<DT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Frame f(T, C, L);
  const int R1 = f.slots + 1, Lp = f.Lp, SL = f.slots * Lp * CH;
  float* mp = reinterpret_cast<float*>(smem_raw);  // [7][CH][R1]
  float* carry = mp + 7 * CH * R1;                 // [3][CH]
  float* dyst = carry + 3 * CH;                    // [slots][Lp][CH] each: dy, aa, bb, pp
  float* sta = dyst + SL;
  float* stb = sta + SL;
  float* stp = stb + SL;
  X* kst = reinterpret_cast<X*>(stp + SL);  // [slots][Lp][CH] each: k, v
  X* vst = kst + SL;
  const float wc = f.live ? w[f.c] : 0.f, uc = f.live ? u[f.c] : 0.f;
  const bool tile_vec = vec && f.c0 + CH <= C;
  const size_t row0 = (size_t)f.b * T;
  const int si = f.ch * R1 + f.slot, own = f.slot * Lp * CH + f.ch;
  const X* kr = kst + own;
  const X* vr = vst + own;
  float* wsb = ws + (size_t)f.b * f.chunks * 3 * C + f.c;
  // one round: the backward reuses the staged rows and the entering states
  // left in shared memory, without the workspace
  const bool one = f.rounds == 1;
  load_carry(carry, s0, f, C, PP_INIT);

  // (i) the state entering each chunk: K17's summaries and scan, into ws
  for (int r = 0; r < f.rounds; ++r) {
    stage_round(f, r, T, C, L, tile_vec, k, v, one ? dy : nullptr, kst, vst, dyst);
    const int n = r * f.slots + f.slot;
    const int len = n < f.chunks ? min(L, T - n * L) : 0;
    const Sum s = summarise(kr, vr, len, wc);
    mp[si] = s.a;
    mp[CH * R1 + si] = s.b;
    mp[2 * CH * R1 + si] = s.p;
    mp[3 * CH * R1 + si] = s.d;
    __syncthreads();
    scan_fwd(mp, carry, f.slots, f.warp, f.nwarps, f.lane, true);
    __syncthreads();
    if (len > 0 && f.live && !one) {
      float* o = wsb + (size_t)n * 3 * C;
      o[0] = mp[si];
      o[C] = mp[CH * R1 + si];
      o[2 * (size_t)C] = mp[2 * CH * R1 + si];
    }
  }
  // the cotangent leaving the last round: ds, or zero (the carry is read by
  // the last scan above before the barrier that ended it)
  load_carry(carry, ds, f, C, 0.f);

  float gw = 0.f, gu = 0.f;
  for (int r = f.rounds - 1; r >= 0; --r) {
    if (!one) stage_round(f, r, T, C, L, tile_vec, k, v, dy, kst, vst, dyst);
    const int n = r * f.slots + f.slot;
    const int len = n < f.chunks ? min(L, T - n * L) : 0;
    const float* gr = dyst + own;
    // (ii) the chunk's map, walking forward from its entering state
    Aff m = aff_ident();
    float R = 0.f;  // the chunk's frame, walks (ii) and (iv)
    if (len > 0) {
      float aa = 0.f, bb = 0.f, pp = PP_INIT;
      if (one) {
        aa = mp[si];
        bb = mp[CH * R1 + si];
        pp = mp[2 * CH * R1 + si];
      } else if (f.live) {
        const float* o = wsb + (size_t)n * 3 * C;
        aa = o[0];
        bb = o[C];
        pp = o[2 * (size_t)C];
      }
      R = frame(pp, to_f(kr[0]));
      pp -= R;
      for (int i = 0; i < len; ++i) {
        const int o = i * CH;
        sta[own + o] = aa;
        stb[own + o] = bb;
        stp[own + o] = pp;
        const float kt = to_f(kr[o]) - R, vt = to_f(vr[o]), gy = gr[o];
        const float ww = uc + kt;
        const float p = fmaxf(pp, ww);
        const float e1 = expf(pp - p);
        const float e2 = expf(ww - p);
        const float den = e1 * bb + e2;
        const float y = (e1 * aa + e2 * vt) / den;
        const float ww2 = wc + pp;
        const float p2 = fmaxf(ww2, kt);
        const float f1 = expf(ww2 - p2);
        const float f2 = expf(kt - p2);
        const float gnum = gy / den;
        const float gden = -gy * y / den;
        const float b1 = (gnum * aa + gden * bb) * e1, b2 = (gnum * vt + gden) * e2;
        const float beta = pp > ww ? 1.f : ww > pp ? 0.f : 0.5f;
        const float alpha = ww2 > kt ? 1.f : kt > ww2 ? 0.f : 0.5f;
        const float sca = gnum * e1, scb = gden * e1, scp = b1 - beta * (b1 + b2);
        const float ma = (1.f - alpha) * f1 * aa - alpha * f2 * vt;
        const float mb = (1.f - alpha) * f1 * bb - alpha * f2;
        // c += P c_t, then P = P M_t
        m.ca += m.F * sca;
        m.cb += m.F * scb;
        m.cp += m.A * sca + m.Bm * scb + m.P * scp;
        m.A = m.A * f1 + m.P * ma;
        m.Bm = m.Bm * f1 + m.P * mb;
        m.P *= alpha;
        m.F *= f1;
        aa = f1 * aa + f2 * vt;
        bb = f1 * bb + f2;
        pp = p2;
      }
    }
    mp[si] = m.F;
    mp[CH * R1 + si] = m.A;
    mp[2 * CH * R1 + si] = m.Bm;
    mp[3 * CH * R1 + si] = m.P;
    mp[4 * CH * R1 + si] = m.ca;
    mp[5 * CH * R1 + si] = m.cb;
    mp[6 * CH * R1 + si] = m.cp;
    __syncthreads();
    // (iii) each chunk's exit cotangent
    scan_bwd(mp, carry, f.slots, f.warp, f.nwarps, f.lane);
    __syncthreads();
    // (iv) the reverse walk from it
    if (len > 0) {
      float gaa = mp[4 * CH * R1 + si], gbb = mp[5 * CH * R1 + si], gpp = mp[6 * CH * R1 + si];
      float* dkp = dk + (row0 + (size_t)n * L) * C + f.c;
      float* dvp = dv + (row0 + (size_t)n * L) * C + f.c;
      for (int i = len - 1; i >= 0; --i) {
        const int o = i * CH;
        const float kt = to_f(kr[o]) - R, vt = to_f(vr[o]), gy = gr[o];
        const float aa = sta[own + o], bb = stb[own + o], pp = stp[own + o];
        // the step's forward values
        const float ww = uc + kt;
        const float p = fmaxf(pp, ww);
        const float e1 = expf(pp - p);
        const float e2 = expf(ww - p);
        const float num = e1 * aa + e2 * vt;
        const float den = e1 * bb + e2;
        const float y = num / den;
        const float ww2 = wc + pp;
        const float p2 = fmaxf(ww2, kt);
        const float f1 = expf(ww2 - p2);
        const float f2 = expf(kt - p2);
        // the update aa' = f1 aa + f2 v, bb' = f1 bb + f2, pp' = p2
        const float gf1 = gaa * aa + gbb * bb;
        const float gf2 = gaa * vt + gbb;
        float naa = gaa * f1, nbb = gbb * f1, gv = gaa * f2;
        const float a1 = gf1 * f1, a2 = gf2 * f2;
        float gww2 = a1, gk = a2;
        const float gp2 = gpp - a1 - a2;
        if (ww2 > kt) {
          gww2 += gp2;
        } else if (kt > ww2) {
          gk += gp2;
        } else {
          gww2 += 0.5f * gp2;
          gk += 0.5f * gp2;
        }
        gw += gww2;
        float npp = gww2;
        // the output y = num / den
        const float gnum = gy / den;
        const float gden = -gy * y / den;
        const float ge1 = gnum * aa + gden * bb;
        const float ge2 = gnum * vt + gden;
        naa += gnum * e1;
        nbb += gden * e1;
        gv += gnum * e2;
        const float b1 = ge1 * e1, b2 = ge2 * e2;
        npp += b1;
        float gww = b2;
        const float gp = -b1 - b2;
        if (pp > ww) {
          npp += gp;
        } else if (ww > pp) {
          gww += gp;
        } else {
          npp += 0.5f * gp;
          gww += 0.5f * gp;
        }
        gu += gww;
        gk += gww;
        if (f.live) {
          dkp[(size_t)i * C] = gk;
          dvp[(size_t)i * C] = gv;
        }
        gaa = naa;
        gbb = nbb;
        gpp = npp;
      }
      if (f.slot == 0) {  // the cotangent entering the round: the previous round's carry, or ds0
        carry[f.ch] = gaa;
        carry[CH + f.ch] = gbb;
        carry[2 * CH + f.ch] = gpp;
      }
    }
  }
  // ds0, and dw, du summed over the block's slots in order
  __syncthreads();
  mp[si] = gw;
  mp[CH * R1 + si] = gu;
  __syncthreads();
  if (f.slot == 0 && f.live) {
    float sw = 0.f, su = 0.f;
    for (int j = 0; j < f.slots; ++j) {
      sw += mp[f.ch * R1 + j];
      su += mp[CH * R1 + f.ch * R1 + j];
    }
    dw_part[(size_t)f.b * C + f.c] = sw;
    du_part[(size_t)f.b * C + f.c] = su;
    if (ds0 != nullptr) {
      const size_t o = ((size_t)f.b * C + f.c) * 3;
      ds0[o] = carry[f.ch];
      ds0[o + 1] = carry[CH + f.ch];
      ds0[o + 2] = carry[2 * CH + f.ch];
    }
  }
}

bool pow2_slots(int slots, int most) {
  return slots >= SPW && slots <= most && (slots & (slots - 1)) == 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int DT>
int launch_fwd(int slots, int L, int B, int T, int C, const float* w, const float* u, const void* k,
               const void* v, const float* s0, float* y, float* s_out, cudaStream_t st) {
  using X = KV<DT>;
  const auto kernel = wkv4_chunk_fwd_kernel<DT>;
  const size_t smem = fwd_smem<X>(slots, L);
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e != 0) return e;
  const int vec = C % (16 / (int)sizeof(X)) == 0 && aligned16(k) && aligned16(v);
  const dim3 grid((C + CH - 1) / CH, B);
  kernel<<<grid, CH * slots, smem, st>>>(T, C, L, vec, w, u, (const X*)k, (const X*)v, s0, y, s_out);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_bwd(int slots, int L, int B, int T, int C, const float* w, const float* u, const void* k,
               const void* v, const float* s0, const float* dy, const float* ds, float* ws, float* dk,
               float* dv, float* dw_part, float* du_part, float* ds0, cudaStream_t st) {
  using X = KV<DT>;
  const auto kernel = wkv4_chunk_bwd_kernel<DT>;
  const size_t smem = bwd_smem<X>(slots, L);
  static hopper_host::SmemOptIn opt_in;
  const int e = opt_in(kernel, smem);
  if (e != 0) return e;
  const int vec = C % (16 / (int)sizeof(X)) == 0 && aligned16(k) && aligned16(v) && aligned16(dy);
  const dim3 grid((C + CH - 1) / CH, B);
  kernel<<<grid, CH * slots, smem, st>>>(T, C, L, vec, w, u, (const X*)k, (const X*)v, s0, dy, ds, ws, dk,
                                          dv, dw_part, du_part, ds0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vrwkv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shared memory of a block: kernel 0 K17, 1 K18; dtype of k, v; chunk slots
// a block; chunk length. -1 for an unknown kernel or dtype.
long wkv4_smem_bytes(int kernel, int dtype, int slots, int chunk) {
  if (dtype != 0 && dtype != 1) return -1;
  if (kernel == 0) return (long)(dtype ? fwd_smem<__nv_bfloat16>(slots, chunk) : fwd_smem<float>(slots, chunk));
  if (kernel == 1) return (long)(dtype ? bwd_smem<__nv_bfloat16>(slots, chunk) : bwd_smem<float>(slots, chunk));
  return -1;
}

// K17: k, v [B, T, C] fp32 (dtype 0) or bf16 (1); w, u fp32 [C]; s0 (may be
// null: aa = bb = 0, pp = -1e30) and s_out fp32 [B, C, 3]; y fp32 [B, T, C];
// slots = chunk slots a block (a power of 2, 2..64: 16 threads each, CH), chunk =
// steps a chunk (>= 1; the block's shared memory at most 227 KB).
int wkv4_fwd(int dtype, int slots, int chunk, int B, int T, int C, const float* w, const float* u,
             const void* k, const void* v, const float* s0, float* y, float* s_out, void* stream) {
  if (B <= 0 || B > 65535 || T < 0 || C <= 0 || chunk <= 0 || !pow2_slots(slots, FWD_SLOTS))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_fwd<0>(slots, chunk, B, T, C, w, u, k, v, s0, y, s_out, st);
  if (dtype == 1) return launch_fwd<1>(slots, chunk, B, T, C, w, u, k, v, s0, y, s_out, st);
  return (int)cudaErrorInvalidValue;
}

// K18: k, v [B, T, C] fp32 (dtype 0) or bf16 (1); w, u fp32 [C]; s0 and ds
// (each may be null) fp32 [B, C, 3]; dy fp32 [B, T, C]; ws fp32 [B,
// ceil(T / chunk), 3, C] (scratch); dk, dv fp32 [B, T, C]; dw_part, du_part
// fp32 [B, C]; ds0 (may be null) fp32 [B, C, 3]; slots a power of 2, 2..32;
// chunk as wkv4_fwd.
int wkv4_bwd(int dtype, int slots, int chunk, int B, int T, int C, const float* w, const float* u,
             const void* k, const void* v, const float* s0, const float* dy, const float* ds, float* ws,
             float* dk, float* dv, float* dw_part, float* du_part, float* ds0, void* stream) {
  if (B <= 0 || B > 65535 || T < 0 || C <= 0 || chunk <= 0 || !pow2_slots(slots, BWD_SLOTS))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<0>(slots, chunk, B, T, C, w, u, k, v, s0, dy, ds, ws, dk, dv, dw_part, du_part, ds0, st);
  if (dtype == 1)
    return launch_bwd<1>(slots, chunk, B, T, C, w, u, k, v, s0, dy, ds, ws, dk, dv, dw_part, du_part, ds0, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
