// R1-R3 and M1: the feedback loops of the delay, the two algorithmic
// reverbs and the flanger for Hopper (sm_90a).
//
// Replace the per-sample and blocked `lax.scan`s of the JAX package,
// which have no Pallas kernel:
//   R1  effects/delay_effect.py (Delay: _sample_scan :72-91, the two
//       blocked tiers :93-157);
//   R2  effects/reverb/freeverb.py (Freeverb: _sample_scan :121-151,
//       _block_step :82-119);
//   R3  effects/reverb/fdn.py (FDNReverb: _sample_scan :222-253,
//       _block_step :166-220);
//   M1  effects/modulation/modulation.py (Flanger: _sample_scan :233-252,
//       the blocked scan of process :254-299).
//
// Each kernel walks the reference's per-sample recurrence in place on the
// ring buffers the JAX package keeps as state. R1, R2 and M1 take one warp
// a channel, four channels a block. Every feedback read lags at least 40
// samples (R1, a chunk at a time: a chunk with a shorter lag walks on one
// lane) or 225 (R2), so the 32 samples of a chunk run on the 32 lanes at
// once: all lanes load, then all store, and only a chunk's one-pole
// dampings walk its samples in order (lanes 0-7, one comb each). R3 reads
// lag at least the shortest FDN line, longer than the reference's block:
// it takes a block a channel and a whole stretch of up to a block a pass
// (its section below). M1's lag never drops below max(base delay, 1 sample): a
// chunk where no sample reads a slot an earlier sample of the chunk
// writes runs on its lanes, any other (lags under ~0.7 ms) on one lane
// in order. The bound of all four at the chain's shapes is the dependent
// walk, not the bytes (a few per sample and ring slot). The blocked tiers of the reference
// compute the same per-sample expressions; where they form a read
// position, a fractional part or an LFO phase differently (a linear index
// instead of the ring's, the phase from the block's start instead of
// accumulated), the kernel takes the form of the tier the reference runs
// for that stretch of the call, so both round alike. sin, floor and fmod are the full-precision
// library functions; the source is built with -fmad=false
// (_build.EXTRA_FLAGS), so every product and sum rounds by itself, as in
// the plain versions (ops/feedback.py). float and double.

#include <cuda_runtime.h>

#include <cstdint>

// The kernels sit outside any namespace so that a profiler names them as
// they are written here.
constexpr int kWarp = 32;
constexpr int kWarps = 4;          // channels (warps) a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDelayBlock = 128;   // the reference Delay's block
constexpr int kMinParallelLag = 40;  // R1: a chunk whose lags all reach this
                                     // runs on 32 lanes (> 32 + 1 + rounding)

__device__ __forceinline__ float floor_of(float v) { return floorf(v); }
__device__ __forceinline__ double floor_of(double v) { return floor(v); }
__device__ __forceinline__ float fmod_of(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_of(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float sin_of(float v) { return sinf(v); }
__device__ __forceinline__ double sin_of(double v) { return sin(v); }

// jnp.mod / torch.remainder of floats: fmod, moved into the divisor's sign
template <typename T>
__device__ __forceinline__ T py_mod(T a, T b) {
  T r = fmod_of(a, b);
  if (r != T(0) && ((r < T(0)) != (b < T(0)))) r += b;
  return r;
}

__device__ __forceinline__ long long imod(long long a, long long b) {
  const long long r = a % b;
  return r < 0 ? r + b : r;
}

// ---------------------------------------------------------------------------
// R1: the feedback delay
// ---------------------------------------------------------------------------

template <typename T>
struct DelayParams {
  T fb, mix, dry;  // dry = (T)(1 - mix), rounded from double as the reference
  int L;
  long long N;
};

// A stretch [k0, k1) of the call in one of the reference's three forms.
//   form 0: the per-sample scan: pos = mod(float(v) - cur, L), v = v0 + kk
//           unreduced;
//   form 1: the aligned ring blocks: v = (v0 + kk) mod L;
//   form 2: the linear extension: pos = float(L + kk) - cur, at linear
//           index i of the ring rotated to the call's cursor v0.
// Forms 0 and 1 read and write physical slot (virtual + off) mod L.
struct DelaySeg {
  int form;
  long long v0, off, k0, k1;
};

template <typename T>
__device__ __forceinline__ void delay_taps(const DelaySeg& s, long long kk, T c,
                                           int L, T& frac, long long& r0,
                                           long long& r1, long long& wr) {
  if (s.form == 2) {
    const T pos = static_cast<T>(L + kk) - c;
    const T fl = floor_of(pos);
    frac = pos - fl;
    const long long i0 = static_cast<long long>(fl);
    r0 = imod(s.v0 + i0, L);
    r1 = imod(s.v0 + i0 + 1, L);
    wr = imod(s.v0 + kk, L);
  } else {
    long long v = s.v0 + kk;
    if (s.form == 1) v = imod(v, L);
    const T pos = py_mod(static_cast<T>(v) - c, static_cast<T>(L));
    const T fl = floor_of(pos);
    frac = pos - fl;
    long long i0 = static_cast<long long>(fl);
    const long long i1 = imod(i0 + 1, L);
    i0 = i0 < 0 ? 0 : (i0 > L - 1 ? L - 1 : i0);  // a gather clamps
    r0 = imod(i0 + s.off, L);
    r1 = imod(i1 + s.off, L);
    wr = imod(imod(v, L) + s.off, L);
  }
}

template <typename T>
__device__ void warp_reverse(T* a, long long lo, long long hi, int lane) {
  const long long n = hi - lo;
  for (long long i = lane; i < n / 2; i += kWarp) {
    const T t = a[lo + i];
    a[lo + i] = a[hi - 1 - i];
    a[hi - 1 - i] = t;
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarps) delay_feedback_kernel(
    T* __restrict__ buf, const T* __restrict__ x, const T* __restrict__ cur,
    T* __restrict__ y, const int* __restrict__ w_in, int* __restrict__ w_out,
    int C, DelayParams<T> p) {
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (c >= C) return;
  const int L = p.L;
  const long long N = p.N;
  const long long w = imod(static_cast<long long>(*w_in), L);
  const long long nb = N / kDelayBlock, rem = N % kDelayBlock;
  // the reference's tier: blocked where every lag lies in [B + 2, L - 2]
  // (a NaN lag fails both), on the aligned ring where the call is whole
  // blocks from a block-aligned cursor
  bool ok = nb > 0;
  if (ok) {
    for (long long k = lane; k < N; k += kWarp) {
      const T v = cur[k];
      ok = ok && v >= static_cast<T>(kDelayBlock + 2) && v <= static_cast<T>(L - 2);
    }
    ok = __all_sync(kFull, ok);
  }
  DelaySeg seg[2];
  int nseg = 1;
  long long rot = -1, w_final;
  if (!ok) {
    seg[0] = {0, w, 0, 0, N};
    w_final = imod(w + N, L);
  } else if (rem == 0 && w % kDelayBlock == 0) {
    seg[0] = {1, w, 0, 0, N};
    w_final = imod(w + N, L);
  } else {
    // linear extension, then the tail's scan from cursor 0 of the ring
    // rotated to start at the extension's end
    rot = imod(w + nb * kDelayBlock, L);
    seg[0] = {2, w, 0, 0, nb * kDelayBlock};
    if (rem) seg[nseg++] = {0, 0, rot, nb * kDelayBlock, N};
    w_final = rem;
  }
  if (c == 0 && lane == 0) *w_out = static_cast<int>(w_final);

  T* row = buf + static_cast<size_t>(c) * L;
  const T* xc = x + static_cast<size_t>(c) * N;
  T* yc = y + static_cast<size_t>(c) * N;
  for (int si = 0; si < nseg; ++si) {
    const DelaySeg s = seg[si];
    for (long long k0 = s.k0; k0 < s.k1; k0 += kWarp) {
      const int cnt = static_cast<int>(s.k1 - k0 < kWarp ? s.k1 - k0 : kWarp);
      const bool live = lane < cnt;
      const long long k = k0 + lane;
      const T cv = live ? cur[k] : T(kMinParallelLag);
      const T xv = live ? xc[k] : T(0);
      if (__all_sync(kFull, cv >= T(kMinParallelLag))) {
        T frac = T(0), delayed = T(0);
        long long r0 = 0, r1 = 0, wr = 0;
        if (live) {
          delay_taps(s, k - s.k0, cv, L, frac, r0, r1, wr);
          delayed = row[r0] * (T(1) - frac) + row[r1] * frac;
        }
        __syncwarp();
        if (live) {
          row[wr] = xv + delayed * p.fb;
          yc[k] = xv * p.dry + delayed * p.mix;
        }
      } else if (lane == 0) {
        // a lag under a chunk: one lane walks the chunk in order
        for (int j = 0; j < cnt; ++j) {
          const long long kj = k0 + j;
          const T cj = cur[kj], xj = xc[kj];
          T frac;
          long long r0, r1, wr;
          delay_taps(s, kj - s.k0, cj, L, frac, r0, r1, wr);
          const T delayed = row[r0] * (T(1) - frac) + row[r1] * frac;
          row[wr] = xj + delayed * p.fb;
          yc[kj] = xj * p.dry + delayed * p.mix;
        }
      }
      __syncwarp();
    }
  }
  if (rot > 0) {
    // the reference returns the extension's last L samples with the
    // cursor at 0: rotate the row left by rot (three reversals)
    warp_reverse(row, 0, rot, lane);
    warp_reverse(row, rot, L, lane);
    warp_reverse(row, 0, L, lane);
  }
}

// ---------------------------------------------------------------------------
// R2: Freeverb
// ---------------------------------------------------------------------------

constexpr int kCombs = 8;
constexpr int kAllpasses = 4;

// The twelve rings of a Freeverb state, each (C, len) contiguous, by value.
struct FreeverbRings {
  void* comb[kCombs];
  void* allp[kAllpasses];
  int comb_len[kCombs];
  int allp_len[kAllpasses];
};

template <typename T>
struct FreeverbParams {
  T gain, da, db, fb, apfb, wet, dry, squelch;
  long long N;
};

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarps) freeverb_kernel(
    FreeverbRings r, const T* __restrict__ fstore_in, T* __restrict__ fstore_out,
    const int* __restrict__ step_in, int* __restrict__ step_out,
    const T* __restrict__ x, T* __restrict__ y, int C, FreeverbParams<T> p) {
  __shared__ T s_out[kWarps][kCombs][kWarp];
  __shared__ T s_inp[kWarps][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int wi = threadIdx.x / kWarp;
  const int c = blockIdx.x * kWarps + wi;
  if (c >= C) return;
  const long long N = p.N;
  const long long step = *step_in;
  if (c == 0 && lane == 0) *step_out = static_cast<int>(step + N);
  T* comb[kCombs];
  T* allp[kAllpasses];
#pragma unroll
  for (int i = 0; i < kCombs; ++i)
    comb[i] = static_cast<T*>(r.comb[i]) + static_cast<size_t>(c) * r.comb_len[i];
#pragma unroll
  for (int j = 0; j < kAllpasses; ++j)
    allp[j] = static_cast<T*>(r.allp[j]) + static_cast<size_t>(c) * r.allp_len[j];
  T fst = lane < kCombs ? fstore_in[c * kCombs + lane] : T(0);
  const T* xc = x + static_cast<size_t>(c) * N;
  T* yc = y + static_cast<size_t>(c) * N;

  for (long long k0 = 0; k0 < N; k0 += kWarp) {
    const int cnt = static_cast<int>(N - k0 < kWarp ? N - k0 : kWarp);
    const bool live = lane < cnt;
    const long long n = step + k0 + lane;  // this lane's sample's step
    T outs[kCombs], bo[kAllpasses], xv = T(0);
    if (live) {
      xv = xc[k0 + lane];
#pragma unroll
      for (int i = 0; i < kCombs; ++i) outs[i] = comb[i][imod(n, r.comb_len[i])];
#pragma unroll
      for (int j = 0; j < kAllpasses; ++j) bo[j] = allp[j][imod(n, r.allp_len[j])];
#pragma unroll
      for (int i = 0; i < kCombs; ++i) s_out[wi][i][lane] = outs[i];
      s_inp[wi][lane] = p.gain * xv;
    }
    __syncwarp();
    if (lane < kCombs) {
      // comb `lane`'s damping one-pole over the chunk, in order; the slot
      // then holds the value written back
      for (int g = 0; g < cnt; ++g) {
        T fs = s_out[wi][lane][g] * p.db + fst * p.da;
        if (fabs(fs) < p.squelch) fs = T(0);
        fst = fs;
        s_out[wi][lane][g] = s_inp[wi][g] + fs * p.fb;
      }
    }
    __syncwarp();
    if (live) {
#pragma unroll
      for (int i = 0; i < kCombs; ++i)
        comb[i][imod(n, r.comb_len[i])] = s_out[wi][i][lane];
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < kCombs; ++i) acc = acc + outs[i];
#pragma unroll
      for (int j = 0; j < kAllpasses; ++j) {
        const T out = bo[j] - acc;
        allp[j][imod(n, r.allp_len[j])] = acc + bo[j] * p.apfb;
        acc = out;
      }
      yc[k0 + lane] = acc * p.wet + xv * p.dry;
    }
    __syncwarp();
  }
  if (lane < kCombs) fstore_out[c * kCombs + lane] = fst;
}

// ---------------------------------------------------------------------------
// R3: the FDN
// ---------------------------------------------------------------------------
//
// One block walks one channel, a stretch of the call at a time: a whole
// `_block` block of the blocked tier, or up to max(1, B) samples of the
// per-sample tier (the chain's 512-sample call in one). A stretch is never
// longer than the reference's block, B = min(1024, floor(min line delay) -
// 2), and every read lags at least the shortest line delay less one, so no
// sample of a stretch reads what the same stretch writes: all its reads
// come first, then all its writes (a read of a slot that a later sample of
// the stretch overwrites sees the old value, as in the walk in order).
// A stretch runs in four passes, a block barrier after each:
//   1. the per-sample tier's LFO phases, one recurrence of adds in order
//      (thread 0, into shared memory; the blocked tier forms each sample's
//      phase from its block's start, in the next pass);
//   2. each sample on a thread: the 8 modulated interpolated reads (8 sin
//      calls, the full-precision library function), the output, and the
//      Hadamard mix into shared memory (8 lines x stretch);
//   3. the damping one-pole of each line as a scan over the stretch: a
//      warp a line, a lane a chunk of ceil(stretch / 32) samples walked in
//      order from zero (lane 0 from the line's state), the chunks' affine
//      maps composed by shuffles, each sample then taking its chunk's
//      entering state times damp^(its place in the chunk + 1);
//   4. the writes of the 8 lines.
// Stretches run in order: each reads what the one before it wrote.
// The scan rounds otherwise than the walk in order and the reference's
// sweep (`_damp_block`): held at >= 100 dB against the plain version in
// float32 and >= 200 dB in float64. Bound: the bytes are a few per sample
// and line; what remains in order is the per-sample tier's phase (one add
// and one compare a sample) and a chunk's damping walk; the reads and mix
// wait on the sin calls and the loads they address.

constexpr int kLines = 8;
constexpr int kFdnThreads = 512;
constexpr int kFdnMaxStretch = 1024;
constexpr int kFdnChunks = 32;   // lanes of a line's scan

// a line's row in shared memory holds sample t at t + t / 32, so that the
// scan's lanes, a chunk apart, read distinct banks
__device__ __forceinline__ int fdn_pad(int t) { return t + (t >> 5); }
inline int fdn_row(int stretch) { return stretch + stretch / 32 + 1; }

template <typename T>
struct FdnParams {
  T base[kLines], fbg[kLines], off[kLines], had[kLines * kLines];
  T depth, dph, dph_block, two_pi, gain, damp, omd_block, omd_sample, wet, dry;
  int L, B, stretch, row;   // row: fdn_row(stretch)
  long long N, nb;
};

// py_mod(a, two_pi), taking the exact short cuts where a lies in
// [0, 2 two_pi) (fmod of such an a is a or a - two_pi, exactly)
template <typename T>
__device__ __forceinline__ T wrap_phase(T a, T two_pi) {
  if (a >= T(0) && a < two_pi) return a;
  if (a >= two_pi && a < two_pi + two_pi) return a - two_pi;
  return py_mod(a, two_pi);
}

template <typename T>
__global__ void __launch_bounds__(kFdnThreads) fdn_kernel(
    T* __restrict__ lines, const T* __restrict__ fst_in, T* __restrict__ fst_out,
    const T* __restrict__ lfo_in, T* __restrict__ lfo_out,
    const int* __restrict__ step_in, int* __restrict__ step_out,
    const T* __restrict__ x, const T* __restrict__ inp, T* __restrict__ y,
    FdnParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_f = reinterpret_cast<T*>(smem_raw);   // (8, row): mix, then damped
  T* s_ph = s_f + kLines * p.row;            // (stretch,): per-sample phases
  __shared__ T s_pw[kFdnMaxStretch / kFdnChunks + 1];   // damp^k
  __shared__ T s_lfo;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp, wi = tid / kWarp;
  const int L = p.L;
  const long long N = p.N;
  const long long step = *step_in;
  T lfo = *lfo_in;
  T fst = wi < kLines ? fst_in[c * kLines + wi] : T(0);
  for (int k = tid; k <= kFdnMaxStretch / kFdnChunks; k += blockDim.x)
    s_pw[k] = static_cast<T>(pow(static_cast<double>(p.damp),
                                 static_cast<double>(k)));
  T* row = lines + static_cast<size_t>(c) * kLines * L;
  const T* xc = x + static_cast<size_t>(c) * N;
  const T* ic = inp + static_cast<size_t>(c) * N;
  T* yc = y + static_cast<size_t>(c) * N;

  // the stretch [k0, k0 + len) of the call; blocked: one whole block of
  // the blocked tier, whose phase at its start is lfo
  auto stretch = [&](long long k0, int len, bool blocked) {
    if (!blocked) {
      if (tid == 0) {   // the phase accumulates in order
        T ph = lfo;
        if (ph >= T(0) && ph < p.two_pi && p.dph >= T(0) && p.dph < p.two_pi) {
          // every sum then lies in [0, 2 two_pi): one compare a step
#pragma unroll 8
          for (int t = 0; t < len; ++t) {
            s_ph[t] = ph;
            const T a = ph + p.dph;
            ph = a >= p.two_pi ? a - p.two_pi : a;
          }
        } else {
          for (int t = 0; t < len; ++t) {
            s_ph[t] = ph;
            ph = wrap_phase(ph + p.dph, p.two_pi);
          }
        }
        s_lfo = ph;
      }
      __syncthreads();
    }
    for (int t = tid; t < len; t += blockDim.x) {
      const long long k = k0 + t;
      const long long n = step + k;
      const T ph = blocked ? wrap_phase(lfo + p.dph * static_cast<T>(t), p.two_pi)
                           : s_ph[t];
      const T wp = static_cast<T>(imod(n, L));
      T d[kLines];
#pragma unroll
      for (int i = 0; i < kLines; ++i) {
        const T m = T(0.5) * (T(1) + sin_of(ph + p.off[i]));
        const T del = p.base[i] + p.depth * m;
        const T pos = blocked ? static_cast<T>(L + t) - del : wp - del;
        const T fl = floor_of(pos);
        const T frac = pos - fl;
        const long long i0 = static_cast<long long>(fl);
        long long r0, r1;
        if (blocked) {  // linear index from the block's start
          r0 = imod(n - t + i0, L);
          r1 = imod(n - t + i0 + 1, L);
        } else {
          r0 = imod(i0, L);
          r1 = imod(r0 + 1, L);
        }
        const T* li = row + static_cast<size_t>(i) * L;
        d[i] = li[r0] * (T(1) - frac) + li[r1] * frac;
      }
      T sum = d[0];
#pragma unroll
      for (int i = 1; i < kLines; ++i) sum = sum + d[i];
      yc[k] = xc[k] * p.dry + (sum * p.gain) * p.wet;
#pragma unroll
      for (int i = 0; i < kLines; ++i) {
        T f = p.had[i * kLines] * d[0];
#pragma unroll
        for (int j = 1; j < kLines; ++j) f = f + p.had[i * kLines + j] * d[j];
        s_f[i * p.row + fdn_pad(t)] = f;
      }
    }
    __syncthreads();
    if (wi < kLines) {   // line wi's damping, lane `lane` a chunk
      const T omd = blocked ? p.omd_block : p.omd_sample;
      const int lc = (len + kFdnChunks - 1) / kFdnChunks;
      const int t0 = min(len, lane * lc), t1 = min(len, t0 + lc);
      T* f = s_f + wi * p.row;
      T z = lane == 0 ? fst : T(0);
      for (int t = t0; t < t1; ++t) {
        z = f[fdn_pad(t)] * omd + z * p.damp;
        f[fdn_pad(t)] = z;
      }
      // the chunks' maps s -> P s + e, composed in order over the lanes
      T P = lane == 0 ? T(0) : s_pw[t1 - t0], e = z;
#pragma unroll
      for (int o = 1; o < kFdnChunks; o <<= 1) {
        const T Pu = __shfl_up_sync(kFull, P, o);
        const T eu = __shfl_up_sync(kFull, e, o);
        if (lane >= o) {
          e = P * eu + e;
          P = P * Pu;
        }
      }
      const T carry = __shfl_up_sync(kFull, e, 1);   // the chunk's entering state
      if (lane > 0)
        for (int t = t0; t < t1; ++t)
          f[fdn_pad(t)] = f[fdn_pad(t)] + s_pw[t - t0 + 1] * carry;
      fst = __shfl_sync(kFull, e, kFdnChunks - 1);
    }
    __syncthreads();
    for (int t = tid; t < len; t += blockDim.x) {
      const long long k = k0 + t;
      const long long wpos = imod(step + k, L);
      const T iv = ic[k];
#pragma unroll
      for (int i = 0; i < kLines; ++i)
        row[static_cast<size_t>(i) * L + wpos] =
            iv * p.gain + s_f[i * p.row + fdn_pad(t)] * p.fbg[i];
    }
    if (blocked)
      lfo = wrap_phase(lfo + p.dph_block, p.two_pi);
    else
      lfo = s_lfo;
    __syncthreads();
  };

  for (long long b = 0; b < p.nb; ++b) stretch(b * p.B, p.B, true);
  for (long long k0 = p.nb * p.B; k0 < N; k0 += p.stretch)
    stretch(k0, static_cast<int>(N - k0 < p.stretch ? N - k0 : p.stretch), false);
  if (wi < kLines && lane == 0) fst_out[c * kLines + wi] = fst;
  if (c == 0 && tid == 0) {
    *lfo_out = lfo;
    *step_out = static_cast<int>(step + N);
  }
}

// ---------------------------------------------------------------------------
// M1: the flanger
// ---------------------------------------------------------------------------

template <typename T>
struct FlangerParams {
  T fb, mix, dry;  // dry = (T)(1 - mix), rounded from double as the reference
  int L, B;
  long long N, nb;  // nb blocks of B samples in the blocked form, then the tail
};

// Sample k of the call (counter w at the call's start): its read position's
// fraction and the virtual index of its first tap (slot imod(r, L); the
// sample itself writes virtual w + k). The blocked form reads the block's
// linearised ring at (L + t) - d, t the sample's index in its block, which
// starts at virtual w + k - t; the per-sample form reads at float(w + k) - d
// with the counter unreduced. The two round differently, so each sample
// takes the form the reference runs it in.
template <typename T>
__device__ __forceinline__ void flanger_tap(const FlangerParams<T>& p,
                                            long long w, long long k, T dv,
                                            T& frac, long long& r) {
  if (k < p.nb * p.B) {
    const long long t = k % p.B;
    const T pos = static_cast<T>(p.L + t) - dv;
    const T fl = floor_of(pos);
    frac = pos - fl;
    r = w + k - t - p.L + static_cast<long long>(fl);
  } else {
    const T pos = static_cast<T>(w + k) - dv;
    const T fl = floor_of(pos);
    frac = pos - fl;
    r = static_cast<long long>(fl);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarps) flanger_kernel(
    T* __restrict__ buf, const T* __restrict__ x, const T* __restrict__ d,
    T* __restrict__ y, const int* __restrict__ w_in, int* __restrict__ w_out,
    int C, FlangerParams<T> p) {
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (c >= C) return;
  const int L = p.L;
  const long long N = p.N;
  const long long w = *w_in;  // the reference's counter, never reduced
  if (c == 0 && lane == 0) *w_out = static_cast<int>(w + N);
  T* row = buf + static_cast<size_t>(c) * L;
  const T* xc = x + static_cast<size_t>(c) * N;
  T* yc = y + static_cast<size_t>(c) * N;
  for (long long k0 = 0; k0 < N; k0 += kWarp) {
    const int cnt = static_cast<int>(N - k0 < kWarp ? N - k0 : kWarp);
    const bool live = lane < cnt;
    const long long k = k0 + lane;
    T frac = T(0), xv = T(0);
    long long r = 0;
    if (live) {
      flanger_tap(p, w, k, d[k], frac, r);
      xv = xc[k];
    }
    // lane j of the chunk writes slot (w + k0 + j) mod L: where no lane's
    // two taps read a slot that an earlier lane writes, every lane reads
    // what the walk in order would, and the chunk runs on its lanes
    // (loads, then stores)
    const long long first = w + k0;
    const bool apart = !live || (imod(r - first, L) >= lane &&
                                 imod(r + 1 - first, L) >= lane);
    if (__all_sync(kFull, apart)) {
      T delayed = T(0);
      if (live)
        delayed = row[imod(r, L)] * (T(1) - frac) + row[imod(r + 1, L)] * frac;
      __syncwarp();
      if (live) {
        row[imod(w + k, L)] = xv + delayed * p.fb;
        yc[k] = xv * p.dry + delayed * p.mix;
      }
    } else if (lane == 0) {
      // a lag under a chunk (below ~0.7 ms): one lane walks the chunk in
      // order
      for (int j = 0; j < cnt; ++j) {
        const long long kj = k0 + j;
        T fj;
        long long rj;
        flanger_tap(p, w, kj, d[kj], fj, rj);
        const T xj = xc[kj];
        const T delayed =
            row[imod(rj, L)] * (T(1) - fj) + row[imod(rj + 1, L)] * fj;
        row[imod(w + kj, L)] = xj + delayed * p.fb;
        yc[kj] = xj * p.dry + delayed * p.mix;
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// The damping chain alone, for the chain bound: one thread runs n dependent
// one-pole steps (R2's with its squelch, R3's without) between two clock64()
// stamps.
// ---------------------------------------------------------------------------

// M1's dependent chain alone: one warp walks n chunks of 32 samples on a
// ring of L slots, each lane loading the slot `lag` samples back, then
// storing its own, as M1's chunks do (the loads of a chunk wait for the
// stores of the chunks before it), between two clock64() stamps.
__global__ void ring_chunk_latency_kernel(long long n, int L, int lag,
                                          float* ring, long long* cycles) {
  const int lane = threadIdx.x;
  const long long t0 = clock64();
  for (long long k0 = 0; k0 < n * kWarp; k0 += kWarp) {
    const long long k = k0 + lane;
    const float v = ring[imod(k - lag, L)];
    __syncwarp();
    ring[imod(k, L)] = v * 0.5f + 1.0f;
    __syncwarp();
  }
  const long long t1 = clock64();
  if (lane == 0) cycles[0] = t1 - t0;
}

template <typename T, bool kSquelch>
__global__ void damp_latency_kernel(long long n, T x0, T da, T db,
                                    long long* cycles, T* sink) {
  T fs = T(0), v = x0;
  const long long t0 = clock64();
  for (long long i = 0; i < n; ++i) {
    fs = v * db + fs * da;
    if (kSquelch && fabs(fs) < T(1e-23)) fs = T(0);
    v = -v;
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = fs;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

inline int grid_of(int C) { return (C + kWarps - 1) / kWarps; }

template <typename T>
int delay_launch(T* buf, const T* x, const T* cur, T* y, const int* w_in,
                 int* w_out, int C, int L, long long N, const double* prm,
                 void* stream) {
  // prm: feedback, mix
  DelayParams<T> p;
  p.fb = static_cast<T>(prm[0]);
  p.mix = static_cast<T>(prm[1]);
  p.dry = static_cast<T>(1.0 - prm[1]);
  p.L = L;
  p.N = N;
  delay_feedback_kernel<T><<<grid_of(C), kWarp * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      buf, x, cur, y, w_in, w_out, C, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int freeverb_launch(void* const* rings, const int* lens, const T* fs_in,
                    T* fs_out, const int* step_in, int* step_out, const T* x,
                    T* y, int C, long long N, const double* prm, void* stream) {
  // rings: 8 comb then 4 allpass device pointers; lens: their lengths;
  // prm: input gain, damp, comb feedback, allpass feedback, wet, dry
  FreeverbRings r;
  for (int i = 0; i < kCombs; ++i) {
    r.comb[i] = rings[i];
    r.comb_len[i] = lens[i];
  }
  for (int j = 0; j < kAllpasses; ++j) {
    r.allp[j] = rings[kCombs + j];
    r.allp_len[j] = lens[kCombs + j];
  }
  FreeverbParams<T> p;
  p.gain = static_cast<T>(prm[0]);
  p.da = static_cast<T>(prm[1]);
  p.db = static_cast<T>(1.0 - prm[1]);
  p.fb = static_cast<T>(prm[2]);
  p.apfb = static_cast<T>(prm[3]);
  p.wet = static_cast<T>(prm[4]);
  p.dry = static_cast<T>(prm[5]);
  p.squelch = static_cast<T>(1e-23);
  p.N = N;
  freeverb_kernel<T><<<grid_of(C), kWarp * kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      r, fs_in, fs_out, step_in, step_out, x, y, C, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fdn_launch(T* lines, const T* fst_in, T* fst_out, const T* lfo_in,
               T* lfo_out, const int* step_in, int* step_out, const T* x,
               const T* inp, T* y, int C, int L, long long N, int B,
               long long nb, const double* prm, void* stream) {
  // prm: base delays (8), feedback gains (8), phase offsets (8), the
  // scaled Hadamard (64, row-major), mod depth, dphase, dphase * B, gain,
  // damp, wet, dry
  // the per-sample tier's stretch: the reference's block, at least 1
  const int stretch = B < 1 ? 1 : B;
  if (C < 1 || stretch > kFdnMaxStretch || nb < 0 || (nb > 0 && B < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  FdnParams<T> p;
  for (int i = 0; i < kLines; ++i) {
    p.base[i] = static_cast<T>(prm[i]);
    p.fbg[i] = static_cast<T>(prm[8 + i]);
    p.off[i] = static_cast<T>(prm[16 + i]);
  }
  for (int i = 0; i < kLines * kLines; ++i) p.had[i] = static_cast<T>(prm[24 + i]);
  const double* s = prm + 24 + kLines * kLines;
  p.depth = static_cast<T>(s[0]);
  p.dph = static_cast<T>(s[1]);
  p.dph_block = static_cast<T>(s[2]);
  p.two_pi = static_cast<T>(2.0 * 3.141592653589793);
  p.gain = static_cast<T>(s[3]);
  p.damp = static_cast<T>(s[4]);
  p.omd_block = static_cast<T>(1.0 - s[4]);             // (1.0 - da) * fb
  p.omd_sample = T(1) - static_cast<T>(s[4]);           // fb * (1 - damp)
  p.wet = static_cast<T>(s[5]);
  p.dry = static_cast<T>(s[6]);
  p.L = L;
  p.B = B;
  p.stretch = stretch;
  p.row = fdn_row(stretch);
  p.N = N;
  p.nb = nb;
  const size_t smem = static_cast<size_t>(kLines * p.row + stretch) * sizeof(T);
  // opt in once per device to the largest stretch's shared memory, so that
  // later calls and a CUDA graph capturing them make no attribute call
  static int opted_in[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !opted_in[dev]) {
    const int most = static_cast<int>(
        (kLines * fdn_row(kFdnMaxStretch) + kFdnMaxStretch) * sizeof(T));
    err = cudaFuncSetAttribute(fdn_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted_in[dev] = 1;
  }
  fdn_kernel<T><<<C, kFdnThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lines, fst_in, fst_out, lfo_in, lfo_out, step_in, step_out, x, inp, y, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flanger_launch(T* buf, const T* x, const T* d, T* y, const int* w_in,
                   int* w_out, int C, int L, long long N, int B, long long nb,
                   const double* prm, void* stream) {
  // prm: feedback, mix
  FlangerParams<T> p;
  p.fb = static_cast<T>(prm[0]);
  p.mix = static_cast<T>(prm[1]);
  p.dry = static_cast<T>(1.0 - prm[1]);
  p.L = L;
  p.B = B;
  p.N = N;
  p.nb = nb;
  flanger_kernel<T><<<grid_of(C), kWarp * kWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(buf, x, d, y, w_in,
                                                           w_out, C, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int latency(int squelch, long long n, double x0, double damp,
            long long* cycles, void* sink, void* stream) {
  const T da = static_cast<T>(damp), db = static_cast<T>(1.0 - damp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (squelch)
    damp_latency_kernel<T, true><<<1, 1, 0, st>>>(
        n, static_cast<T>(x0), da, db, cycles, static_cast<T*>(sink));
  else
    damp_latency_kernel<T, false><<<1, 1, 0, st>>>(
        n, static_cast<T>(x0), da, db, cycles, static_cast<T*>(sink));
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// buf (C, L) updated in place; x, y (C, N); cur (N,); w_in, w_out: one
// int32 each on the device; prm: 2 doubles on the host. Returns
// cudaGetLastError() after the launch.
int delay_feedback_f32(float* buf, const float* x, const float* cur, float* y,
                       const int* w_in, int* w_out, int C, int L, long long N,
                       const double* prm, void* stream) {
  return delay_launch<float>(buf, x, cur, y, w_in, w_out, C, L, N, prm, stream);
}

int delay_feedback_f64(double* buf, const double* x, const double* cur,
                       double* y, const int* w_in, int* w_out, int C, int L,
                       long long N, const double* prm, void* stream) {
  return delay_launch<double>(buf, x, cur, y, w_in, w_out, C, L, N, prm, stream);
}

// rings: 12 device pointers (host array), each ring (C, lens[i]) updated
// in place; fs_in, fs_out (C, 8); step_in, step_out one int32 each on the
// device; x, y (C, N); prm: 6 doubles on the host.
int freeverb_f32(void* const* rings, const int* lens, const float* fs_in,
                 float* fs_out, const int* step_in, int* step_out,
                 const float* x, float* y, int C, long long N,
                 const double* prm, void* stream) {
  return freeverb_launch<float>(rings, lens, fs_in, fs_out, step_in, step_out,
                                x, y, C, N, prm, stream);
}

int freeverb_f64(void* const* rings, const int* lens, const double* fs_in,
                 double* fs_out, const int* step_in, int* step_out,
                 const double* x, double* y, int C, long long N,
                 const double* prm, void* stream) {
  return freeverb_launch<double>(rings, lens, fs_in, fs_out, step_in, step_out,
                                 x, y, C, N, prm, stream);
}

// lines (C, 8, L) updated in place; fst_in, fst_out (C, 8); lfo_in,
// lfo_out one value each and step_in, step_out one int32 each on the
// device; x, inp (the pre-delayed input), y (C, N); nb blocks of B samples
// in the blocked form, then N - nb * B in the per-sample form, in stretches
// of up to max(1, B) samples (B <= 1024, the reference's block); prm: 95
// doubles on the host.
int fdn_f32(float* lines, const float* fst_in, float* fst_out,
            const float* lfo_in, float* lfo_out, const int* step_in,
            int* step_out, const float* x, const float* inp, float* y, int C,
            int L, long long N, int B, long long nb, const double* prm,
            void* stream) {
  return fdn_launch<float>(lines, fst_in, fst_out, lfo_in, lfo_out, step_in,
                           step_out, x, inp, y, C, L, N, B, nb, prm, stream);
}

int fdn_f64(double* lines, const double* fst_in, double* fst_out,
            const double* lfo_in, double* lfo_out, const int* step_in,
            int* step_out, const double* x, const double* inp, double* y,
            int C, int L, long long N, int B, long long nb, const double* prm,
            void* stream) {
  return fdn_launch<double>(lines, fst_in, fst_out, lfo_in, lfo_out, step_in,
                            step_out, x, inp, y, C, L, N, B, nb, prm, stream);
}

// buf (C, L) updated in place; x, y (C, N); d (N,) the lag trajectory;
// w_in, w_out: one int32 each on the device (the unreduced counter); nb
// blocks of B samples in the blocked form, then the per-sample form; prm:
// 2 doubles on the host.
int flanger_f32(float* buf, const float* x, const float* d, float* y,
                const int* w_in, int* w_out, int C, int L, long long N, int B,
                long long nb, const double* prm, void* stream) {
  return flanger_launch<float>(buf, x, d, y, w_in, w_out, C, L, N, B, nb, prm,
                               stream);
}

int flanger_f64(double* buf, const double* x, const double* d, double* y,
                const int* w_in, int* w_out, int C, int L, long long N, int B,
                long long nb, const double* prm, void* stream) {
  return flanger_launch<double>(buf, x, d, y, w_in, w_out, C, L, N, B, nb, prm,
                                stream);
}

// The cycles of n chunks of M1's dependent walk (ring: L floats on the
// device, cycles: one int64 on the device).
int ring_chunk_latency(long long n, int L, int lag, float* ring,
                       long long* cycles, void* stream) {
  ring_chunk_latency_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      n, L, lag, ring, cycles);
  return static_cast<int>(cudaGetLastError());
}

// The cycles of n dependent damping steps on one thread (cycles: one
// int64 on the device; sink: one value of the type).
int damp_latency_f32(int squelch, long long n, double x0, double damp,
                     long long* cycles, void* sink, void* stream) {
  return latency<float>(squelch, n, x0, damp, cycles, sink, stream);
}

int damp_latency_f64(int squelch, long long n, double x0, double damp,
                     long long* cycles, void* sink, void* stream) {
  return latency<double>(squelch, n, x0, damp, cycles, sink, stream);
}

}  // extern "C"
