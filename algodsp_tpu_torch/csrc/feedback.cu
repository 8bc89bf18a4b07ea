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
// ring buffers the JAX package keeps as state, one warp a channel, four
// channels a block. Every feedback read lags at least 40 samples (R1, a
// chunk at a time: a chunk with a shorter lag walks on one lane), 225 (R2)
// or the shortest FDN line (R3), so the 32 samples of a chunk run on the
// 32 lanes at once: all lanes load, then all store, and only a chunk's
// one-pole dampings walk its samples in order (lanes 0-7, one comb or
// line each). M1's lag never drops below max(base delay, 1 sample): a
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

constexpr int kLines = 8;

template <typename T>
struct FdnParams {
  T base[kLines], fbg[kLines], off[kLines], had[kLines * kLines];
  T depth, dph, dph_block, two_pi, gain, damp, omd_block, omd_sample, wet, dry;
  int L, B;
  long long N, nb;
};

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarps) fdn_kernel(
    T* __restrict__ lines, const T* __restrict__ fst_in, T* __restrict__ fst_out,
    const T* __restrict__ lfo_in, T* __restrict__ lfo_out,
    const int* __restrict__ step_in, int* __restrict__ step_out,
    const T* __restrict__ x, const T* __restrict__ inp, T* __restrict__ y,
    int C, FdnParams<T> p) {
  __shared__ T s_fb[kWarps][kLines][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int wi = threadIdx.x / kWarp;
  const int c = blockIdx.x * kWarps + wi;
  if (c >= C) return;
  const int L = p.L;
  const long long N = p.N;
  const long long step = *step_in;
  T lfo = *lfo_in;
  T fst = lane < kLines ? fst_in[c * kLines + lane] : T(0);
  T* row = lines + static_cast<size_t>(c) * kLines * L;
  const T* xc = x + static_cast<size_t>(c) * N;
  const T* ic = inp + static_cast<size_t>(c) * N;
  T* yc = y + static_cast<size_t>(c) * N;

  // one chunk of cnt samples from call sample k0; blocked: the chunk lies
  // in the block that starts at call sample kb with phase lfo_b
  auto chunk = [&](long long k0, int cnt, bool blocked, long long kb, T lfo_b,
                   T my_lfo) {
    const bool live = lane < cnt;
    const long long k = k0 + lane;
    const long long n = step + k;
    T d[kLines];
    T xv = T(0), iv = T(0);
    if (live) {
      xv = xc[k];
      iv = ic[k];
      const long long t = k - kb;
      const T ph = blocked ? py_mod(lfo_b + p.dph * static_cast<T>(t), p.two_pi)
                           : my_lfo;
      const T wp = static_cast<T>(imod(n, L));
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
      yc[k] = xv * p.dry + (sum * p.gain) * p.wet;
#pragma unroll
      for (int i = 0; i < kLines; ++i) {
        T f = p.had[i * kLines] * d[0];
#pragma unroll
        for (int j = 1; j < kLines; ++j) f = f + p.had[i * kLines + j] * d[j];
        s_fb[wi][i][lane] = f;
      }
    }
    __syncwarp();
    if (lane < kLines) {
      const T omd = blocked ? p.omd_block : p.omd_sample;
      for (int g = 0; g < cnt; ++g) {
        const T f = s_fb[wi][lane][g] * omd + fst * p.damp;
        s_fb[wi][lane][g] = f;
        fst = f;
      }
    }
    __syncwarp();
    if (live) {
      const long long wpos = imod(n, L);
#pragma unroll
      for (int i = 0; i < kLines; ++i)
        row[static_cast<size_t>(i) * L + wpos] =
            iv * p.gain + s_fb[wi][i][lane] * p.fbg[i];
    }
    __syncwarp();
  };

  for (long long b = 0; b < p.nb; ++b) {
    const long long kb = b * p.B;
    for (long long k0 = kb; k0 < kb + p.B; k0 += kWarp) {
      const int cnt = static_cast<int>(kb + p.B - k0 < kWarp ? kb + p.B - k0 : kWarp);
      chunk(k0, cnt, true, kb, lfo, T(0));
    }
    lfo = py_mod(lfo + p.dph_block, p.two_pi);
  }
  for (long long k0 = p.nb * p.B; k0 < N; k0 += kWarp) {
    const int cnt = static_cast<int>(N - k0 < kWarp ? N - k0 : kWarp);
    // the per-sample phase accumulates: every lane runs the chunk's
    // recurrence and keeps its own sample's value
    T mine = lfo;
    for (int g = 0; g < cnt; ++g) {
      if (g == lane) mine = lfo;
      lfo = py_mod(lfo + p.dph, p.two_pi);
    }
    chunk(k0, cnt, false, 0, T(0), mine);
  }
  if (lane < kLines) fst_out[c * kLines + lane] = fst;
  if (c == 0 && lane == 0) {
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
  p.N = N;
  p.nb = nb;
  fdn_kernel<T><<<grid_of(C), kWarp * kWarps, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      lines, fst_in, fst_out, lfo_in, lfo_out, step_in, step_out, x, inp, y,
      C, p);
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
// in the blocked form, then N - nb * B in the per-sample form; prm: 95
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
