// Nonlinear Moog ladders for Hopper, float32 and float64.
//
// Two kernels, each over x (C, T) with the state8 (8, C) layout
// [s0, s1, s2, s3, t0, t1, t2, prev] of the TPU kernels, five scalar
// parameters in the order algodsp_tpu/filters/moog.py::_kernel_chunk
// builds them, an oversampling factor os, and the output y (C, T) and
// the new state8:
//
//   moog_ladder_kernel replaces algodsp_tpu/ops/pallas_kernels.py::
//     _moog_kernel (K5, front door moog_ladder_pallas): the classic
//     4-stage ladder with exact tanh (MODE 0) or the rational
//     _poly_tanh (MODE 1), and the Huovilainen ladder with half-sample
//     feedback and exact tanh on all four old stages (MODE 2).
//     params = [coef, drive_scale, feedback, input_gain, output_scale].
//   moog_zdf_kernel replaces ::_moog_zdf_kernel (K6, front door
//     moog_zdf_pallas): the ZDF/TPT ladder, a fixed number of Newton
//     iterations on y3 per sample; rows 4-6 pass through unchanged.
//     params = [zdf_gk, drive_scale, feedback, input_gain, output_scale].
//
// Each has a recording instance (RECORD), which the forward under
// autograd runs: the same walk, also storing what each step's reverse
// reads, for the reverse kernels of the A4 section below.
//
// Oversampling is fused: each input sample runs os ladder steps, x * os
// on the first and 0 on the others, and y keeps the last step's output,
// exactly as the same kernel on the zero-stuffed input (length T * os)
// with every os-th output kept. os = 1 is the TPU kernels' contract.
// Every stage is clipped to +-32 (STATE_LIMIT). Any T >= 1 runs here,
// and the state out is the carry after the last real sample.
//
// What bounds them on the H100: the ladder feeds its output back every
// step through tanh, so time cannot be split; each channel is a chain of
// T * os dependent steps, each a chain of 4 dependent tanh with an FMA
// and a clip between them (classic and Huovilainen) or of
// 4 * (newton_iters + 1) tanh and newton_iters divisions (ZDF). That
// latency bounds the kernel whatever the channel count up to the card's
// thread count; the byte bound (read x, write y: 8 bytes a sample) and
// the operation bound are orders of magnitude below it. The design
// shortens what each step waits on (cycles measured by
// tools/moog_bench.py --latency):
//   - float32 tanh is branch-free: for |z| >= TANH_SPLIT it is
//     1 - 2 / (1 + 2^|w|) with w = 2 log2(e) z, from ex2.approx and
//     rcp.approx, signed by z; below it an odd polynomial computed
//     beside it; a select takes one (1.81 ulp at worst, as libm's tanhf;
//     tanh.approx.f32 is ~11 bits, far coarser than the 1e-5 bar). NaN
//     gives NaN, +-inf give +-1, -0 gives -0. float64 keeps libm tanh
//     and IEEE division;
//   - a stage's offset s - coef * t_old is formed off the path, so a
//     stage is one FMA and the tanh; the clip (max.NaN / min.NaN, NaN
//     passing as in jnp.clip) runs beside the tanh, whose argument is the
//     unclipped sum, and a select puts tanh(ds * +-32) where it acts;
//   - Huovilainen computes tanh(ds * s0..s2) from the state at step 0
//     only and then reuses the previous step's t0..t2, which are the
//     tanh of the same arguments; its half-sample feedback
//     0.5 * (s3 + prev) is s3 from step 1 on. Both are exact;
//   - ZDF folds each stage's argument into one FMA of the previous tanh
//     and divides the Newton step by rcp.approx and one FMA refinement;
//   - a block is two warps: one walks 32 channels, one stages their x and
//     y in tiles through shared memory (cp.async in, coalesced stores
//     out), a tile ahead and a tile behind, so the walking warp issues
//     nothing else;
//   - the oversampling factors the chain uses (1, 2, 4, 8) are compile-
//     time constants in float32, so a sample's ticks are straight code
//     (a taken branch costs a lone warp ~25 cycles).
// The file is built with -fmad=false: every fused multiply-add is written
// out, so the kernel instances round alike.

#include <cuda_runtime.h>

#include <algorithm>

#define MOOG_WARP 32

namespace {

constexpr float STATE_LIMIT = 32.0f;
constexpr double LOG2E_X2 = 2.8853900817779268147;   // 2 log2(e)

// |z| below which the float32 tanh takes its polynomial
constexpr float TANH_SPLIT = 0.6f;
// tanh(z) = z + z^3 P(z^2) on |z| < 0.6: near-minimax for relative
// error (0.72 ulp in float32 at this degree)
constexpr float TANH_P0 = -0.33333298563957214f;
constexpr float TANH_P1 = 0.13331924378871918f;
constexpr float TANH_P2 = -0.0537838414311409f;
constexpr float TANH_P3 = 0.020796021446585655f;
constexpr float TANH_P4 = -0.005895223934203386f;

template <typename T>
struct TileLen;
template <>
struct TileLen<float> { static constexpr int value = 128; };
template <>
struct TileLen<double> { static constexpr int value = 64; };

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// clip as jnp.clip: NaN passes through
__device__ __forceinline__ float clip(float v, float lim) {
  float a, b;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(a) : "f"(v), "f"(-lim));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(b) : "f"(a), "f"(lim));
  return b;
}

__device__ __forceinline__ double clip(double v, double lim) {
  return v < -lim ? -lim : (v > lim ? lim : v);
}

// The float32 tanh of z: sgn(z) (1 - 2 / (1 + 2^|w|)) with
// w = +-2 log2(e) z (a rounding of it computed beside z, off the
// caller's path), for |z| >= TANH_SPLIT
__device__ __forceinline__ float tanh_big(float z, float w) {
  const float r = rcp_approx(ex2_approx(fabsf(w)) + 1.0f);
  const float sgn = z < 0.0f ? -1.0f : 1.0f;
  return fmaf(r, -2.0f * sgn, sgn);
}

// ... and z + z^3 P(z^2) for |z| < TANH_SPLIT, signed so that -0 gives -0
__device__ __forceinline__ float tanh_small(float z) {
  const float s = z * z;
  float q = TANH_P4;
  q = fmaf(q, s, TANH_P3);
  q = fmaf(q, s, TANH_P2);
  q = fmaf(q, s, TANH_P1);
  q = fmaf(q, s, TANH_P0);
  return copysignf(fmaf(q * s, z, z), z);
}

// c ? a : b as a select instruction, never a branch
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r) : "f"(a), "f"(b), "r"(int(c)));
  return r;
}

__device__ __forceinline__ float tanh_f32(float z, float w) {
  const float small = tanh_small(z);
  const float big = tanh_big(z, w);
  return select(fabsf(z) < TANH_SPLIT, small, big);
}

// tanh(ds * clip(v, +-32)) from the unclipped v (z = ds v, w = k2 v):
// where the clip acts it is t_hi or t_lo, the same function's tanh of
// ds * +-32, so the result is that of the clipped argument bit for bit,
// and the clip's two instructions leave the dependent path for a select
// taken with the polynomial's.
__device__ __forceinline__ float tanh_f32_clip(float z, float w, float v,
                                               float t_hi, float t_lo) {
  const bool over = fabsf(v) > STATE_LIMIT;
  const float alt = select(over, select(v > 0.0f, t_hi, t_lo), tanh_small(z));
  const float big = tanh_big(z, w);
  return select(over || fabsf(z) < TANH_SPLIT, alt, big);
}

// algodsp_tpu/ops/pallas_kernels.py::_poly_tanh
template <typename T>
__device__ __forceinline__ T poly_tanh(T v) {
  if (v > T(3)) return T(1);
  if (v < T(-3)) return T(-1);
  const T x2 = v * v;
  return clip(v * (T(27) + x2) / (T(27) + T(9) * x2), T(1));
}

// The ladders' tanh of z (w = 2 log2(e) z, read by the float32 exact
// path only)
template <typename T, int MODE>
__device__ __forceinline__ T ladder_tanh(T z, T w) {
  if constexpr (MODE == 1) {
    return poly_tanh(z);
  } else if constexpr (sizeof(T) == 4) {
    return tanh_f32(z, w);
  } else {
    return tanh(z);
  }
}

// a * b + c rounded once. Built with -fmad=false, no other product and
// sum is fused, so every kernel instance (each oversampling factor)
// rounds alike and fused oversampling equals the zero-stuffed input bit
// for bit.
__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}

// y3 / jac for the Newton step: float32 by rcp.approx and one FMA
// refinement of the quotient, float64 by IEEE division
__device__ __forceinline__ float quotient(float a, float b) {
  const float r = rcp_approx(b);
  const float q = a * r;
  return fmaf(fmaf(-b, q, a), r, q);
}

__device__ __forceinline__ double quotient(double a, double b) { return a / b; }

// Tiles of x (and y, written in place): rows [c0, c0 + rows) x
// [base, base + len), each row's samples on consecutive lanes of the
// staging warp.
template <typename T>
__device__ __forceinline__ void tile_fetch(T (*tile)[TileLen<T>::value + 1],
                                           const T* __restrict__ src, int c0,
                                           int rows, long long Tn,
                                           long long base, int len) {
  for (int r = 0; r < rows; ++r) {
    const T* g = src + (size_t)(c0 + r) * Tn + base;
    for (int k = threadIdx.x % MOOG_WARP; k < len; k += MOOG_WARP) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(&tile[r][k]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                   :: "r"(dst), "l"(g + k), "n"(sizeof(T)) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;"
               ::: "memory");
}

template <typename T>
__device__ __forceinline__ void tile_flush(T (*tile)[TileLen<T>::value + 1],
                                           T* __restrict__ dst, int c0,
                                           int rows, long long Tn,
                                           long long base, int len) {
  for (int r = 0; r < rows; ++r) {
    T* g = dst + (size_t)(c0 + r) * Tn + base;
    for (int k = threadIdx.x % MOOG_WARP; k < len; k += MOOG_WARP)
      g[k] = tile[r][k];
  }
}

// A block is two warps over 32 channels of a (C, Tn) array, in tiles held
// in two shared-memory buffers. Warp 0 walks: walk(row, len) on tile i,
// x read and y written in place, each lane on its channel's row (lanes
// past C walk rows that are never stored). Warp 1 stages meanwhile: tile
// i - 1's y out of the other buffer (coalesced), then tile i + 1's x into
// it by cp.async. A block barrier ends each tile. So the walking warp
// issues nothing but the walk (one warp doing both spent ~140 cycles a
// sample more), and the staging has a whole tile's walk to land.
template <typename T, typename Walk>
__device__ __forceinline__ void tiled_walk(const T* __restrict__ x,
                                           T* __restrict__ y, int C,
                                           long long Tn, Walk walk) {
  constexpr int TILE = TileLen<T>::value;
  __shared__ T tile[2][MOOG_WARP][TILE + 1];
  const bool stager = threadIdx.x >= MOOG_WARP;
  const int c0 = blockIdx.x * MOOG_WARP;
  const int rows = min(MOOG_WARP, C - c0);
  const long long ntiles = (Tn + TILE - 1) / TILE;
  auto len_of = [&](long long i) {
    return (int)min((long long)TILE, Tn - i * TILE);
  };
  if (stager) tile_fetch(tile[0], x, c0, rows, Tn, 0, len_of(0));
  __syncthreads();
  for (long long i = 0; i < ntiles; ++i) {
    if (!stager) {
      walk(tile[i & 1][threadIdx.x], len_of(i));
    } else {
      T (*other)[TILE + 1] = tile[(i + 1) & 1];
      if (i > 0) tile_flush(other, y, c0, rows, Tn, (i - 1) * TILE, TILE);
      if (i + 1 < ntiles)
        tile_fetch(other, x, c0, rows, Tn, (i + 1) * TILE, len_of(i + 1));
    }
    __syncthreads();
  }
  if (stager)
    tile_flush(tile[(ntiles - 1) & 1], y, c0, rows, Tn, (ntiles - 1) * TILE,
               len_of(ntiles - 1));
}

template <typename T>
struct LadderParams {
  T coef, ds, k2, fb, ig, osc, osf;   // k2 = 2 log2(e) ds
  T t_hi, t_lo;                       // tanh(ds * +-32), float32 only
};

// The ladder state of one channel; fbv is the feedback value (s3, or
// 0.5 (s3 + prev) before Huovilainen's first step).
template <typename T>
struct LadderState {
  T s0, s1, s2, s3, t0, t1, t2, fbv;
};

template <typename T, int MODE>
__device__ __forceinline__ T tanh_ds(const LadderParams<T>& p, T v) {
  return ladder_tanh<T, MODE>(p.ds * v, p.k2 * v);
}

// One stage from its unclipped sum v: s = clip(v) and the tanh of ds * s,
// the float32 exact path with the clip beside the dependent path.
template <typename T, int MODE>
__device__ __forceinline__ T ladder_stage(const LadderParams<T>& p, T v,
                                          T& s) {
  s = clip(v, T(STATE_LIMIT));
  if constexpr (MODE != 1 && sizeof(T) == 4)
    return tanh_f32_clip(p.ds * v, p.k2 * v, v, p.t_hi, p.t_lo);
  else
    return tanh_ds<T, MODE>(p, s);
}

// d clip(v) / dv as jnp.clip takes it: 1 inside the bounds, 1/2 on them,
// 0 outside and for NaN
template <typename T>
__device__ __forceinline__ T clip_mask(T v) {
  const T a = v < T(0) ? -v : v;
  return a < T(STATE_LIMIT) ? T(1) : (a == T(STATE_LIMIT) ? T(0.5) : T(0));
}

// d tanh(z) / dz of the ladders' tanh from t = tanh(z); for _poly_tanh
// (MODE 1) from z: 9 (z^2 - 9)^2 / (27 + 9 z^2)^2, 0 where |z| > 3 (NaN
// stays NaN)
template <typename T, int MODE>
__device__ __forceinline__ T tanh_slope(T z, T t) {
  if constexpr (MODE == 1) {
    const T z2 = z * z;
    const T num = z2 - T(9);
    const T den = T(27) + T(9) * z2;
    const T r = T(9) * num * num / (den * den);
    return (z > T(3) || z < T(-3)) ? T(0) : r;
  } else {
    return T(1) - t * t;
  }
}

// Values a ladder step records for its reverse (LADDER_RECORD in
// ops/moog.py), each at rec[i * MOOG_WARP]: coef ds tanh'(ds u),
// ds tanh'(ds s_i) of the new stages 0-2, 1 - coef ds tanh'(ds s3) of the
// old s3, and the clip masks of the four stage sums.
constexpr int LADDER_RECORD = 9;

// One ladder step; returns s3 after it. The dependent path is
// s3 -> u -> t_in -> s0 -> t0 -> s1 -> t1 -> s2 -> t2 -> s3; the stage
// offsets and tanh(ds * s3) are formed beside it. RECORD also stores the
// step's LADDER_RECORD values at rec, off that path.
template <typename T, int MODE, bool RECORD = false>
__device__ __forceinline__ T ladder_step(const LadderParams<T>& p, T xv,
                                         LadderState<T>& st,
                                         T* rec = nullptr) {
  const T lim = T(STATE_LIMIT);
  const T s3_old = st.s3;
  const T ts3 = tanh_ds<T, MODE>(p, st.s3);
  const T k0 = mad(-p.coef, st.t0, st.s0);
  const T k1 = mad(-p.coef, st.t1, st.s1);
  const T k2 = mad(-p.coef, st.t2, st.s2);
  const T k3 = mad(-p.coef, ts3, st.s3);
  const T u = mad(-p.fb, st.fbv, xv * p.ig);
  const T t_in = tanh_ds<T, MODE>(p, u);
  const T v0 = mad(p.coef, t_in, k0);
  st.t0 = ladder_stage<T, MODE>(p, v0, st.s0);
  const T v1 = mad(p.coef, st.t0, k1);
  st.t1 = ladder_stage<T, MODE>(p, v1, st.s1);
  const T v2 = mad(p.coef, st.t1, k2);
  st.t2 = ladder_stage<T, MODE>(p, v2, st.s2);
  const T v3 = mad(p.coef, st.t2, k3);
  st.s3 = clip(v3, lim);
  st.fbv = st.s3;
  if constexpr (RECORD) {
    const T cd = p.coef * p.ds;
    rec[0] = cd * tanh_slope<T, MODE>(p.ds * u, t_in);
    rec[MOOG_WARP] = p.ds * tanh_slope<T, MODE>(p.ds * st.s0, st.t0);
    rec[2 * MOOG_WARP] = p.ds * tanh_slope<T, MODE>(p.ds * st.s1, st.t1);
    rec[3 * MOOG_WARP] = p.ds * tanh_slope<T, MODE>(p.ds * st.s2, st.t2);
    rec[4 * MOOG_WARP] = T(1) - cd * tanh_slope<T, MODE>(p.ds * s3_old, ts3);
    rec[5 * MOOG_WARP] = clip_mask(v0);
    rec[6 * MOOG_WARP] = clip_mask(v1);
    rec[7 * MOOG_WARP] = clip_mask(v2);
    rec[8 * MOOG_WARP] = clip_mask(v3);
  }
  return st.s3;
}

// The walk of one tile row: os ladder steps a sample, x * os on the
// first, y the last step's output scaled. OS > 0 fixes os at compile time:
// the ticks of a sample, and at OS = 1 or 2 four or two samples, are then
// one straight run of code (a taken branch costs a lone warp ~25 cycles);
// OS = 0 reads os at run time.
template <int OS, typename T, typename Step>
__device__ __forceinline__ void walk_row(T* row, int len, int os, T osf,
                                         T osc, Step step) {
  T xn = row[0];
  auto sample = [&](int k) {
    const T xv = xn * osf;
    xn = row[k + 1];   // the tile's padding column keeps this in the row
    T out = step(xv);
    if constexpr (OS > 0) {
#pragma unroll
      for (int tick = 1; tick < OS; ++tick) out = step(T(0));
    } else {
      for (int tick = 1; tick < os; ++tick) out = step(T(0));
    }
    row[k] = osc * out;
  };
#pragma unroll (OS == 1 ? 4 : OS == 2 ? 2 : 1)
  for (int k = 0; k < len; ++k) sample(k);
}

// Channel c's ladder state from state8 (8, C)
template <typename T, int MODE>
__device__ __forceinline__ LadderState<T> ladder_state_in(
    const LadderParams<T>& p, const T* __restrict__ st_in, int c, int C) {
  LadderState<T> st;
  st.s0 = st_in[c];
  st.s1 = st_in[C + c];
  st.s2 = st_in[2 * C + c];
  st.s3 = st_in[3 * C + c];
  if (MODE == 2) {
    // Huovilainen reads tanh(ds * s) of the state, not its rows 4-6
    st.t0 = tanh_ds<T, MODE>(p, st.s0);
    st.t1 = tanh_ds<T, MODE>(p, st.s1);
    st.t2 = tanh_ds<T, MODE>(p, st.s2);
    st.fbv = T(0.5) * (st.s3 + st_in[7 * C + c]);
  } else {
    st.t0 = st_in[4 * C + c];
    st.t1 = st_in[5 * C + c];
    st.t2 = st_in[6 * C + c];
    st.fbv = st.s3;
  }
  return st;
}

template <typename T>
__device__ __forceinline__ void ladder_state_out(T* __restrict__ st_out,
                                                 const LadderState<T>& st,
                                                 int c, int C) {
  st_out[c] = st.s0;
  st_out[C + c] = st.s1;
  st_out[2 * C + c] = st.s2;
  st_out[3 * C + c] = st.s3;
  st_out[4 * C + c] = st.t0;
  st_out[5 * C + c] = st.t1;
  st_out[6 * C + c] = st.t2;
  st_out[7 * C + c] = st.s3;
}

// The record of a recording instance (RECORD): rec (ceil(C / 32) blocks,
// T * os steps, nv values, 32 lanes), so that a block's record is
// contiguous and step-major and a warp's store of one value is one
// 128-byte line. The walking warp stores it straight to global memory,
// off the step's dependent path; the step's arithmetic is the same
// template code as without RECORD, so y and the state are bit-equal.
template <typename T>
__device__ __forceinline__ T* record_lane(T* rec, long long steps, int nv) {
  return rec == nullptr ? nullptr
                        : rec + static_cast<size_t>(blockIdx.x) * steps * nv *
                                    MOOG_WARP + threadIdx.x;
}

template <typename T, int MODE, int OS, bool RECORD>
__global__ void __launch_bounds__(2 * MOOG_WARP)
moog_ladder_kernel(const T* __restrict__ x, const T* __restrict__ st_in,
                   T* __restrict__ st_out, T* __restrict__ y,
                   T* __restrict__ rec, LadderParams<T> p, int C, long long Tn,
                   int os) {
  const int c = blockIdx.x * MOOG_WARP + threadIdx.x;
  const bool live = threadIdx.x < MOOG_WARP && c < C;
  if constexpr (sizeof(T) == 4) {
    p.t_hi = tanh_ds<T, MODE>(p, T(STATE_LIMIT));
    p.t_lo = tanh_ds<T, MODE>(p, T(-STATE_LIMIT));
  }
  LadderState<T> st{};
  if (live) st = ladder_state_in<T, MODE>(p, st_in, c, C);
  T* r = RECORD ? record_lane(rec, Tn * os, LADDER_RECORD) : nullptr;
  tiled_walk(x, y, C, Tn, [&](T* row, int len) {
    walk_row<OS>(row, len, os, p.osf, p.osc, [&](T xv) {
      if constexpr (RECORD) {
        const T out = ladder_step<T, MODE, true>(p, xv, st, r);
        r += LADDER_RECORD * MOOG_WARP;
        return out;
      } else {
        return ladder_step<T, MODE>(p, xv, st);
      }
    });
  });
  if (live) ladder_state_out(st_out, st, c, C);
}

template <typename T>
struct ZdfParams {
  T gk, shape, k, ig, osc, osf;
  T vs;        // gk / shape, from double on the host
  T gs, gsw;   // shape * vs, and times 2 log2(e)
  T sk, skw;   // shape * k, and times 2 log2(e)
  T sw;        // shape * 2 log2(e)
};

// One pass of the ZDF ladder at the estimate y3est: the four tanh of
// the stage inputs. Stage i + 1's argument shape * (v_i + s_i) is the
// FMA gs * ty_i + K_i, with K_i = shape * s_i - gs * ts_i per step;
// Kw = K * 2 log2(e) gives the float32 tanh its w beside it.
template <typename T>
__device__ __forceinline__ void zdf_pass(const ZdfParams<T>& p, T y3est,
                                         T zin, T zinw, const T (&K)[3],
                                         const T (&Kw)[3], T (&ty)[4]) {
  ty[0] = ladder_tanh<T, 0>(mad(-p.sk, y3est, zin), mad(-p.skw, y3est, zinw));
#pragma unroll
  for (int i = 0; i < 3; ++i)
    ty[i + 1] = ladder_tanh<T, 0>(mad(p.gs, ty[i], K[i]),
                                  mad(p.gsw, ty[i], Kw[i]));
}

template <typename T>
__device__ __forceinline__ T zdf_deriv(const ZdfParams<T>& p, T t) {
  return p.gk * mad(-t, t, T(1));
}

// Values a ZDF step records for its reverse (`zdf_record` in
// ops/moog.py), each at rec[i * MOOG_WARP]: 0-3 the tanh of the old
// stages, 4-7 the clip masks of the new ones, 8 + 6 it + (0-3, 4, 5) the
// four tanh, the Jacobian and the step of Newton iteration it, and
// 8 + 6 newton_iters + (0-3) the four tanh of the last pass.
constexpr int ZDF_UPDATE = 6;

__host__ __device__ constexpr int zdf_record(int newton_iters) {
  return 12 + ZDF_UPDATE * newton_iters;
}

// One ZDF step; s holds s0..s3, prev the last y3. Returns y3. RECORD also
// stores the step's zdf_record values at rec, off the dependent path.
template <typename T, bool RECORD = false>
__device__ __forceinline__ T zdf_step(const ZdfParams<T>& p, T xv, T (&s)[4],
                                      T& prev, int newton_iters,
                                      T* rec = nullptr) {
  const T lim = T(STATE_LIMIT);
  const T inp = xv * p.ig;
  const T zin = p.shape * inp;
  const T zinw = p.sw * inp;
  T ts[4], K[3], Kw[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) ts[i] = ladder_tanh<T, 0>(p.shape * s[i], p.sw * s[i]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    K[i] = mad(-p.gs, ts[i], p.shape * s[i]);
    Kw[i] = mad(-p.gsw, ts[i], p.sw * s[i]);
  }
  if constexpr (RECORD) {
#pragma unroll
    for (int i = 0; i < 4; ++i) rec[i * MOOG_WARP] = ts[i];
  }
  const T s3k = mad(-p.vs, ts[3], s[3]);
  T ty[4];
  T y3est = prev;
#pragma unroll 4
  for (int it = 0; it < newton_iters; ++it) {
    zdf_pass(p, y3est, zin, zinw, K, Kw, ty);
    const T y3 = mad(p.vs, ty[3], s3k);
    const T dprod = ((zdf_deriv(p, ty[0]) * zdf_deriv(p, ty[1])) *
                     zdf_deriv(p, ty[2])) * zdf_deriv(p, ty[3]);
    const T jac = mad(dprod, -p.k, T(-1));
    // |J| < 1e-15 keeps the estimate; a NaN Jacobian updates it
    const T step = quotient(y3 - y3est, jac);
    if constexpr (RECORD) {
      T* r = rec + (8 + ZDF_UPDATE * it) * MOOG_WARP;
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i * MOOG_WARP] = ty[i];
      r[4 * MOOG_WARP] = jac;
      r[5 * MOOG_WARP] = step;
    }
    y3est = (jac < T(0) ? -jac : jac) < T(1e-15) ? y3est : y3est - step;
  }
  zdf_pass(p, y3est, zin, zinw, K, Kw, ty);
  if constexpr (RECORD) {
    T* r = rec + (8 + ZDF_UPDATE * newton_iters) * MOOG_WARP;
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i * MOOG_WARP] = ty[i];
  }
  T v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = p.vs * (ty[i] - ts[i]);
  const T y3 = v[3] + s[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T w = mad(T(2), v[i], s[i]);
    if constexpr (RECORD) rec[(4 + i) * MOOG_WARP] = clip_mask(w);
    s[i] = clip(w, lim);
  }
  prev = y3;
  return y3;
}

template <typename T, int OS, bool RECORD>
__global__ void __launch_bounds__(2 * MOOG_WARP)
moog_zdf_kernel(const T* __restrict__ x, const T* __restrict__ st_in,
                T* __restrict__ st_out, T* __restrict__ y, T* __restrict__ rec,
                ZdfParams<T> p, int newton_iters, int C, long long Tn,
                int os) {
  const int c = blockIdx.x * MOOG_WARP + threadIdx.x;
  const bool live = threadIdx.x < MOOG_WARP && c < C;
  T s[4] = {T(0), T(0), T(0), T(0)};
  T prev = T(0);
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = st_in[i * C + c];
    prev = st_in[7 * C + c];
  }
  const int nv = zdf_record(newton_iters);
  T* r = RECORD ? record_lane(rec, Tn * os, nv) : nullptr;
  tiled_walk(x, y, C, Tn, [&](T* row, int len) {
    walk_row<OS>(row, len, os, p.osf, p.osc, [&](T xv) {
      if constexpr (RECORD) {
        const T out = zdf_step<T, true>(p, xv, s, prev, newton_iters, r);
        r += nv * MOOG_WARP;
        return out;
      } else {
        return zdf_step(p, xv, s, prev, newton_iters);
      }
    });
  });
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) st_out[i * C + c] = s[i];
    st_out[4 * C + c] = st_in[4 * C + c];
    st_out[5 * C + c] = st_in[5 * C + c];
    st_out[6 * C + c] = st_in[6 * C + c];
    st_out[7 * C + c] = prev;
  }
}

// ---------------------------------------------------------------------------
// The adjoints (A4): the VJP of the ladders' per-sample scan over the
// zero-stuffed input, the rule of algodsp_tpu/filters/moog.py::
// _kernel_chunk_diff (its backward is jax.vjp of _run_scan), for the
// cotangents gy (C, T) of y and gst (8, C) of the new state; they return
// dx (C, T) and dst (8, C). Two routes compute it, from the same step
// code and to the same bits:
//
//   the record route (ops/moog.py, when the record fits its budget): the
//   forward under autograd is K5 / K6 with RECORD, which stores each
//   step's record (LADDER_RECORD or zdf_record values) in rec; the
//   backward is moog_ladder_reverse_kernel / moog_zdf_reverse_kernel,
//   one reverse sweep over it;
//   the checkpoint route (moog_ladder_adjoint_kernel /
//   moog_zdf_adjoint_kernel, for a record over the budget): from (x,
//   state8) alone, one warp a block, one lane a channel. Walk 1 runs the
//   forward storing the state every `seg` steps into the checkpoint
//   scratch ck (nseg, 8, C); walk 2 takes the segments from last to
//   first, re-walks each from its checkpoint recording in shared memory
//   at [step][value][lane], and sweeps it backward. On request it returns
//   the final state8 its walk recomputed (the forward kernel's, bit for
//   bit).
//
// The record comes from the forward's own arithmetic, so the clip masks
// and tanh are the forward's. What bounds the reverse: its dependent
// chain, a ladder step's 12 multiplies and FMAs and the feedback's two, a
// ZDF step's reverse of its newton_iters + 1 passes and two quotients by
// J an update (IEEE divisions on the checkpoint route; on the record
// route a multiply and two FMAs each, from a reciprocal formed off the
// chain); the record it streams (36 bytes a ladder step and lane in
// float32, 48 + 24 newton_iters for ZDF) is far below the card's rate but
// must arrive a ring ahead (below). Measured on the H100
// (tools/moog_bench.py, PERF.md): at os >= 2 the walking warp's own
// instruction stream sets the pace (~60 instructions a ladder step around
// that chain; the reverse with no memory traffic at all is within 4%), at
// os 1 the staging warp's gy and dx, one pair of loops a sample. The
// checkpoint route walks the forward's chain twice more.

// x (scale osf, on a sample's first tick) or gy (scale osc, on its last)
// of steps [k0, k0 + len) into buf[s * MOOG_WARP], 0 on the other ticks
template <typename T>
__device__ __forceinline__ void stage_steps(T* buf,
                                            const T* __restrict__ src,
                                            T scale, bool live, size_t row,
                                            long long k0, int len, int os,
                                            int want) {
  long long n = k0 / os;
  int tick = static_cast<int>(k0 - n * os);
  for (int s = 0; s < len; ++s) {
    buf[s * MOOG_WARP] = live && tick == want ? src[row + n] * scale : T(0);
    if (++tick == os) {
      tick = 0;
      ++n;
    }
  }
}

// The cotangent of a ladder state: s0..s3 (s3 also carries the
// feedback's, which reads s3) and t0..t2
template <typename T>
struct LadderCotangent {
  T s0, s1, s2, s3, t0, t1, t2;
};

// One step's LADDER_RECORD values from r (stride MOOG_WARP) into registers
template <typename T>
__device__ __forceinline__ void ladder_load(T (&v)[LADDER_RECORD],
                                            const T* r) {
#pragma unroll
  for (int i = 0; i < LADDER_RECORD; ++i) v[i] = r[i * MOOG_WARP];
}

// Reverse of one ladder step from its record r, with gys its output's
// cotangent and wfb the share of the feedback's cotangent that reaches s3
// (1/2 on Huovilainen's first step, whose feedback is (s3 + prev) / 2,
// else 1). g goes from the state after the step to the state before it;
// returns d/du (u = x ig - fb feedback).
template <typename T>
__device__ __forceinline__ T ladder_reverse(const LadderParams<T>& p,
                                            const T (&r)[LADDER_RECORD],
                                            T gys, T wfb,
                                            LadderCotangent<T>& g) {
  g.s3 = g.s3 + gys;
  const T gv3 = r[8] * g.s3;
  g.t2 = mad(p.coef, gv3, g.t2);
  g.s2 = mad(r[3], g.t2, g.s2);
  const T gv2 = r[7] * g.s2;
  g.t1 = mad(p.coef, gv2, g.t1);
  g.s1 = mad(r[2], g.t1, g.s1);
  const T gv1 = r[6] * g.s1;
  g.t0 = mad(p.coef, gv1, g.t0);
  g.s0 = mad(r[1], g.t0, g.s0);
  const T gv0 = r[5] * g.s0;
  const T gu = r[0] * gv0;
  g.s0 = gv0;
  g.s1 = gv1;
  g.s2 = gv2;
  g.s3 = mad(wfb, -p.fb * gu, r[4] * gv3);
  g.t0 = -p.coef * gv0;
  g.t1 = -p.coef * gv1;
  g.t2 = -p.coef * gv2;
  return gu;
}

template <typename T>
__device__ __forceinline__ LadderCotangent<T> ladder_cotangent_in(
    const T* __restrict__ gst, int c, int C) {
  LadderCotangent<T> g;
  g.s0 = gst[c];
  g.s1 = gst[C + c];
  g.s2 = gst[2 * C + c];
  g.s3 = gst[3 * C + c] + gst[7 * C + c];
  g.t0 = gst[4 * C + c];
  g.t1 = gst[5 * C + c];
  g.t2 = gst[6 * C + c];
  return g;
}

// dst from the cotangent before the first step; gu is that step's d/du.
// Huovilainen's first step reads tanh(ds * s_i) of the input stages (rows
// 4-6 are never read) and prev through half its feedback.
template <typename T, int MODE>
__device__ __forceinline__ void ladder_adjoint_out(
    const LadderParams<T>& p, const T* __restrict__ st_in,
    LadderCotangent<T> g, T gu, T* __restrict__ dst, int c, int C) {
  T gprev = T(0);
  if constexpr (MODE == 2) {
    const T ts[3] = {tanh_ds<T, MODE>(p, st_in[c]),
                     tanh_ds<T, MODE>(p, st_in[C + c]),
                     tanh_ds<T, MODE>(p, st_in[2 * C + c])};
    g.s0 = mad(g.t0, p.ds * (T(1) - ts[0] * ts[0]), g.s0);
    g.s1 = mad(g.t1, p.ds * (T(1) - ts[1] * ts[1]), g.s1);
    g.s2 = mad(g.t2, p.ds * (T(1) - ts[2] * ts[2]), g.s2);
    g.t0 = g.t1 = g.t2 = T(0);
    gprev = T(0.5) * (-p.fb * gu);
  }
  dst[c] = g.s0;
  dst[C + c] = g.s1;
  dst[2 * C + c] = g.s2;
  dst[3 * C + c] = g.s3;
  dst[4 * C + c] = g.t0;
  dst[5 * C + c] = g.t1;
  dst[6 * C + c] = g.t2;
  dst[7 * C + c] = gprev;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(MOOG_WARP)
moog_ladder_adjoint_kernel(const T* __restrict__ x, const T* __restrict__ st_in,
                           const T* __restrict__ gy, const T* __restrict__ gst,
                           T* __restrict__ dx, T* __restrict__ dst,
                           T* __restrict__ ck, T* __restrict__ st_fin,
                           LadderParams<T> p, int C, long long Tn, int os,
                           int seg) {
  constexpr int W = MOOG_WARP;
  extern __shared__ __align__(16) unsigned char adj_smem[];
  T* xs = reinterpret_cast<T*>(adj_smem) + threadIdx.x;
  T* gys = xs + seg * W;
  T* rec = gys + seg * W;
  const int c = blockIdx.x * W + threadIdx.x;
  const bool live = c < C;
  const size_t row = static_cast<size_t>(live ? c : 0) * Tn;
  if constexpr (sizeof(T) == 4) {
    p.t_hi = tanh_ds<T, MODE>(p, T(STATE_LIMIT));
    p.t_lo = tanh_ds<T, MODE>(p, T(-STATE_LIMIT));
  }
  const long long steps = Tn * os;
  const long long nseg = (steps + seg - 1) / seg;
  auto seg_len = [&](long long j) {
    return static_cast<int>(min(static_cast<long long>(seg), steps - j * seg));
  };
  auto ck_at = [&](long long j, int r) {
    return ck + (static_cast<size_t>(j) * 8 + r) * C + c;
  };
  LadderState<T> st{};
  if (live) st = ladder_state_in<T, MODE>(p, st_in, c, C);
  // walk 1: the forward, a checkpoint at each segment's start
  for (long long j = 0; j < nseg; ++j) {
    if (live) {
      *ck_at(j, 0) = st.s0;
      *ck_at(j, 1) = st.s1;
      *ck_at(j, 2) = st.s2;
      *ck_at(j, 3) = st.s3;
      *ck_at(j, 4) = st.t0;
      *ck_at(j, 5) = st.t1;
      *ck_at(j, 6) = st.t2;
      *ck_at(j, 7) = st.fbv;
    }
    const int len = seg_len(j);
    stage_steps(xs, x, p.osf, live, row, j * seg, len, os, 0);
    for (int s = 0; s < len; ++s)
      ladder_step<T, MODE>(p, xs[s * W], st);
  }
  if (live && st_fin != nullptr) ladder_state_out(st_fin, st, c, C);
  // walk 2: each segment again from its checkpoint, recorded, then swept
  // backward
  LadderCotangent<T> g{};
  if (live) g = ladder_cotangent_in(gst, c, C);
  T gu = T(0);
  for (long long j = nseg - 1; j >= 0; --j) {
    const long long k0 = j * seg;
    const int len = seg_len(j);
    if (live) {
      st.s0 = *ck_at(j, 0);
      st.s1 = *ck_at(j, 1);
      st.s2 = *ck_at(j, 2);
      st.s3 = *ck_at(j, 3);
      st.t0 = *ck_at(j, 4);
      st.t1 = *ck_at(j, 5);
      st.t2 = *ck_at(j, 6);
      st.fbv = *ck_at(j, 7);
    }
    stage_steps(xs, x, p.osf, live, row, k0, len, os, 0);
    stage_steps(gys, gy, p.osc, live, row, k0, len, os, os - 1);
    for (int s = 0; s < len; ++s)
      ladder_step<T, MODE, true>(p, xs[s * W], st,
                                 rec + s * LADDER_RECORD * W);
    long long n = (k0 + len - 1) / os;
    int tick = static_cast<int>(k0 + len - 1 - n * os);
    for (int s = len - 1; s >= 0; --s) {
      const T wfb = MODE == 2 && k0 + s == 0 ? T(0.5) : T(1);
      T r[LADDER_RECORD];
      ladder_load(r, rec + s * LADDER_RECORD * W);
      gu = ladder_reverse(p, r, gys[s * W], wfb, g);
      if (live && tick == 0) dx[row + n] = p.osf * (p.ig * gu);
      if (--tick < 0) {
        tick = os - 1;
        --n;
      }
    }
  }
  if (live) ladder_adjoint_out<T, MODE>(p, st_in, g, gu, dst, c, C);
}

// Reverse of one ZDF ladder pass at its four tanh ty, given the
// cotangents gv of v0..v3 and gty added to the tanh (from the Jacobian);
// adds to gs, gts (the old stages' tanh) and ginp. Returns d/d y3est.
// ty_{i+1} = tanh(shape (vs (ty_i - ts_i) + s_i)),
// ty_0 = tanh(shape (inp - k y3est)).
template <typename T>
__device__ __forceinline__ T zdf_pass_reverse(const ZdfParams<T>& p,
                                              const T (&ty)[4],
                                              const T (&gv)[4],
                                              const T (&gty)[4], T (&gs)[4],
                                              T (&gts)[4], T& ginp) {
  T gt = mad(p.vs, gv[3], gty[3]);
  gts[3] = mad(-p.vs, gv[3], gts[3]);
#pragma unroll
  for (int i = 3; i >= 1; --i) {
    const T t = ty[i];
    const T gyy = gt * (p.shape * (T(1) - t * t));
    gs[i - 1] = gs[i - 1] + gyy;
    const T gvv = gv[i - 1] + gyy;
    gts[i - 1] = mad(-p.vs, gvv, gts[i - 1]);
    gt = mad(p.vs, gvv, gty[i - 1]);
  }
  const T t0 = ty[0];
  const T gz = gt * (p.shape * (T(1) - t0 * t0));
  ginp = ginp + gz;
  return -p.k * gz;
}

// What a ZDF step's reverse reads first, loaded ahead into registers: the
// four clip masks, the last pass's tanh and the last Newton update's
// ZDF_UPDATE values (four tanh, J, step)
template <typename T>
struct ZdfHead {
  T m[4], ty[4], it[ZDF_UPDATE];
};

template <typename T>
__device__ __forceinline__ void zdf_head(ZdfHead<T>& h, const T* r,
                                         int newton_iters) {
  constexpr int W = MOOG_WARP;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h.m[i] = r[(4 + i) * W];
    h.ty[i] = r[(8 + ZDF_UPDATE * newton_iters + i) * W];
  }
#pragma unroll
  for (int v = 0; v < ZDF_UPDATE; ++v)
    h.it[v] = r[(8 + ZDF_UPDATE * (newton_iters - 1) + v) * W];
}

// 1 / v correctly rounded (IEEE)
__device__ __forceinline__ float reciprocal(float v) { return __frcp_rn(v); }
__device__ __forceinline__ double reciprocal(double v) { return __drcp_rn(v); }

// a / b from b's correctly rounded reciprocal rb: q = a rb and one
// correction by the residual a - b q (exact as an FMA). That is the
// correctly rounded quotient, IEEE division's, wherever neither the
// quotient nor the residual over- or underflows (Markstein): on a
// dependent chain, a multiply and two FMAs instead of a division, whose
// own reciprocal and special-case branch wait on a.
template <typename T>
__device__ __forceinline__ T divide_by(T a, T b, T rb) {
  const T q = a * rb;
  return mad(mad(-b, q, a), rb, q);
}

// Reverse of one ZDF step from its record r (stride MOOG_WARP) and its
// head h, with gys its output's cotangent: gS (the stages) and gP (prev,
// the step's y3) go from the state after the step to the state before it.
// The Newton updates y3est' = y3est - q, q = (y3 - y3est) / J,
// J = -k prod_i D_i - 1, D_i = gk (1 - ty_i^2), are reversed in turn, each
// update's values loaded while the one after it is reversed; one that
// kept its estimate (|J| < 1e-15) passes the cotangent through. Its two
// quotients by J are IEEE divisions, or with RCP divide_by with 1 / J
// formed from the J loaded ahead, off the chain. Returns d/d inp.
template <typename T, bool RCP>
__device__ __forceinline__ T zdf_reverse(const ZdfParams<T>& p,
                                         const ZdfHead<T>& h, const T* r,
                                         T gys, int newton_iters, T (&gS)[4],
                                         T& gP) {
  constexpr int W = MOOG_WARP;
  T ts[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ts[i] = r[i * W];
  const T gy3 = gP + gys;
  T gs[4], gv[4], gts[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    gs[i] = h.m[i] * gS[i];
    gv[i] = T(2) * gs[i];
  }
  gv[3] = gv[3] + gy3;
  gs[3] = gs[3] + gy3;
  T ginp = T(0);
  const T none[4] = {T(0), T(0), T(0), T(0)};
  T ge = zdf_pass_reverse(p, h.ty, gv, none, gs, gts, ginp);
  T cur[ZDF_UPDATE];
#pragma unroll
  for (int v = 0; v < ZDF_UPDATE; ++v) cur[v] = h.it[v];
  for (int it = newton_iters - 1; it >= 0; --it) {
    // the update before this one (this one's again at it = 0)
    T nxt[ZDF_UPDATE];
    const T* rn = r + (8 + ZDF_UPDATE * (it > 0 ? it - 1 : 0)) * W;
#pragma unroll
    for (int v = 0; v < ZDF_UPDATE; ++v) nxt[v] = rn[v * W];
    const T jac = cur[4];
    const T rjac = RCP ? reciprocal(jac) : T(0);
    if (!((jac < T(0) ? -jac : jac) < T(1e-15))) {
      const T q = cur[5];
      const T gq = -ge;
      const T gr = RCP ? divide_by(gq, jac, rjac) : gq / jac;
      const T gj = RCP ? divide_by(-gq * q, jac, rjac) : -gq * q / jac;
      ge = ge - gr;
      const T gdprod = -p.k * gj;
      T t[4], d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        t[i] = cur[i];
        d[i] = p.gk * (T(1) - t[i] * t[i]);
      }
      const T others[4] = {d[1] * d[2] * d[3], d[0] * d[2] * d[3],
                           d[0] * d[1] * d[3], d[0] * d[1] * d[2]};
      T gty[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        gty[i] = gdprod * others[i] * (T(-2) * p.gk * t[i]);
      const T gvn[4] = {T(0), T(0), T(0), gr};
      gs[3] = gs[3] + gr;
      ge = ge + zdf_pass_reverse(p, t, gvn, gty, gs, gts, ginp);
    }
#pragma unroll
    for (int v = 0; v < ZDF_UPDATE; ++v) cur[v] = nxt[v];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    gS[i] = mad(gts[i], p.shape * (T(1) - ts[i] * ts[i]), gs[i]);
  gP = ge;
  return ginp;
}

// dst of the ZDF ladder: the stages' and prev's cotangents; rows 4-6 pass
// through
template <typename T>
__device__ __forceinline__ void zdf_adjoint_out(const T (&gS)[4], T gP,
                                                const T* __restrict__ gst,
                                                T* __restrict__ dst, int c,
                                                int C) {
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i * C + c] = gS[i];
  dst[4 * C + c] = gst[4 * C + c];
  dst[5 * C + c] = gst[5 * C + c];
  dst[6 * C + c] = gst[6 * C + c];
  dst[7 * C + c] = gP;
}

template <typename T>
__global__ void __launch_bounds__(MOOG_WARP)
moog_zdf_adjoint_kernel(const T* __restrict__ x, const T* __restrict__ st_in,
                        const T* __restrict__ gy, const T* __restrict__ gst,
                        T* __restrict__ dx, T* __restrict__ dst,
                        T* __restrict__ ck, T* __restrict__ st_fin,
                        ZdfParams<T> p, int newton_iters, int C, long long Tn,
                        int os, int seg) {
  constexpr int W = MOOG_WARP;
  const int nv = zdf_record(newton_iters);
  extern __shared__ __align__(16) unsigned char adj_smem[];
  T* xs = reinterpret_cast<T*>(adj_smem) + threadIdx.x;
  T* gys = xs + seg * W;
  T* rec = gys + seg * W;
  const int c = blockIdx.x * W + threadIdx.x;
  const bool live = c < C;
  const size_t row = static_cast<size_t>(live ? c : 0) * Tn;
  const long long steps = Tn * os;
  const long long nseg = (steps + seg - 1) / seg;
  auto seg_len = [&](long long j) {
    return static_cast<int>(min(static_cast<long long>(seg), steps - j * seg));
  };
  auto ck_at = [&](long long j, int r) {
    return ck + (static_cast<size_t>(j) * 8 + r) * C + c;
  };
  T s[4] = {T(0), T(0), T(0), T(0)};
  T prev = T(0);
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = st_in[i * C + c];
    prev = st_in[7 * C + c];
  }
  // walk 1: the forward, a checkpoint at each segment's start
  for (long long j = 0; j < nseg; ++j) {
    if (live) {
#pragma unroll
      for (int i = 0; i < 4; ++i) *ck_at(j, i) = s[i];
      *ck_at(j, 4) = prev;
    }
    const int len = seg_len(j);
    stage_steps(xs, x, p.osf, live, row, j * seg, len, os, 0);
    for (int k = 0; k < len; ++k)
      zdf_step(p, xs[k * W], s, prev, newton_iters);
  }
  if (live && st_fin != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) st_fin[i * C + c] = s[i];
    st_fin[4 * C + c] = st_in[4 * C + c];
    st_fin[5 * C + c] = st_in[5 * C + c];
    st_fin[6 * C + c] = st_in[6 * C + c];
    st_fin[7 * C + c] = prev;
  }
  // walk 2: each segment again from its checkpoint, recorded, then swept
  // backward
  T gS[4] = {T(0), T(0), T(0), T(0)};
  T gP = T(0);
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) gS[i] = gst[i * C + c];
    gP = gst[7 * C + c];
  }
  for (long long j = nseg - 1; j >= 0; --j) {
    const long long k0 = j * seg;
    const int len = seg_len(j);
    if (live) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = *ck_at(j, i);
      prev = *ck_at(j, 4);
    }
    stage_steps(xs, x, p.osf, live, row, k0, len, os, 0);
    stage_steps(gys, gy, p.osc, live, row, k0, len, os, os - 1);
    for (int k = 0; k < len; ++k)
      zdf_step<T, true>(p, xs[k * W], s, prev, newton_iters,
                        rec + k * nv * W);
    long long n = (k0 + len - 1) / os;
    int tick = static_cast<int>(k0 + len - 1 - n * os);
    for (int k = len - 1; k >= 0; --k) {
      ZdfHead<T> h;
      zdf_head(h, rec + k * nv * W, newton_iters);
      const T ginp = zdf_reverse<T, false>(p, h, rec + k * nv * W,
                                           gys[k * W], newton_iters, gS, gP);
      if (live && tick == 0) dx[row + n] = p.osf * (p.ig * ginp);
      if (--tick < 0) {
        tick = os - 1;
        --n;
      }
    }
  }
  if (live) zdf_adjoint_out(gS, gP, gst, dst, c, C);
}

// ---------------------------------------------------------------------------
// The reverse kernels of the record route: moog_ladder_reverse_kernel and
// moog_zdf_reverse_kernel sweep the record rec (ceil(C / 32), T * os, nv,
// 32) of a recording K5 / K6 backward, for the cotangents gy (C, T) and
// gst (8, C), with the reverse step code of the checkpoint route, so dx
// and dst are its bits.
//
// A block is two warps over 32 channels. The staging warp streams the
// block's record backward in time, RevPlan::rt steps a stage, into a ring
// of REV_STAGES shared-memory stages: one thread asks for each stage's
// record as one TMA bulk copy (cp.async.bulk), and the warp stages beside
// it the gy of the samples whose last tick lies in the stage, coalesced,
// at the base rate, by cp.async; both complete on the stage's `full`
// mbarrier, so the staging warp waits on nothing but a free stage. The
// walking warp (one lane a channel) waits on `full`, runs the stage's
// steps backward with each step's record values loaded into registers
// while the step before runs, adds gy on a sample's last tick only, writes
// dx into the stage on its first tick, and arrives on `empty`; the staging
// warp then flushes that dx, coalesced, before it refills the stage. So
// the walking warp runs only the sweep and a few shared-memory loads a
// step, and three stages of record are in flight while it works on the
// fourth (the ladder reads ~1.1 KB a step a block, every ~63 cycles).

constexpr int REV_STAGES = 4;
constexpr size_t REV_STAGE_BYTES = 24 * 1024;   // record bytes a stage, about
constexpr size_t REV_BARRIER_BYTES = 128;       // the mbarriers, before the ring

struct RevPlan {
  int nv;       // record values a step
  int rt;       // steps a stage
  int g;        // samples a stage (gy in, dx out): ceil(rt / os) at most
  int stage;    // elements of a stage: record, gy, dx; 16-byte multiple
};

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of bar has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One element from global src to shared dst by cp.async, not waited for
template <typename T>
__device__ __forceinline__ void async_load(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
               :: "r"(smem_u32(dst)), "l"(src), "n"(sizeof(T)) : "memory");
}

// Arrive on bar once this thread's cp.async copies so far have landed
// (one of the arrivals bar was initialised to expect)
__device__ __forceinline__ void mbar_arrive_async(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global
// src to shared dst, completed on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The ring for a block: the stager's loop, and the walker's, which calls
// walk(rec, gy, dx, start, end) on each stage from the last in time to the
// first: its lane's record at rec[(k * nv + v) * MOOG_WARP] for step
// start + k, gy of sample n at gy[(n - start / os) * (MOOG_WARP + 1)] and
// dx of sample n at dx[(n - ceil(start / os)) * (MOOG_WARP + 1)].
template <typename T, typename Walk>
__device__ __forceinline__ void reverse_ring(const T* __restrict__ rec,
                                             const T* __restrict__ gy,
                                             T* __restrict__ dx, int C,
                                             long long Tn, int os,
                                             const RevPlan& pl, Walk walk) {
  constexpr int W = MOOG_WARP;
  extern __shared__ __align__(128) unsigned char rev_smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(rev_smem);
  unsigned long long* empty = full + REV_STAGES;
  T* ring = reinterpret_cast<T*>(rev_smem + REV_BARRIER_BYTES);
  const int lane = threadIdx.x % W;
  const int c0 = blockIdx.x * W;
  const int rows = min(W, C - c0);
  const long long steps = Tn * os;
  const long long ntiles = (steps + pl.rt - 1) / pl.rt;
  const size_t step_elems = static_cast<size_t>(pl.nv) * W;
  const size_t gy_at = pl.rt * step_elems;
  const size_t dx_at = gy_at + static_cast<size_t>(pl.g) * (W + 1);
  const T* rec_b = rec + static_cast<size_t>(blockIdx.x) * steps * step_elems;
  if (threadIdx.x == 0) {
    for (int i = 0; i < REV_STAGES; ++i) {
      mbar_init(&full[i], W + 1);   // the copy's thread twice, the others once
      mbar_init(&empty[i], W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // stage t of the sweep holds steps [start, end), tile ntiles - 1 - t
  auto span = [&](long long t, long long& start, long long& end) {
    start = (ntiles - 1 - t) * pl.rt;
    end = min(start + pl.rt, steps);
  };
  auto slot = [&](long long t) {
    return ring + static_cast<size_t>(t % REV_STAGES) * pl.stage;
  };
  if (threadIdx.x >= W) {
    // the (row, sample) pairs of a stage over the lanes, a row's samples
    // on consecutive lanes (a stage holds few samples a row); unrolled, so
    // that the pairs' index arithmetic and loads overlap (at os 1 these
    // loops, not the walk, set the pace)
    auto flush = [&](long long t) {
      long long start, end;
      span(t, start, end);
      const long long n0 = (start + os - 1) / os;
      const int m = static_cast<int>((end + os - 1) / os - n0);
      const T* src = slot(t) + dx_at;
#pragma unroll 4
      for (int i = lane; i < rows * m; i += W) {
        const int r = i / m, j = i - r * m;
        dx[static_cast<size_t>(c0 + r) * Tn + n0 + j] = src[j * (W + 1) + r];
      }
    };
    for (long long t = 0; t < ntiles; ++t) {
      const int s = static_cast<int>(t % REV_STAGES);
      const unsigned use = static_cast<unsigned>(t / REV_STAGES);
      if (use > 0) {
        mbar_wait(&empty[s], (use - 1) & 1);
        flush(t - REV_STAGES);
      }
      long long start, end;
      span(t, start, end);
      T* dst = slot(t);
      if (lane == 0) {
        const unsigned bytes =
            static_cast<unsigned>((end - start) * step_elems * sizeof(T));
        mbar_arrive_tx(&full[s], bytes);
        bulk_load(dst, rec_b + start * step_elems, bytes, &full[s]);
      }
      const long long n0 = start / os;
      const int m = static_cast<int>(end / os - n0);
#pragma unroll 4
      for (int i = lane; i < rows * m; i += W) {
        const int r = i / m, j = i - r * m;
        async_load(&dst[gy_at + j * (W + 1) + r],
                   gy + static_cast<size_t>(c0 + r) * Tn + n0 + j);
      }
      mbar_arrive_async(&full[s]);
    }
    for (long long t = max(0LL, ntiles - REV_STAGES); t < ntiles; ++t) {
      mbar_wait(&empty[t % REV_STAGES],
                static_cast<unsigned>(t / REV_STAGES) & 1);
      flush(t);
    }
  } else {
    for (long long t = 0; t < ntiles; ++t) {
      mbar_wait(&full[t % REV_STAGES],
                static_cast<unsigned>(t / REV_STAGES) & 1);
      long long start, end;
      span(t, start, end);
      T* at = slot(t) + lane;
      walk(static_cast<const T*>(at), static_cast<const T*>(at + gy_at),
           at + dx_at, start, end);
      mbar_arrive(&empty[t % REV_STAGES]);
    }
  }
}

// The walker's side of one stage: steps [start, end) backward, the
// record of each step loaded (load(regs, j) for the stage's step j) and
// its output cotangent (osc gy on a sample's last tick, as the checkpoint
// route's staging scales it, else 0) read while the step after it is
// reversed by rev(regs, j, gys), which returns d/d inp; dx = dx_scale
// d/d inp is written on a sample's first tick. Indices within the stage
// are 32-bit.
template <int OS, typename T, typename Regs, typename Load, typename Rev>
__device__ __forceinline__ void reverse_stage(const T* gy, T* dx,
                                              long long start, long long end,
                                              int os, T osc, T dx_scale,
                                              Load load, Rev rev) {
  constexpr int W = MOOG_WARP;
  const int os_ = OS > 0 ? OS : os;
  const long long n_last = (end - 1) / os_;
  int tick = static_cast<int>(end - 1 - n_last * os_);
  // the current sample's place among the stage's gy and dx samples
  int gi = static_cast<int>(n_last - start / os_) * (W + 1);
  int di = static_cast<int>(n_last - (start + os_ - 1) / os_) * (W + 1);
  Regs cur;
  load(cur, static_cast<int>(end - 1 - start));
  T gcur = tick == os_ - 1 ? gy[gi] * osc : T(0);
  for (int j = static_cast<int>(end - 1 - start); j >= 0; --j) {
    const bool first = tick == 0;
    const int tick_n = first ? os_ - 1 : tick - 1;
    const int gi_n = first ? gi - (W + 1) : gi;
    // the next step's values, loaded unconditionally (a branch around the
    // loads costs more than they do): at j = 0 step 0's again, and a gy
    // slot that may lie one sample before the stage's, in its record
    Regs nxt;
    load(nxt, j > 0 ? j - 1 : 0);
    const T gl = gy[gi_n] * osc;
    const T gnxt = tick_n == os_ - 1 ? gl : T(0);
    const T d = rev(cur, j, gcur);
    if (first) {
      dx[di] = dx_scale * d;
      di -= W + 1;
    }
    tick = tick_n;
    gi = gi_n;
    cur = nxt;
    gcur = gnxt;
  }
}

template <typename T>
struct LadderRegs {
  T v[LADDER_RECORD];
};

template <typename T, int MODE, int OS>
__global__ void __launch_bounds__(2 * MOOG_WARP)
moog_ladder_reverse_kernel(const T* __restrict__ rec,
                           const T* __restrict__ st_in,
                           const T* __restrict__ gy, const T* __restrict__ gst,
                           T* __restrict__ dx, T* __restrict__ dst,
                           LadderParams<T> p, RevPlan pl, int C, long long Tn,
                           int os) {
  constexpr int W = MOOG_WARP;
  const int c = blockIdx.x * W + threadIdx.x;
  const bool live = threadIdx.x < W && c < C;
  LadderCotangent<T> g{};
  if (live) g = ladder_cotangent_in(gst, c, C);
  T gu = T(0);
  reverse_ring(rec, gy, dx, C, Tn, os, pl,
               [&](const T* r, const T* gys, T* dxs, long long start,
                   long long end) {
    reverse_stage<OS, T, LadderRegs<T>>(
        gys, dxs, start, end, os, p.osc, p.osf,
        [&](LadderRegs<T>& v, int j) {
          ladder_load(v.v, r + j * LADDER_RECORD * W);
        },
        [&](const LadderRegs<T>& v, int j, T gyv) {
          const T wfb = MODE == 2 && start == 0 && j == 0 ? T(0.5) : T(1);
          gu = ladder_reverse(p, v.v, gyv, wfb, g);
          return p.ig * gu;
        });
  });
  if (live) ladder_adjoint_out<T, MODE>(p, st_in, g, gu, dst, c, C);
}

template <typename T, int OS>
__global__ void __launch_bounds__(2 * MOOG_WARP)
moog_zdf_reverse_kernel(const T* __restrict__ rec, const T* __restrict__ gy,
                        const T* __restrict__ gst, T* __restrict__ dx,
                        T* __restrict__ dst, ZdfParams<T> p, RevPlan pl,
                        int newton_iters, int C, long long Tn, int os) {
  constexpr int W = MOOG_WARP;
  const int c = blockIdx.x * W + threadIdx.x;
  const bool live = threadIdx.x < W && c < C;
  T gS[4] = {T(0), T(0), T(0), T(0)};
  T gP = T(0);
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) gS[i] = gst[i * C + c];
    gP = gst[7 * C + c];
  }
  const int nv = pl.nv;
  reverse_ring(rec, gy, dx, C, Tn, os, pl,
               [&](const T* r, const T* gys, T* dxs, long long start,
                   long long end) {
    reverse_stage<OS, T, ZdfHead<T>>(
        gys, dxs, start, end, os, p.osc, p.osf,
        [&](ZdfHead<T>& h, int j) {
          zdf_head(h, r + j * nv * W, newton_iters);
        },
        [&](const ZdfHead<T>& h, int j, T gyv) {
          return p.ig * zdf_reverse<T, true>(p, h, r + j * nv * W, gyv,
                                             newton_iters, gS, gP);
        });
  });
  if (live) zdf_adjoint_out(gS, gP, gst, dst, c, C);
}

// The kernel instance for os: float32 takes the chain's factors 1, 2, 4
// and 8 (`moog_oversampling_from_order`) at compile time, any other os
// and float64 at run time.
template <typename T, template <int> class Pick>
auto pick_os(int os) {
  if constexpr (sizeof(T) == 4) {
    switch (os) {
      case 1: return Pick<1>::get();
      case 2: return Pick<2>::get();
      case 4: return Pick<4>::get();
      case 8: return Pick<8>::get();
    }
  }
  return Pick<0>::get();
}

template <typename T, int MODE, bool RECORD>
struct LadderPick {
  template <int OS>
  struct At {
    static auto get() { return &moog_ladder_kernel<T, MODE, OS, RECORD>; }
  };
};

template <typename T, bool RECORD>
struct ZdfPick {
  template <int OS>
  struct At {
    static auto get() { return &moog_zdf_kernel<T, OS, RECORD>; }
  };
};

template <typename T, int MODE>
struct LadderReversePick {
  template <int OS>
  struct At {
    static auto get() { return &moog_ladder_reverse_kernel<T, MODE, OS>; }
  };
};

template <typename T>
struct ZdfReversePick {
  template <int OS>
  struct At {
    static auto get() { return &moog_zdf_reverse_kernel<T, OS>; }
  };
};

template <typename T>
LadderParams<T> ladder_params(double p0, double p1, double p2, double p3,
                              double p4, int os) {
  return LadderParams<T>{T(p0), T(p1), T(LOG2E_X2 * p1), T(p2), T(p3),
                         T(p4), T(os), T(0), T(0)};
}

template <typename T>
ZdfParams<T> zdf_params(double p0, double p1, double p2, double p3,
                        double p4, int os) {
  ZdfParams<T> p;
  p.gk = T(p0);
  p.shape = T(p1);
  p.k = T(p2);
  p.ig = T(p3);
  p.osc = T(p4);
  p.osf = T(os);
  p.vs = T(p0 / p1);   // as the plain version takes it
  p.gs = p.shape * p.vs;
  p.gsw = T(LOG2E_X2 * double(p.gs));
  p.sk = p.shape * p.k;
  p.skw = T(LOG2E_X2 * double(p.sk));
  p.sw = T(LOG2E_X2 * double(p.shape));
  return p;
}

template <typename T, bool RECORD>
auto ladder_kernel(int mode, int os) {
  return mode == 0   ? pick_os<T, LadderPick<T, 0, RECORD>::template At>(os)
         : mode == 1 ? pick_os<T, LadderPick<T, 1, RECORD>::template At>(os)
                     : pick_os<T, LadderPick<T, 2, RECORD>::template At>(os);
}

template <typename T>
int launch_ladder(const T* x, const T* st_in, T* st_out, T* y, T* rec,
                  double p0, double p1, double p2, double p3, double p4,
                  int C, long long Tn, int mode, int os, void* stream) {
  if (C < 1 || Tn < 1 || mode < 0 || mode > 2 || os < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const LadderParams<T> p = ladder_params<T>(p0, p1, p2, p3, p4, os);
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = rec == nullptr ? ladder_kernel<T, false>(mode, os)
                               : ladder_kernel<T, true>(mode, os);
  kernel<<<grid, 2 * MOOG_WARP, 0, s>>>(x, st_in, st_out, y, rec, p, C, Tn,
                                        os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_zdf(const T* x, const T* st_in, T* st_out, T* y, T* rec,
               double p0, double p1, double p2, double p3, double p4, int C,
               long long Tn, int newton_iters, int os, void* stream) {
  if (C < 1 || Tn < 1 || newton_iters < 1 || newton_iters > 8 || os < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ZdfParams<T> p = zdf_params<T>(p0, p1, p2, p3, p4, os);
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  auto kernel = rec == nullptr ? pick_os<T, ZdfPick<T, false>::template At>(os)
                               : pick_os<T, ZdfPick<T, true>::template At>(os);
  kernel<<<grid, 2 * MOOG_WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      x, st_in, st_out, y, rec, p, newton_iters, C, Tn, os);
  return static_cast<int>(cudaGetLastError());
}

// The reverse kernels' stages: about REV_STAGE_BYTES of record, and the gy
// and dx of the samples those steps touch
template <typename T>
RevPlan rev_plan(int nv, int os) {
  RevPlan pl;
  pl.nv = nv;
  const size_t step_bytes = static_cast<size_t>(nv) * MOOG_WARP * sizeof(T);
  pl.rt = static_cast<int>(std::max<size_t>(1, REV_STAGE_BYTES / step_bytes));
  pl.g = (pl.rt + os - 1) / os;
  const size_t bytes = step_bytes * pl.rt +
                       2 * static_cast<size_t>(pl.g) * (MOOG_WARP + 1) * sizeof(T);
  pl.stage = static_cast<int>((bytes + 15) / 16 * 16 / sizeof(T));
  return pl;
}

template <typename T>
size_t rev_smem(const RevPlan& pl) {
  return REV_BARRIER_BYTES + REV_STAGES * static_cast<size_t>(pl.stage) * sizeof(T);
}

// Launch a reverse kernel with `smem` bytes of dynamic shared memory,
// raising its limit past 48 KB the first time each kernel asks
template <typename K, typename... Args>
int launch_reverse(K kernel, dim3 grid, size_t smem, cudaStream_t s,
                   Args... args) {
  static const void* raised[64];
  static size_t raised_to[64];
  static int n_raised = 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  int i = 0;
  while (i < n_raised && raised[i] != key) ++i;
  if (i == n_raised || raised_to[i] < smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (i == n_raised && n_raised < 64) raised[n_raised++] = key;
    if (i < n_raised) raised_to[i] = smem;
  }
  kernel<<<grid, 2 * MOOG_WARP, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ladder_reverse(const T* rec, const T* st_in, const T* gy,
                          const T* gst, T* dx, T* dst, double p0, double p1,
                          double p2, double p3, double p4, int C,
                          long long Tn, int mode, int os, void* stream) {
  if (C < 1 || Tn < 1 || mode < 0 || mode > 2 || os < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const LadderParams<T> p = ladder_params<T>(p0, p1, p2, p3, p4, os);
  const RevPlan pl = rev_plan<T>(LADDER_RECORD, os);
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  auto kernel =
      mode == 0   ? pick_os<T, LadderReversePick<T, 0>::template At>(os)
      : mode == 1 ? pick_os<T, LadderReversePick<T, 1>::template At>(os)
                  : pick_os<T, LadderReversePick<T, 2>::template At>(os);
  return launch_reverse(kernel, grid, rev_smem<T>(pl),
                        static_cast<cudaStream_t>(stream), rec, st_in, gy,
                        gst, dx, dst, p, pl, C, Tn, os);
}

template <typename T>
int launch_zdf_reverse(const T* rec, const T* gy, const T* gst, T* dx, T* dst,
                       double p0, double p1, double p2, double p3, double p4,
                       int C, long long Tn, int newton_iters, int os,
                       void* stream) {
  if (C < 1 || Tn < 1 || newton_iters < 1 || newton_iters > 8 || os < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ZdfParams<T> p = zdf_params<T>(p0, p1, p2, p3, p4, os);
  const RevPlan pl = rev_plan<T>(zdf_record(newton_iters), os);
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  auto kernel = pick_os<T, ZdfReversePick<T>::template At>(os);
  return launch_reverse(kernel, grid, rev_smem<T>(pl),
                        static_cast<cudaStream_t>(stream), rec, gy, gst, dx,
                        dst, p, pl, newton_iters, C, Tn, os);
}

// The adjoints' shared memory: seg steps of x, cotangent and record, at
// most the 48 KB a block takes without opting in
constexpr size_t ADJ_SMEM_LIMIT = 48 * 1024;

template <typename T>
size_t adjoint_smem(int seg, int record) {
  return static_cast<size_t>(seg) * (record + 2) * MOOG_WARP * sizeof(T);
}

template <typename T>
int launch_ladder_adjoint(const T* x, const T* st_in, const T* gy,
                          const T* gst, T* dx, T* dst, T* ck, T* st_fin,
                          double p0, double p1, double p2, double p3,
                          double p4, int C, long long Tn, int mode, int os,
                          int seg, void* stream) {
  if (C < 1 || Tn < 1 || mode < 0 || mode > 2 || os < 1 || seg < 1 ||
      adjoint_smem<T>(seg, LADDER_RECORD) > ADJ_SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const LadderParams<T> p = ladder_params<T>(p0, p1, p2, p3, p4, os);
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  auto kernel = mode == 0   ? &moog_ladder_adjoint_kernel<T, 0>
                : mode == 1 ? &moog_ladder_adjoint_kernel<T, 1>
                            : &moog_ladder_adjoint_kernel<T, 2>;
  kernel<<<grid, MOOG_WARP, adjoint_smem<T>(seg, LADDER_RECORD),
           static_cast<cudaStream_t>(stream)>>>(
      x, st_in, gy, gst, dx, dst, ck, st_fin, p, C, Tn, os, seg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_zdf_adjoint(const T* x, const T* st_in, const T* gy, const T* gst,
                       T* dx, T* dst, T* ck, T* st_fin, double p0, double p1,
                       double p2, double p3, double p4, int C, long long Tn,
                       int newton_iters, int os, int seg, void* stream) {
  if (C < 1 || Tn < 1 || newton_iters < 1 || newton_iters > 8 || os < 1 ||
      seg < 1 ||
      adjoint_smem<T>(seg, zdf_record(newton_iters)) > ADJ_SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const ZdfParams<T> p = zdf_params<T>(p0, p1, p2, p3, p4, os);
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  moog_zdf_adjoint_kernel<T><<<grid, MOOG_WARP,
                               adjoint_smem<T>(seg, zdf_record(newton_iters)),
                               static_cast<cudaStream_t>(stream)>>>(
      x, st_in, gy, gst, dx, dst, ck, st_fin, p, newton_iters, C, Tn, os,
      seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (C, T) at the base rate; st_in, st_out: (8, C). mode 0 classic
// (tanh), 1 classic (rational tanh), 2 Huovilainen; os >= 1 ladder steps
// per sample. rec null runs K5 / K6; otherwise the recording instance
// stores each step's record in rec (ceil(C / 32), T * os, nv, 32), nv =
// LADDER_RECORD or zdf_record(newton_iters). Return cudaGetLastError()
// after the launch.
int moog_ladder_f32(const float* x, const float* st_in, float* st_out,
                    float* y, float* rec, double p0, double p1, double p2,
                    double p3, double p4, int C, long long T, int mode, int os,
                    void* stream) {
  return launch_ladder<float>(x, st_in, st_out, y, rec, p0, p1, p2, p3, p4, C,
                              T, mode, os, stream);
}

int moog_ladder_f64(const double* x, const double* st_in, double* st_out,
                    double* y, double* rec, double p0, double p1, double p2,
                    double p3, double p4, int C, long long T, int mode, int os,
                    void* stream) {
  return launch_ladder<double>(x, st_in, st_out, y, rec, p0, p1, p2, p3, p4,
                               C, T, mode, os, stream);
}

int moog_zdf_f32(const float* x, const float* st_in, float* st_out, float* y,
                 float* rec, double p0, double p1, double p2, double p3,
                 double p4, int C, long long T, int newton_iters, int os,
                 void* stream) {
  return launch_zdf<float>(x, st_in, st_out, y, rec, p0, p1, p2, p3, p4, C, T,
                           newton_iters, os, stream);
}

int moog_zdf_f64(const double* x, const double* st_in, double* st_out,
                 double* y, double* rec, double p0, double p1, double p2,
                 double p3, double p4, int C, long long T, int newton_iters,
                 int os, void* stream) {
  return launch_zdf<double>(x, st_in, st_out, y, rec, p0, p1, p2, p3, p4, C, T,
                            newton_iters, os, stream);
}

// The reverse kernels: rec as the recording instances write it; gy, dx
// (C, T); st_in, gst, dst (8, C). Return cudaGetLastError() after the
// launch (or the error of raising the kernel's shared-memory limit).
int moog_ladder_reverse_f32(const float* rec, const float* st_in,
                            const float* gy, const float* gst, float* dx,
                            float* dst, double p0, double p1, double p2,
                            double p3, double p4, int C, long long T, int mode,
                            int os, void* stream) {
  return launch_ladder_reverse<float>(rec, st_in, gy, gst, dx, dst, p0, p1,
                                      p2, p3, p4, C, T, mode, os, stream);
}

int moog_ladder_reverse_f64(const double* rec, const double* st_in,
                            const double* gy, const double* gst, double* dx,
                            double* dst, double p0, double p1, double p2,
                            double p3, double p4, int C, long long T, int mode,
                            int os, void* stream) {
  return launch_ladder_reverse<double>(rec, st_in, gy, gst, dx, dst, p0, p1,
                                       p2, p3, p4, C, T, mode, os, stream);
}

int moog_zdf_reverse_f32(const float* rec, const float* st_in,
                         const float* gy, const float* gst, float* dx,
                         float* dst, double p0, double p1, double p2,
                         double p3, double p4, int C, long long T,
                         int newton_iters, int os, void* stream) {
  (void)st_in;   // ZDF's reverse reads none of the state in
  return launch_zdf_reverse<float>(rec, gy, gst, dx, dst, p0, p1, p2, p3, p4,
                                   C, T, newton_iters, os, stream);
}

int moog_zdf_reverse_f64(const double* rec, const double* st_in,
                         const double* gy, const double* gst, double* dx,
                         double* dst, double p0, double p1, double p2,
                         double p3, double p4, int C, long long T,
                         int newton_iters, int os, void* stream) {
  (void)st_in;
  return launch_zdf_reverse<double>(rec, gy, gst, dx, dst, p0, p1, p2, p3, p4,
                                    C, T, newton_iters, os, stream);
}

// The adjoints: x, gy, dx (C, T); st_in, gst, dst, st_fin (8, C); ck the
// checkpoint scratch (ceil(T * os / seg), 8, C); st_fin may be null.
// seg steps a segment (ops/moog.py::adjoint_plan). Return
// cudaGetLastError() after the launch.
int moog_ladder_adjoint_f32(const float* x, const float* st_in,
                            const float* gy, const float* gst, float* dx,
                            float* dst, float* ck, float* st_fin, double p0,
                            double p1, double p2, double p3, double p4, int C,
                            long long T, int mode, int os, int seg,
                            void* stream) {
  return launch_ladder_adjoint<float>(x, st_in, gy, gst, dx, dst, ck, st_fin,
                                      p0, p1, p2, p3, p4, C, T, mode, os, seg,
                                      stream);
}

int moog_ladder_adjoint_f64(const double* x, const double* st_in,
                            const double* gy, const double* gst, double* dx,
                            double* dst, double* ck, double* st_fin,
                            double p0, double p1, double p2, double p3,
                            double p4, int C, long long T, int mode, int os,
                            int seg, void* stream) {
  return launch_ladder_adjoint<double>(x, st_in, gy, gst, dx, dst, ck,
                                       st_fin, p0, p1, p2, p3, p4, C, T, mode,
                                       os, seg, stream);
}

int moog_zdf_adjoint_f32(const float* x, const float* st_in, const float* gy,
                         const float* gst, float* dx, float* dst, float* ck,
                         float* st_fin, double p0, double p1, double p2,
                         double p3, double p4, int C, long long T,
                         int newton_iters, int os, int seg, void* stream) {
  return launch_zdf_adjoint<float>(x, st_in, gy, gst, dx, dst, ck, st_fin, p0,
                                   p1, p2, p3, p4, C, T, newton_iters, os, seg,
                                   stream);
}

int moog_zdf_adjoint_f64(const double* x, const double* st_in,
                         const double* gy, const double* gst, double* dx,
                         double* dst, double* ck, double* st_fin, double p0,
                         double p1, double p2, double p3, double p4, int C,
                         long long T, int newton_iters, int os, int seg,
                         void* stream) {
  return launch_zdf_adjoint<double>(x, st_in, gy, gst, dx, dst, ck, st_fin,
                                    p0, p1, p2, p3, p4, C, T, newton_iters, os,
                                    seg, stream);
}

}  // extern "C"
