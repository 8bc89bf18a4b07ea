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

template <typename T, int MODE, int OS>
__global__ void __launch_bounds__(2 * MOOG_WARP)
moog_ladder_kernel(const T* __restrict__ x, const T* __restrict__ st_in,
                   T* __restrict__ st_out, T* __restrict__ y,
                   LadderParams<T> p, int C, long long Tn, int os) {
  const int c = blockIdx.x * MOOG_WARP + threadIdx.x;
  const bool live = threadIdx.x < MOOG_WARP && c < C;
  if constexpr (sizeof(T) == 4) {
    p.t_hi = tanh_ds<T, MODE>(p, T(STATE_LIMIT));
    p.t_lo = tanh_ds<T, MODE>(p, T(-STATE_LIMIT));
  }
  LadderState<T> st{};
  if (live) st = ladder_state_in<T, MODE>(p, st_in, c, C);
  tiled_walk(x, y, C, Tn, [&](T* row, int len) {
    walk_row<OS>(row, len, os, p.osf, p.osc,
                 [&](T xv) { return ladder_step<T, MODE>(p, xv, st); });
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
__host__ __device__ constexpr int zdf_record(int newton_iters) {
  return 12 + 6 * newton_iters;
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
      T* r = rec + (8 + 6 * it) * MOOG_WARP;
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i * MOOG_WARP] = ty[i];
      r[4 * MOOG_WARP] = jac;
      r[5 * MOOG_WARP] = step;
    }
    y3est = (jac < T(0) ? -jac : jac) < T(1e-15) ? y3est : y3est - step;
  }
  zdf_pass(p, y3est, zin, zinw, K, Kw, ty);
  if constexpr (RECORD) {
    T* r = rec + (8 + 6 * newton_iters) * MOOG_WARP;
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

template <typename T, int OS>
__global__ void __launch_bounds__(2 * MOOG_WARP)
moog_zdf_kernel(const T* __restrict__ x, const T* __restrict__ st_in,
                T* __restrict__ st_out, T* __restrict__ y, ZdfParams<T> p,
                int newton_iters, int C, long long Tn, int os) {
  const int c = blockIdx.x * MOOG_WARP + threadIdx.x;
  const bool live = threadIdx.x < MOOG_WARP && c < C;
  T s[4] = {T(0), T(0), T(0), T(0)};
  T prev = T(0);
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = st_in[i * C + c];
    prev = st_in[7 * C + c];
  }
  tiled_walk(x, y, C, Tn, [&](T* row, int len) {
    walk_row<OS>(row, len, os, p.osf, p.osc,
                 [&](T xv) { return zdf_step(p, xv, s, prev, newton_iters); });
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
// dx (C, T) and dst (8, C), and on request the final state8 their own
// walk recomputed (the forward kernel's, bit for bit).
//
// One warp a block, one lane a channel. Walk 1 runs the forward with the
// forward's own step code and stores the state every `seg` steps into
// the checkpoint scratch ck (nseg, 8, C). Walk 2 takes the segments from
// last to first: it restarts at a checkpoint, walks the segment's steps
// again recording what each step's reverse reads (LADDER_RECORD or
// zdf_record values, in shared memory at [step][value][lane]), then
// sweeps them backward carrying the cotangent of the state. The record
// comes from the forward's own arithmetic, so the clip masks and tanh
// values are the forward's. Each lane stages its own channel's x and
// cotangents of a segment (one per step) in shared memory first, so
// their loads are issued together and no lane waits on another.
//
// What bounds them: the same dependent chain as the forward, walked twice
// (checkpoints, then each segment again), plus the reverse chain (a
// ladder step's is 12 dependent multiplies and FMAs; a ZDF step's
// reverses each of its newton_iters + 1 passes). Bytes (x, y, cotangents,
// the scratch) are far below it.

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

// Reverse of one ladder step from its record r (stride MOOG_WARP), with
// gys its output's cotangent and wfb the share of the feedback's
// cotangent that reaches s3 (1/2 on Huovilainen's first step, whose
// feedback is (s3 + prev) / 2, else 1). g goes from the state after the
// step to the state before it; returns d/du (u = x ig - fb feedback).
template <typename T>
__device__ __forceinline__ T ladder_reverse(const LadderParams<T>& p,
                                            const T* r, T gys, T wfb,
                                            LadderCotangent<T>& g) {
  constexpr int W = MOOG_WARP;
  g.s3 = g.s3 + gys;
  const T gv3 = r[8 * W] * g.s3;
  g.t2 = mad(p.coef, gv3, g.t2);
  g.s2 = mad(r[3 * W], g.t2, g.s2);
  const T gv2 = r[7 * W] * g.s2;
  g.t1 = mad(p.coef, gv2, g.t1);
  g.s1 = mad(r[2 * W], g.t1, g.s1);
  const T gv1 = r[6 * W] * g.s1;
  g.t0 = mad(p.coef, gv1, g.t0);
  g.s0 = mad(r[W], g.t0, g.s0);
  const T gv0 = r[5 * W] * g.s0;
  const T gu = r[0] * gv0;
  g.s0 = gv0;
  g.s1 = gv1;
  g.s2 = gv2;
  g.s3 = mad(wfb, -p.fb * gu, r[4 * W] * gv3);
  g.t0 = -p.coef * gv0;
  g.t1 = -p.coef * gv1;
  g.t2 = -p.coef * gv2;
  return gu;
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
  if (live) {
    g.s0 = gst[c];
    g.s1 = gst[C + c];
    g.s2 = gst[2 * C + c];
    g.s3 = gst[3 * C + c] + gst[7 * C + c];
    g.t0 = gst[4 * C + c];
    g.t1 = gst[5 * C + c];
    g.t2 = gst[6 * C + c];
  }
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
      gu = ladder_reverse(p, rec + s * LADDER_RECORD * W, gys[s * W], wfb, g);
      if (live && tick == 0) dx[row + n] = p.osf * (p.ig * gu);
      if (--tick < 0) {
        tick = os - 1;
        --n;
      }
    }
  }
  if (!live) return;
  T gprev = T(0);
  if constexpr (MODE == 2) {
    // the first step's tanh(ds * s_i) of the input stages, and the half of
    // its feedback that reads prev; rows 4-6 are never read
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

// Reverse of one ZDF ladder pass at its four tanh ty (stride MOOG_WARP),
// given the cotangents gv of v0..v3 and gty added to the tanh (from the
// Jacobian); adds to gs, gts (the old stages' tanh) and ginp. Returns
// d/d y3est. ty_{i+1} = tanh(shape (vs (ty_i - ts_i) + s_i)),
// ty_0 = tanh(shape (inp - k y3est)).
template <typename T>
__device__ __forceinline__ T zdf_pass_reverse(const ZdfParams<T>& p,
                                              const T* ty, const T (&gv)[4],
                                              const T (&gty)[4], T (&gs)[4],
                                              T (&gts)[4], T& ginp) {
  constexpr int W = MOOG_WARP;
  T gt = mad(p.vs, gv[3], gty[3]);
  gts[3] = mad(-p.vs, gv[3], gts[3]);
#pragma unroll
  for (int i = 3; i >= 1; --i) {
    const T t = ty[i * W];
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

// Reverse of one ZDF step from its record r (stride MOOG_WARP), with gys
// its output's cotangent: gS (the stages) and gP (prev, the step's y3) go
// from the state after the step to the state before it. The Newton
// updates y3est' = y3est - q, q = (y3 - y3est) / J, J = -k prod_i D_i - 1,
// D_i = gk (1 - ty_i^2), are reversed in turn; one that kept its estimate
// (|J| < 1e-15) passes the cotangent through. Returns d/d inp.
template <typename T>
__device__ __forceinline__ T zdf_reverse(const ZdfParams<T>& p, const T* r,
                                         T gys, int newton_iters, T (&gS)[4],
                                         T& gP) {
  constexpr int W = MOOG_WARP;
  const T gy3 = gP + gys;
  T gs[4], gv[4], gts[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    gs[i] = r[(4 + i) * W] * gS[i];
    gv[i] = T(2) * gs[i];
  }
  gv[3] = gv[3] + gy3;
  gs[3] = gs[3] + gy3;
  T ginp = T(0);
  const T none[4] = {T(0), T(0), T(0), T(0)};
  T ge = zdf_pass_reverse(p, r + (8 + 6 * newton_iters) * W, gv, none, gs,
                          gts, ginp);
  for (int it = newton_iters - 1; it >= 0; --it) {
    const T* rp = r + (8 + 6 * it) * W;
    const T jac = rp[4 * W];
    if ((jac < T(0) ? -jac : jac) < T(1e-15)) continue;
    const T q = rp[5 * W];
    const T gq = -ge;
    const T gr = gq / jac;
    const T gj = -gq * q / jac;
    ge = ge - gr;
    const T gdprod = -p.k * gj;
    T t[4], d[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[i] = rp[i * W];
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
    ge = ge + zdf_pass_reverse(p, rp, gvn, gty, gs, gts, ginp);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T t = r[i * W];
    gS[i] = mad(gts[i], p.shape * (T(1) - t * t), gs[i]);
  }
  gP = ge;
  return ginp;
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
      const T ginp = zdf_reverse(p, rec + k * nv * W, gys[k * W],
                                 newton_iters, gS, gP);
      if (live && tick == 0) dx[row + n] = p.osf * (p.ig * ginp);
      if (--tick < 0) {
        tick = os - 1;
        --n;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i * C + c] = gS[i];
  // rows 4-6 pass through the ZDF ladder
  dst[4 * C + c] = gst[4 * C + c];
  dst[5 * C + c] = gst[5 * C + c];
  dst[6 * C + c] = gst[6 * C + c];
  dst[7 * C + c] = gP;
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

template <typename T, int MODE>
struct LadderPick {
  template <int OS>
  struct At {
    static auto get() { return &moog_ladder_kernel<T, MODE, OS>; }
  };
};

template <typename T>
struct ZdfPick {
  template <int OS>
  struct At {
    static auto get() { return &moog_zdf_kernel<T, OS>; }
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

template <typename T>
int launch_ladder(const T* x, const T* st_in, T* st_out, T* y, double p0,
                  double p1, double p2, double p3, double p4, int C,
                  long long Tn, int mode, int os, void* stream) {
  if (C < 1 || Tn < 1 || mode < 0 || mode > 2 || os < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const LadderParams<T> p = ladder_params<T>(p0, p1, p2, p3, p4, os);
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = mode == 0   ? pick_os<T, LadderPick<T, 0>::template At>(os)
                : mode == 1 ? pick_os<T, LadderPick<T, 1>::template At>(os)
                            : pick_os<T, LadderPick<T, 2>::template At>(os);
  kernel<<<grid, 2 * MOOG_WARP, 0, s>>>(x, st_in, st_out, y, p, C, Tn, os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_zdf(const T* x, const T* st_in, T* st_out, T* y, double p0,
               double p1, double p2, double p3, double p4, int C, long long Tn,
               int newton_iters, int os, void* stream) {
  if (C < 1 || Tn < 1 || newton_iters < 1 || newton_iters > 8 || os < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ZdfParams<T> p = zdf_params<T>(p0, p1, p2, p3, p4, os);
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  auto kernel = pick_os<T, ZdfPick<T>::template At>(os);
  kernel<<<grid, 2 * MOOG_WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      x, st_in, st_out, y, p, newton_iters, C, Tn, os);
  return static_cast<int>(cudaGetLastError());
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
// per sample. Return cudaGetLastError() after the launch.
int moog_ladder_f32(const float* x, const float* st_in, float* st_out,
                    float* y, double p0, double p1, double p2, double p3,
                    double p4, int C, long long T, int mode, int os,
                    void* stream) {
  return launch_ladder<float>(x, st_in, st_out, y, p0, p1, p2, p3, p4, C, T,
                              mode, os, stream);
}

int moog_ladder_f64(const double* x, const double* st_in, double* st_out,
                    double* y, double p0, double p1, double p2, double p3,
                    double p4, int C, long long T, int mode, int os,
                    void* stream) {
  return launch_ladder<double>(x, st_in, st_out, y, p0, p1, p2, p3, p4, C, T,
                               mode, os, stream);
}

int moog_zdf_f32(const float* x, const float* st_in, float* st_out, float* y,
                 double p0, double p1, double p2, double p3, double p4, int C,
                 long long T, int newton_iters, int os, void* stream) {
  return launch_zdf<float>(x, st_in, st_out, y, p0, p1, p2, p3, p4, C, T,
                           newton_iters, os, stream);
}

int moog_zdf_f64(const double* x, const double* st_in, double* st_out,
                 double* y, double p0, double p1, double p2, double p3,
                 double p4, int C, long long T, int newton_iters, int os,
                 void* stream) {
  return launch_zdf<double>(x, st_in, st_out, y, p0, p1, p2, p3, p4, C, T,
                            newton_iters, os, stream);
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
