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

// One ladder step; returns s3 after it. The dependent path is
// s3 -> u -> t_in -> s0 -> t0 -> s1 -> t1 -> s2 -> t2 -> s3; the stage
// offsets and tanh(ds * s3) are formed beside it.
template <typename T, int MODE>
__device__ __forceinline__ T ladder_step(const LadderParams<T>& p, T xv,
                                         LadderState<T>& st) {
  const T lim = T(STATE_LIMIT);
  const T k0 = mad(-p.coef, st.t0, st.s0);
  const T k1 = mad(-p.coef, st.t1, st.s1);
  const T k2 = mad(-p.coef, st.t2, st.s2);
  const T k3 = mad(-p.coef, tanh_ds<T, MODE>(p, st.s3), st.s3);
  const T t_in = tanh_ds<T, MODE>(p, mad(-p.fb, st.fbv, xv * p.ig));
  st.t0 = ladder_stage<T, MODE>(p, mad(p.coef, t_in, k0), st.s0);
  st.t1 = ladder_stage<T, MODE>(p, mad(p.coef, st.t0, k1), st.s1);
  st.t2 = ladder_stage<T, MODE>(p, mad(p.coef, st.t1, k2), st.s2);
  st.s3 = clip(mad(p.coef, st.t2, k3), lim);
  st.fbv = st.s3;
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
  if (live) {
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
  }
  tiled_walk(x, y, C, Tn, [&](T* row, int len) {
    walk_row<OS>(row, len, os, p.osf, p.osc,
                 [&](T xv) { return ladder_step<T, MODE>(p, xv, st); });
  });
  if (live) {
    st_out[c] = st.s0;
    st_out[C + c] = st.s1;
    st_out[2 * C + c] = st.s2;
    st_out[3 * C + c] = st.s3;
    st_out[4 * C + c] = st.t0;
    st_out[5 * C + c] = st.t1;
    st_out[6 * C + c] = st.t2;
    st_out[7 * C + c] = st.s3;
  }
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

// One ZDF step; s holds s0..s3, prev the last y3. Returns y3.
template <typename T>
__device__ __forceinline__ T zdf_step(const ZdfParams<T>& p, T xv, T (&s)[4],
                                      T& prev, int newton_iters) {
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
    y3est = (jac < T(0) ? -jac : jac) < T(1e-15) ? y3est : y3est - step;
  }
  zdf_pass(p, y3est, zin, zinw, K, Kw, ty);
  T v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = p.vs * (ty[i] - ts[i]);
  const T y3 = v[3] + s[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = clip(mad(T(2), v[i], s[i]), lim);
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
int launch_ladder(const T* x, const T* st_in, T* st_out, T* y, double p0,
                  double p1, double p2, double p3, double p4, int C,
                  long long Tn, int mode, int os, void* stream) {
  if (C < 1 || Tn < 1 || mode < 0 || mode > 2 || os < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const LadderParams<T> p{T(p0), T(p1), T(LOG2E_X2 * p1), T(p2), T(p3),
                          T(p4), T(os), T(0), T(0)};
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
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  auto kernel = pick_os<T, ZdfPick<T>::template At>(os);
  kernel<<<grid, 2 * MOOG_WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      x, st_in, st_out, y, p, newton_iters, C, Tn, os);
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

}  // extern "C"
