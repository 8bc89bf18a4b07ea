// Nonlinear Moog ladders for Hopper, float32 and float64.
//
// Two kernels, each over x (C, T) with the state8 (8, C) layout
// [s0, s1, s2, s3, t0, t1, t2, prev] of the TPU kernels, five scalar
// parameters in the order algodsp_tpu/filters/moog.py::_kernel_chunk
// builds them, and the output y (C, T) and the new state8:
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
// Every stage is clipped to +-32 (STATE_LIMIT). tanh is tanhf/tanh and
// the divisions are IEEE: the hardware tanh.approx.f32 is far coarser
// than the 1e-5 bar against the plain scan. Any T >= 1 runs here,
// and the state out is the carry after the last real sample (the TPU
// path sent only whole 1024-sample chunks to Pallas and the tail to a
// scan).
//
// What bounds them on the H100: the ladder feeds its output back every
// sample through tanh, so time cannot be split; each channel is a chain
// of T dependent steps, each a chain of 5 dependent tanh evaluations
// with their FMAs (the classic and Huovilainen ladders) or of
// 4 * (newton_iters + 1) (ZDF). That latency, some hundreds of cycles a
// step, bounds the kernel whatever the channel count up to the card's
// thread count; the byte bound (read x, write y: 8 bytes a sample) and
// the operation bound are orders of magnitude below it.
//
// Design: one thread per channel with the eight state values in
// registers (a run-time-indexed local array would go through local
// memory), 32 channels (one warp) per block so that 64 or 128 channels
// spread over several SMs. The warp stages x through shared memory in
// tiles of MOOG_TILE samples per channel, loaded and stored row by row
// (coalesced), and each thread walks its row of the tile, writing y in
// place of x.

#include <cuda_runtime.h>

#define MOOG_WARP 32
#define MOOG_TILE 128

namespace {

__device__ __forceinline__ float tanh_exact(float v) { return tanhf(v); }
__device__ __forceinline__ double tanh_exact(double v) { return tanh(v); }

// clip as jnp.clip: NaN passes through
template <typename T>
__device__ __forceinline__ T clip(T v, T lim) {
  return v < -lim ? -lim : (v > lim ? lim : v);
}

// |v|, NaN passing through
template <typename T>
__device__ __forceinline__ T magnitude(T v) {
  return v < T(0) ? -v : v;
}

// algodsp_tpu/ops/pallas_kernels.py::_poly_tanh
template <typename T>
__device__ __forceinline__ T poly_tanh(T v) {
  if (v > T(3)) return T(1);
  if (v < T(-3)) return T(-1);
  const T x2 = v * v;
  return clip(v * (T(27) + x2) / (T(27) + T(9) * x2), T(1));
}

template <typename T, int MODE>
__device__ __forceinline__ T stage_tanh(T v) {
  if (MODE == 1) return poly_tanh(v);
  return tanh_exact(v);
}

// Load rows [c0, c0 + rows) x [base, base + len) of src (C, T) into the
// tile, each row's samples on consecutive lanes.
template <typename T>
__device__ __forceinline__ void tile_load(T (*tile)[MOOG_TILE + 1],
                                          const T* __restrict__ src,
                                          int c0, int rows, long long Tn,
                                          long long base, int len) {
  for (int e = threadIdx.x; e < rows * len; e += MOOG_WARP) {
    const int r = e / len, k = e - r * len;
    tile[r][k] = src[(size_t)(c0 + r) * Tn + base + k];
  }
}

template <typename T>
__device__ __forceinline__ void tile_store(T (*tile)[MOOG_TILE + 1],
                                           T* __restrict__ dst, int c0,
                                           int rows, long long Tn,
                                           long long base, int len) {
  for (int e = threadIdx.x; e < rows * len; e += MOOG_WARP) {
    const int r = e / len, k = e - r * len;
    dst[(size_t)(c0 + r) * Tn + base + k] = tile[r][k];
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(MOOG_WARP)
moog_ladder_kernel(const T* __restrict__ x, const T* __restrict__ st_in,
                   T* __restrict__ st_out, T* __restrict__ y, T coef, T ds,
                   T fb, T ig, T osc, int C, long long Tn) {
  __shared__ T tile[MOOG_WARP][MOOG_TILE + 1];
  const T lim = T(32);
  const int c0 = blockIdx.x * MOOG_WARP;
  const int rows = min(MOOG_WARP, C - c0);
  const int c = c0 + threadIdx.x;
  const bool live = threadIdx.x < rows;
  T s0 = 0, s1 = 0, s2 = 0, s3 = 0, t0 = 0, t1 = 0, t2 = 0, prev = 0;
  if (live) {
    s0 = st_in[c];
    s1 = st_in[C + c];
    s2 = st_in[2 * C + c];
    s3 = st_in[3 * C + c];
    t0 = st_in[4 * C + c];
    t1 = st_in[5 * C + c];
    t2 = st_in[6 * C + c];
    prev = st_in[7 * C + c];
  }
  for (long long base = 0; base < Tn; base += MOOG_TILE) {
    const int len = (int)min((long long)MOOG_TILE, Tn - base);
    tile_load(tile, x, c0, rows, Tn, base, len);
    __syncwarp();
    if (live) {
      T* row = tile[threadIdx.x];
      for (int k = 0; k < len; ++k) {
        const T xv = row[k];
        T s0n, s1n, s2n, s3n, t0n, t1n, t2n;
        if (MODE == 2) {
          const T u = xv * ig - fb * (T(0.5) * (s3 + prev));
          const T t_in = tanh_exact(ds * u);
          const T ts0 = tanh_exact(ds * s0);
          const T ts1 = tanh_exact(ds * s1);
          const T ts2 = tanh_exact(ds * s2);
          const T ts3 = tanh_exact(ds * s3);
          s0n = clip(s0 + coef * (t_in - ts0), lim);
          t0n = tanh_exact(ds * s0n);
          s1n = clip(s1 + coef * (t0n - ts1), lim);
          t1n = tanh_exact(ds * s1n);
          s2n = clip(s2 + coef * (t1n - ts2), lim);
          t2n = tanh_exact(ds * s2n);
          s3n = clip(s3 + coef * (t2n - ts3), lim);
        } else {
          const T u = xv * ig - fb * s3;
          const T t_in = stage_tanh<T, MODE>(ds * u);
          const T ts3 = stage_tanh<T, MODE>(ds * s3);
          s0n = clip(s0 + coef * (t_in - t0), lim);
          t0n = stage_tanh<T, MODE>(ds * s0n);
          s1n = clip(s1 + coef * (t0n - t1), lim);
          t1n = stage_tanh<T, MODE>(ds * s1n);
          s2n = clip(s2 + coef * (t1n - t2), lim);
          t2n = stage_tanh<T, MODE>(ds * s2n);
          s3n = clip(s3 + coef * (t2n - ts3), lim);
        }
        s0 = s0n;
        s1 = s1n;
        s2 = s2n;
        s3 = s3n;
        t0 = t0n;
        t1 = t1n;
        t2 = t2n;
        prev = s3n;
        row[k] = osc * s3n;
      }
    }
    __syncwarp();
    tile_store(tile, y, c0, rows, Tn, base, len);
    __syncwarp();
  }
  if (live) {
    st_out[c] = s0;
    st_out[C + c] = s1;
    st_out[2 * C + c] = s2;
    st_out[3 * C + c] = s3;
    st_out[4 * C + c] = t0;
    st_out[5 * C + c] = t1;
    st_out[6 * C + c] = t2;
    st_out[7 * C + c] = prev;
  }
}

// One pass of the ZDF ladder at the estimate y3est: the stage
// increments v0..v3, y3, and the product of the stage derivatives.
template <typename T>
__device__ __forceinline__ void zdf_ladder(T y3est, T inp, T k, T shape,
                                           T gk, T v_scale, T s0, T s1, T s2,
                                           T s3, T ts0, T ts1, T ts2, T ts3,
                                           T& v0, T& v1, T& v2, T& v3, T& y3,
                                           T& dprod) {
  const T tu = tanh_exact(shape * (inp - k * y3est));
  v0 = v_scale * (tu - ts0);
  const T d0 = gk * (T(1) - tu * tu);
  const T ty0 = tanh_exact(shape * (v0 + s0));
  v1 = v_scale * (ty0 - ts1);
  const T d1 = gk * (T(1) - ty0 * ty0);
  const T ty1 = tanh_exact(shape * (v1 + s1));
  v2 = v_scale * (ty1 - ts2);
  const T d2 = gk * (T(1) - ty1 * ty1);
  const T ty2 = tanh_exact(shape * (v2 + s2));
  v3 = v_scale * (ty2 - ts3);
  y3 = v3 + s3;
  const T d3 = gk * (T(1) - ty2 * ty2);
  dprod = d0 * d1 * d2 * d3;
}

template <typename T>
__global__ void __launch_bounds__(MOOG_WARP)
moog_zdf_kernel(const T* __restrict__ x, const T* __restrict__ st_in,
                T* __restrict__ st_out, T* __restrict__ y, T gk, T shape,
                T k, T ig, T osc, T v_scale, int newton_iters, int C,
                long long Tn) {
  __shared__ T tile[MOOG_WARP][MOOG_TILE + 1];
  const T lim = T(32);
  const int c0 = blockIdx.x * MOOG_WARP;
  const int rows = min(MOOG_WARP, C - c0);
  const int c = c0 + threadIdx.x;
  const bool live = threadIdx.x < rows;
  T s0 = 0, s1 = 0, s2 = 0, s3 = 0, prev = 0;
  if (live) {
    s0 = st_in[c];
    s1 = st_in[C + c];
    s2 = st_in[2 * C + c];
    s3 = st_in[3 * C + c];
    prev = st_in[7 * C + c];
  }
  for (long long base = 0; base < Tn; base += MOOG_TILE) {
    const int len = (int)min((long long)MOOG_TILE, Tn - base);
    tile_load(tile, x, c0, rows, Tn, base, len);
    __syncwarp();
    if (live) {
      T* row = tile[threadIdx.x];
      for (int t = 0; t < len; ++t) {
        const T inp = row[t] * ig;
        const T ts0 = tanh_exact(shape * s0);
        const T ts1 = tanh_exact(shape * s1);
        const T ts2 = tanh_exact(shape * s2);
        const T ts3 = tanh_exact(shape * s3);
        T v0, v1, v2, v3, y3, dprod;
        T y3est = prev;
        for (int it = 0; it < newton_iters; ++it) {
          zdf_ladder(y3est, inp, k, shape, gk, v_scale, s0, s1, s2, s3, ts0,
                     ts1, ts2, ts3, v0, v1, v2, v3, y3, dprod);
          const T jac = dprod * (-k) - T(1);
          // |J| < 1e-15 keeps the estimate; a NaN Jacobian updates it
          if (!(magnitude(jac) < T(1e-15))) y3est = y3est - (y3 - y3est) / jac;
        }
        zdf_ladder(y3est, inp, k, shape, gk, v_scale, s0, s1, s2, s3, ts0,
                   ts1, ts2, ts3, v0, v1, v2, v3, y3, dprod);
        s0 = clip(s0 + T(2) * v0, lim);
        s1 = clip(s1 + T(2) * v1, lim);
        s2 = clip(s2 + T(2) * v2, lim);
        s3 = clip(s3 + T(2) * v3, lim);
        prev = y3;
        row[t] = osc * y3;
      }
    }
    __syncwarp();
    tile_store(tile, y, c0, rows, Tn, base, len);
    __syncwarp();
  }
  if (live) {
    st_out[c] = s0;
    st_out[C + c] = s1;
    st_out[2 * C + c] = s2;
    st_out[3 * C + c] = s3;
    st_out[4 * C + c] = st_in[4 * C + c];
    st_out[5 * C + c] = st_in[5 * C + c];
    st_out[6 * C + c] = st_in[6 * C + c];
    st_out[7 * C + c] = prev;
  }
}

template <typename T>
int launch_ladder(const T* x, const T* st_in, T* st_out, T* y, double p0,
                  double p1, double p2, double p3, double p4, int C, long long Tn,
                  int mode, void* stream) {
  if (C < 1 || Tn < 1 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    moog_ladder_kernel<T, 0><<<grid, MOOG_WARP, 0, s>>>(
        x, st_in, st_out, y, T(p0), T(p1), T(p2), T(p3), T(p4), C, Tn);
  else if (mode == 1)
    moog_ladder_kernel<T, 1><<<grid, MOOG_WARP, 0, s>>>(
        x, st_in, st_out, y, T(p0), T(p1), T(p2), T(p3), T(p4), C, Tn);
  else
    moog_ladder_kernel<T, 2><<<grid, MOOG_WARP, 0, s>>>(
        x, st_in, st_out, y, T(p0), T(p1), T(p2), T(p3), T(p4), C, Tn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_zdf(const T* x, const T* st_in, T* st_out, T* y, double p0,
               double p1, double p2, double p3, double p4, int C, long long Tn,
               int newton_iters, void* stream) {
  if (C < 1 || Tn < 1 || newton_iters < 1 || newton_iters > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  // v_scale = gk / shape in double, as the plain version takes it
  const T v_scale = T(p0 / p1);
  moog_zdf_kernel<T><<<grid, MOOG_WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      x, st_in, st_out, y, T(p0), T(p1), T(p2), T(p3), T(p4), v_scale,
      newton_iters, C, Tn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (C, T); st_in, st_out: (8, C). mode 0 classic (tanh), 1 classic
// (rational tanh), 2 Huovilainen. Return cudaGetLastError() after the
// launch.
int moog_ladder_f32(const float* x, const float* st_in, float* st_out,
                    float* y, double p0, double p1, double p2, double p3,
                    double p4, int C, long long T, int mode, void* stream) {
  return launch_ladder<float>(x, st_in, st_out, y, p0, p1, p2, p3, p4, C, T,
                              mode, stream);
}

int moog_ladder_f64(const double* x, const double* st_in, double* st_out,
                    double* y, double p0, double p1, double p2, double p3,
                    double p4, int C, long long T, int mode, void* stream) {
  return launch_ladder<double>(x, st_in, st_out, y, p0, p1, p2, p3, p4, C, T,
                               mode, stream);
}

int moog_zdf_f32(const float* x, const float* st_in, float* st_out, float* y,
                 double p0, double p1, double p2, double p3, double p4, int C,
                 long long T, int newton_iters, void* stream) {
  return launch_zdf<float>(x, st_in, st_out, y, p0, p1, p2, p3, p4, C, T,
                           newton_iters, stream);
}

int moog_zdf_f64(const double* x, const double* st_in, double* st_out,
                 double* y, double p0, double p1, double p2, double p3,
                 double p4, int C, long long T, int newton_iters,
                 void* stream) {
  return launch_zdf<double>(x, st_in, st_out, y, p0, p1, p2, p3, p4, C, T,
                            newton_iters, stream);
}

}  // extern "C"
