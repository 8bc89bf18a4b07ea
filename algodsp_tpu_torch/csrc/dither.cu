// Q1: the quantizer's error-feedback loop for Hopper (sm_90a).
//
// Replaces the per-sample `lax.scan`s of `Quantizer._process_codes`
// (algodsp_tpu/dither/quantizer.py:228-242, the FIR shaper) and
// `Quantizer._process_codes_iir` (:256-271, the IIR low shelf on the
// previous error), which have no Pallas kernel. Per channel and sample,
// with s the scaled input and nz the dither:
//
//   FIR  shaped = s - (c_0 h_0 + c_1 h_1 + ... + c_{K-1} h_{K-1})
//   IIR  fo = b0 e + d0; d0 = b1 e - a1 fo + d1; d1 = b2 e - a2 fo;
//        shaped = s - fo
//   q = floor(shaped + nz), clipped to [lo, hi] where the quantizer
//   limits; the error q - shaped enters the history (FIR: h_0, the rest
//   shifted; IIR: e).
//
// Each step's floor depends on the last step's error, so the loop is
// sequential in time: one thread walks one channel, a block is one warp
// of 32 channels. x and the dither are staged through shared memory in
// tiles of 32 samples, the warp loading a channel's 32 samples with one
// coalesced read, and the codes go out the same way. The sums run in the
// plain version's order (k = 0, 1, ... for the FIR; the IIR's as written
// left to right), each product and sum rounded by itself (the source is
// built with -fmad=false, _build.EXTRA_FLAGS), and the clip keeps NaN as
// the plain version's clamp does, so the codes and the state agree with
// ops/dither.py's plain version bit for bit. Bound: the dependent chain
// of a step (a floor and the shaper's adds) times the samples; the bytes
// (x and the dither read once, the codes written once) take microseconds.
// float and double; FIR orders up to kMaxOrder.

#include <cuda_runtime.h>

#include <cmath>

constexpr int kWarp = 32;
constexpr int kTileT = 32;
constexpr int kMaxOrder = 32;

template <typename T>
struct ShaperParams {
  T c[kMaxOrder];   // FIR coefficients (order of them)
  T b0, b1, b2, a1, a2;   // IIR shelf
  T lo, hi;
  int order;
  bool limit;
};

template <typename T>
__device__ __forceinline__ T code_of(T shaped, T nz, const ShaperParams<T>& p) {
  T q = floor(shaped + nz);
  if (p.limit) {
    q = q < p.lo ? p.lo : q;
    q = q > p.hi ? p.hi : q;
  }
  return q;
}

// state: FIR (C, order) histories, IIR (C, 3) = (d0, d1, last error).
template <typename T, bool kIIR>
__global__ void __launch_bounds__(kWarp) error_feedback_kernel(
    const T* __restrict__ scaled, const T* __restrict__ noise,
    const T* __restrict__ state_in, T* __restrict__ q_out,
    T* __restrict__ state_out, int C, long long n, ShaperParams<T> p) {
  __shared__ T xs[kWarp][kTileT + 1];
  __shared__ T ns[kWarp][kTileT + 1];
  __shared__ T qs[kWarp][kTileT + 1];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kWarp;
  const int c = c0 + lane;
  const bool mine = c < C;
  const int width = kIIR ? 3 : p.order;
  T h[kMaxOrder];
#pragma unroll
  for (int k = 0; k < kMaxOrder; ++k)
    h[k] = (mine && k < width) ? state_in[static_cast<size_t>(c) * width + k] : T(0);
  for (long long t0 = 0; t0 < n; t0 += kTileT) {
    const int tn = static_cast<int>(n - t0 < kTileT ? n - t0 : kTileT);
    for (int r = 0; r < kWarp && c0 + r < C; ++r) {
      if (lane < tn) {
        const size_t at = static_cast<size_t>(c0 + r) * n + t0 + lane;
        xs[r][lane] = scaled[at];
        ns[r][lane] = noise[at];
      }
    }
    __syncwarp();
    if (mine) {
      for (int j = 0; j < tn; ++j) {
        T shaped, q;
        if (kIIR) {
          const T e = h[2];
          const T fo = p.b0 * e + h[0];
          const T d0 = p.b1 * e - p.a1 * fo + h[1];
          const T d1 = p.b2 * e - p.a2 * fo;
          shaped = xs[lane][j] - fo;
          q = code_of(shaped, ns[lane][j], p);
          h[0] = d0;
          h[1] = d1;
          h[2] = q - shaped;
        } else {
          T acc = p.c[0] * h[0];
#pragma unroll
          for (int k = 1; k < kMaxOrder; ++k)
            if (k < p.order) acc = acc + p.c[k] * h[k];
          shaped = xs[lane][j] - acc;
          q = code_of(shaped, ns[lane][j], p);
#pragma unroll
          for (int k = kMaxOrder - 1; k > 0; --k) h[k] = h[k - 1];
          h[0] = q - shaped;
        }
        qs[lane][j] = q;
      }
    }
    __syncwarp();
    for (int r = 0; r < kWarp && c0 + r < C; ++r) {
      if (lane < tn) q_out[static_cast<size_t>(c0 + r) * n + t0 + lane] = qs[r][lane];
    }
    __syncwarp();
  }
  if (mine) {
#pragma unroll
    for (int k = 0; k < kMaxOrder; ++k)
      if (k < width) state_out[static_cast<size_t>(c) * width + k] = h[k];
  }
}

// The dependent chain alone: one thread walks n FIR steps on register
// values between two clock64() stamps. cycles[0] = the cycles of the walk.
template <typename T>
__global__ void error_feedback_latency_kernel(ShaperParams<T> p, long long n,
                                              T x0, long long* cycles,
                                              T* sink) {
  T h[kMaxOrder];
#pragma unroll
  for (int k = 0; k < kMaxOrder; ++k) h[k] = T(0);
  T xv = x0, acc_q = T(0);
  const long long t0 = clock64();
  for (long long i = 0; i < n; ++i) {
    T acc = p.c[0] * h[0];
#pragma unroll
    for (int k = 1; k < kMaxOrder; ++k)
      if (k < p.order) acc = acc + p.c[k] * h[k];
    const T shaped = xv - acc;
    const T q = code_of(shaped, T(0.25), p);
#pragma unroll
    for (int k = kMaxOrder - 1; k > 0; --k) h[k] = h[k - 1];
    h[0] = q - shaped;
    acc_q += q;
    xv = -xv;
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = acc_q + h[0];
}

template <typename T>
ShaperParams<T> make_params(const double* prm, int order, int limit) {
  // prm: lo, hi, b0, b1, b2, a1, a2, then the order FIR coefficients
  ShaperParams<T> p;
  p.lo = static_cast<T>(prm[0]);
  p.hi = static_cast<T>(prm[1]);
  p.b0 = static_cast<T>(prm[2]);
  p.b1 = static_cast<T>(prm[3]);
  p.b2 = static_cast<T>(prm[4]);
  p.a1 = static_cast<T>(prm[5]);
  p.a2 = static_cast<T>(prm[6]);
  for (int k = 0; k < kMaxOrder; ++k)
    p.c[k] = k < order ? static_cast<T>(prm[7 + k]) : T(0);
  p.order = order;
  p.limit = limit != 0;
  return p;
}

template <typename T>
int launch(const T* scaled, const T* noise, const T* state_in, T* q_out,
           T* state_out, int C, long long n, int order, int iir, int limit,
           const double* prm, void* stream) {
  if (order < 0 || order > kMaxOrder || (!iir && order < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (C + kWarp - 1) / kWarp;
  const ShaperParams<T> p = make_params<T>(prm, iir ? 0 : order, limit);
  auto s = static_cast<cudaStream_t>(stream);
  if (iir) {
    error_feedback_kernel<T, true><<<blocks, kWarp, 0, s>>>(
        scaled, noise, state_in, q_out, state_out, C, n, p);
  } else {
    error_feedback_kernel<T, false><<<blocks, kWarp, 0, s>>>(
        scaled, noise, state_in, q_out, state_out, C, n, p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// scaled, noise, q_out: (C, n); state_in, state_out: (C, order) for the
// FIR shaper, (C, 3) for the IIR shelf (iir != 0); prm: 7 + order doubles
// on the host (see make_params). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an order the kernel does not take.
int error_feedback_f32(const float* scaled, const float* noise,
                       const float* state_in, float* q_out, float* state_out,
                       int C, long long n, int order, int iir, int limit,
                       const double* prm, void* stream) {
  return launch<float>(scaled, noise, state_in, q_out, state_out, C, n, order,
                       iir, limit, prm, stream);
}

int error_feedback_f64(const double* scaled, const double* noise,
                       const double* state_in, double* q_out,
                       double* state_out, int C, long long n, int order,
                       int iir, int limit, const double* prm, void* stream) {
  return launch<double>(scaled, noise, state_in, q_out, state_out, C, n, order,
                        iir, limit, prm, stream);
}

// The cycles of n dependent FIR steps of the given order on one thread
// (cycles: one int64 on the device; sink: one value of the type), for the
// loop's chain bound.
int error_feedback_latency_f32(int order, const double* prm, long long n,
                               double x0, long long* cycles, void* sink,
                               void* stream) {
  if (order < 1 || order > kMaxOrder)
    return static_cast<int>(cudaErrorInvalidValue);
  error_feedback_latency_kernel<float><<<1, 1, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      make_params<float>(prm, order, 1), n, static_cast<float>(x0), cycles,
      static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
