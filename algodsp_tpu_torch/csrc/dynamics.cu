// D1: the feedback-topology dynamics detector for Hopper (sm_90a).
//
// Replaces the per-sample lax.scan `DynamicsCore._process_feedback`
// (algodsp_tpu/effects/dynamics/core.py:270), which has no Pallas kernel:
// the envelope reads the magnitude of the previous OUTPUT sample, so each
// step depends on the last one's gain and no time split applies. Per
// channel and sample, with src = |y_{n-1}|:
//
//   env_n = src > env ? env + (src - env) * a : src + (env - src) * r
//   g_n   = the log2-domain soft-knee gain of env_n (compression_gain)
//   y_n   = x_n * g_n * makeup
//
// One thread walks one channel; a block is one warp of 32 channels. The
// walk is a dependent chain (a compare, two products, log2, the knee,
// exp2, two products and an abs a step), so the kernel is latency-bound
// by construction: x is loaded a group of steps ahead of the walk so
// that its loads overlap the group before, and y and the gain are stored
// as they come. log2 and exp2 are the full-precision library functions
// (no fast-math intrinsics); the source is built with -fmad=false
// (_build.EXTRA_FLAGS) so that every product and sum rounds by itself,
// as the plain version in ops/dynfb.py does. float and double.

#include <cuda_runtime.h>

#include <cstdint>

// The kernels sit outside any namespace so that a profiler names them as
// they are written here.
constexpr int kWarp = 32;
constexpr int kGroup = 8;   // steps whose x is loaded a group ahead

template <typename T>
struct FbParams {
  T a, r, thr, half, ikw, cf, makeup;
  bool knee;
};

__device__ __forceinline__ float log2_of(float v) { return log2f(v); }
__device__ __forceinline__ double log2_of(double v) { return log2(v); }
__device__ __forceinline__ float exp2_of(float v) { return exp2f(v); }
__device__ __forceinline__ double exp2_of(double v) { return exp2(v); }

// compression_gain of effects/dynamics/core.py, operation for operation.
template <typename T>
__device__ __forceinline__ T gain_of(T level, const FbParams<T>& p) {
  const T safe = level > T(0) ? level : T(1);
  const T over = log2_of(safe) - p.thr;
  T gl;
  if (!p.knee) {
    gl = over > T(0) ? -over * p.cf : T(0);
  } else {
    const T scratch = over + p.half;
    const T knee_os = scratch * scratch * T(0.5) * p.ikw;
    const T eff = over > p.half ? over : (over < -p.half ? T(0) : knee_os);
    gl = -eff * p.cf;
  }
  return level > T(0) ? exp2_of(gl) : T(1);
}

// One step of the walk: updates env and prev_abs, returns y, sets g.
template <typename T>
__device__ __forceinline__ T fb_step(T xv, T& env, T& prev_abs, T& g,
                                     const FbParams<T>& p) {
  const T src = prev_abs;
  const T rising = env + (src - env) * p.a;
  const T falling = src + (env - src) * p.r;
  env = src > env ? rising : falling;
  g = gain_of(env, p);
  const T y = xv * g * p.makeup;
  prev_abs = fabs(y);
  return y;
}

template <typename T>
__global__ void __launch_bounds__(kWarp) dynamics_feedback_kernel(
    const T* __restrict__ x, const T* __restrict__ env0,
    const T* __restrict__ prev_abs0, T* __restrict__ y, T* __restrict__ gain,
    T* __restrict__ env_final, T* __restrict__ prev_abs_final, int C,
    long long n, FbParams<T> p) {
  const int c = blockIdx.x * kWarp + threadIdx.x;
  if (c >= C) return;
  const size_t base = static_cast<size_t>(c) * static_cast<size_t>(n);
  const T* xc = x + base;
  T* yc = y + base;
  T* gc = gain + base;
  T env = env0[c];
  T prev_abs = prev_abs0[c];
  const long long full = n - n % kGroup;
  T cur[kGroup];
  if (full > 0) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) cur[j] = __ldg(xc + j);
  }
  for (long long t = 0; t < full; t += kGroup) {
    T next[kGroup];
    if (t + kGroup < full) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) next[j] = __ldg(xc + t + kGroup + j);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      T g;
      yc[t + j] = fb_step(cur[j], env, prev_abs, g, p);
      gc[t + j] = g;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) cur[j] = next[j];
  }
  for (long long t = full; t < n; ++t) {
    T g;
    yc[t] = fb_step(__ldg(xc + t), env, prev_abs, g, p);
    gc[t] = g;
  }
  env_final[c] = env;
  prev_abs_final[c] = prev_abs;
}

// The dependent chain alone: one thread walks n steps on register values
// between two clock64() stamps. cycles[0] = the cycles of the walk.
template <typename T>
__global__ void dynamics_latency_kernel(FbParams<T> p, long long n, T x0,
                                        long long* cycles, T* sink) {
  T env = T(0), prev_abs = T(0), xv = x0, g, acc = T(0);
  const long long t0 = clock64();
  for (long long i = 0; i < n; ++i) {
    acc += fb_step(xv, env, prev_abs, g, p);
    xv = -xv;
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = acc + g;
}

__global__ void dynamics_spin_kernel(long long target, long long* spun) {
  const long long t0 = clock64();
  long long t = t0;
  while (t - t0 < target) t = clock64();
  spun[0] = t - t0;
}

template <typename T>
FbParams<T> make_params(const double* prm) {
  // prm: attack, release, threshold_log2, knee_db, knee_width_log2 * 0.5,
  // inv_knee_width_log2, compression factor, makeup
  FbParams<T> p;
  p.a = static_cast<T>(prm[0]);
  p.r = static_cast<T>(prm[1]);
  p.thr = static_cast<T>(prm[2]);
  p.knee = prm[3] > 0.0;
  p.half = static_cast<T>(prm[4]);
  p.ikw = static_cast<T>(prm[5]);
  p.cf = static_cast<T>(prm[6]);
  p.makeup = static_cast<T>(prm[7]);
  return p;
}

template <typename T>
int launch(const T* x, const T* env0, const T* prev_abs0, T* y, T* gain,
           T* env_final, T* prev_abs_final, int C, long long n,
           const double* prm, void* stream) {
  const int blocks = (C + kWarp - 1) / kWarp;
  dynamics_feedback_kernel<T>
      <<<blocks, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
          x, env0, prev_abs0, y, gain, env_final, prev_abs_final, C, n,
          make_params<T>(prm));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int latency(const double* prm, long long n, double x0, long long* cycles,
            void* sink, void* stream) {
  dynamics_latency_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      make_params<T>(prm), n, static_cast<T>(x0), cycles,
      static_cast<T*>(sink));
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y, gain: (C, n); env0, prev_abs0, env_final, prev_abs_final: (C,);
// prm: 8 doubles on the host (see make_params). Returns
// cudaGetLastError() after the launch.
int dynamics_feedback_f32(const float* x, const float* env0,
                          const float* prev_abs0, float* y, float* gain,
                          float* env_final, float* prev_abs_final, int C,
                          long long n, const double* prm, void* stream) {
  return launch<float>(x, env0, prev_abs0, y, gain, env_final, prev_abs_final,
                       C, n, prm, stream);
}

int dynamics_feedback_f64(const double* x, const double* env0,
                          const double* prev_abs0, double* y, double* gain,
                          double* env_final, double* prev_abs_final, int C,
                          long long n, const double* prm, void* stream) {
  return launch<double>(x, env0, prev_abs0, y, gain, env_final,
                        prev_abs_final, C, n, prm, stream);
}

// The cycles of n dependent steps on one thread (cycles: one int64 on the
// device; sink: one value of the type), for the kernel's chain bound.
int dynamics_feedback_latency_f32(const double* prm, long long n, double x0,
                                  long long* cycles, void* sink,
                                  void* stream) {
  return latency<float>(prm, n, x0, cycles, sink, stream);
}

int dynamics_feedback_latency_f64(const double* prm, long long n, double x0,
                                  long long* cycles, void* sink,
                                  void* stream) {
  return latency<double>(prm, n, x0, cycles, sink, stream);
}

// Spins one thread for `target` SM cycles and stores the cycles it read:
// with CUDA events around it, the SM clock of a one-thread kernel.
int dynamics_spin(long long target, long long* spun, void* stream) {
  dynamics_spin_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      target, spun);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
