// M2 and M3: the time-varying affine scans of the modulation effects for
// Hopper (sm_90a).
//
// Replace the log-depth `jax.lax.associative_scan`s of the JAX package,
// which have no Pallas kernel:
//   M2  ops/linrec.py::affine_scan_nd (:469): s_n = A_n s_{n-1} + w_n with
//       a d-dimensional state (d <= 32; the Phaser's reduced cascade,
//       d = stages + 1 <= 13), the matrices A (N, d, d) shared by every
//       channel, the offsets w (C, N, d) and s0 (C, d) per channel;
//       returns every state after its step and the last.
//   M3  ops/linrec.py::affine2_scan (:428): the same with d = 2 and a
//       matrix per channel and step (A (C, N, 4) packed [m00, m01, m10,
//       m11], w (C, N, 2); the AutoWah's time-varying DF2T); returns the
//       state before each step (entry[0] = s0) and the last.
//
// Both walk the recurrence in order, where the reference composes maps in
// a log-depth tree: the same function, summed in another order (the
// wrappers' plain versions in ops/linrec.py keep the reference's
// doubling). Bound: a dependent chain of one step a sample; the bytes
// (the matrices and offsets read once, the states written once) take a
// few microseconds at the chain's shapes. M2 runs one warp a channel:
// lane i holds row i of A_n, reads the state's d entries by shuffles and
// forms row i of the product. M3 runs one thread a channel. float and
// double; products and sums may fuse (the scans are held to their plain
// versions by SNR, not bit for bit).

#include <cuda_runtime.h>

constexpr int kWarp = 32;
constexpr int kWarps = 4;          // M2: channels (warps) a block
constexpr int kThreads = 64;       // M3: channels (threads) a block
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarps) affine_scan_nd_kernel(
    const T* __restrict__ A, const T* __restrict__ w, const T* __restrict__ s0,
    T* __restrict__ after, T* __restrict__ fin, int C, long long N, int d) {
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (c >= C) return;
  const bool mine = lane < d;
  const T* wc = w + static_cast<size_t>(c) * N * d;
  T* ac = after + static_cast<size_t>(c) * N * d;
  T s = mine ? s0[static_cast<size_t>(c) * d + lane] : T(0);
  for (long long n = 0; n < N; ++n) {
    const T* row = A + (static_cast<size_t>(n) * d + (mine ? lane : 0)) * d;
    T acc = mine ? wc[n * d + lane] : T(0);
    for (int j = 0; j < d; ++j) {
      const T sj = __shfl_sync(kFull, s, j);
      if (mine) acc += row[j] * sj;
    }
    s = acc;
    if (mine) ac[n * d + lane] = s;
  }
  if (mine) fin[static_cast<size_t>(c) * d + lane] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) affine2_scan_kernel(
    const T* __restrict__ A, const T* __restrict__ w, const T* __restrict__ s0,
    T* __restrict__ entry, T* __restrict__ fin, int C, long long N) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const T* ac = A + static_cast<size_t>(c) * N * 4;
  const T* wc = w + static_cast<size_t>(c) * N * 2;
  T* ec = entry + static_cast<size_t>(c) * N * 2;
  T s0v = s0[2 * static_cast<size_t>(c)], s1v = s0[2 * static_cast<size_t>(c) + 1];
#pragma unroll 4
  for (long long n = 0; n < N; ++n) {
    ec[2 * n] = s0v;
    ec[2 * n + 1] = s1v;
    const T a0 = ac[4 * n], a1 = ac[4 * n + 1], a2 = ac[4 * n + 2],
            a3 = ac[4 * n + 3];
    const T n0 = a0 * s0v + a1 * s1v + wc[2 * n];
    const T n1 = a2 * s0v + a3 * s1v + wc[2 * n + 1];
    s0v = n0;
    s1v = n1;
  }
  fin[2 * static_cast<size_t>(c)] = s0v;
  fin[2 * static_cast<size_t>(c) + 1] = s1v;
}

// The dependent step alone, for the chain bound: one warp runs n steps of
// M2's (d shuffles and multiply-adds, d known at compile time and the
// matrix row held in registers, so only the step's own dependences are
// left) or one thread n steps of M3's between two clock64() stamps.
template <typename T, int D>
__global__ void nd_latency_kernel(long long n, long long* cycles, T* sink) {
  const int lane = threadIdx.x;
  T row[D];
#pragma unroll
  for (int j = 0; j < D; ++j) row[j] = T(0.9) / T(D + lane + j + 1);
  T s = T(lane) * T(0.01);
  const T w = T(0.5) / T(lane + 1);
  const long long t0 = clock64();
  for (long long i = 0; i < n; ++i) {
    T acc = w;
#pragma unroll
    for (int j = 0; j < D; ++j) acc += row[j] * __shfl_sync(kFull, s, j);
    s = acc;
  }
  const long long t1 = clock64();
  if (lane == 0) cycles[0] = t1 - t0;
  sink[lane] = s;
}

template <typename T, int D>
void nd_latency_upto(int d, long long n, long long* cycles, T* sink,
                     cudaStream_t st) {
  if constexpr (D > 1) {
    if (d < D) return nd_latency_upto<T, D - 1>(d, n, cycles, sink, st);
  }
  nd_latency_kernel<T, D><<<1, kWarp, 0, st>>>(n, cycles, sink);
}

template <typename T>
__global__ void two_latency_kernel(long long n, long long* cycles, T* sink) {
  // the coefficients come from memory, so that none folds away
  const T a0 = sink[2], a1 = sink[3], a2 = sink[4], a3 = sink[5], w0 = sink[6],
          w1 = sink[7];
  T s0v = sink[0], s1v = sink[1];
  const long long t0 = clock64();
  for (long long i = 0; i < n; ++i) {
    const T n0 = a0 * s0v + a1 * s1v + w0;
    const T n1 = a2 * s0v + a3 * s1v + w1;
    s0v = n0;
    s1v = n1;
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = s0v;
  sink[1] = s1v;
}

template <typename T>
int latency(int kind, long long n, int d, long long* cycles, void* sink,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 2)
    nd_latency_upto<T, kWarp>(d, n, cycles, static_cast<T*>(sink), st);
  else
    two_latency_kernel<T><<<1, 1, 0, st>>>(n, cycles, static_cast<T*>(sink));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int nd_launch(const T* A, const T* w, const T* s0, T* after, T* fin, int C,
              long long N, int d, void* stream) {
  affine_scan_nd_kernel<T><<<(C + kWarps - 1) / kWarps, kWarp * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      A, w, s0, after, fin, C, N, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int two_launch(const T* A, const T* w, const T* s0, T* entry, T* fin, int C,
               long long N, void* stream) {
  affine2_scan_kernel<T><<<(C + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      A, w, s0, entry, fin, C, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A (N, d, d); w, after (C, N, d); s0, fin (C, d); 1 <= d <= 32. Returns
// cudaGetLastError() after the launch.
int affine_scan_nd_f32(const float* A, const float* w, const float* s0,
                       float* after, float* fin, int C, long long N, int d,
                       void* stream) {
  return nd_launch<float>(A, w, s0, after, fin, C, N, d, stream);
}

int affine_scan_nd_f64(const double* A, const double* w, const double* s0,
                       double* after, double* fin, int C, long long N, int d,
                       void* stream) {
  return nd_launch<double>(A, w, s0, after, fin, C, N, d, stream);
}

// A (C, N, 4); w, entry (C, N, 2); s0, fin (C, 2).
int affine2_scan_f32(const float* A, const float* w, const float* s0,
                     float* entry, float* fin, int C, long long N,
                     void* stream) {
  return two_launch<float>(A, w, s0, entry, fin, C, N, stream);
}

int affine2_scan_f64(const double* A, const double* w, const double* s0,
                     double* entry, double* fin, int C, long long N,
                     void* stream) {
  return two_launch<double>(A, w, s0, entry, fin, C, N, stream);
}

// The cycles of n dependent steps: kind 2 is M2's step (d <= 32, one
// warp), kind 3 M3's (one thread); cycles: one int64 on the device;
// sink: 32 values of the type on the device.
int affine_latency_f32(int kind, long long n, int d, long long* cycles,
                       void* sink, void* stream) {
  return latency<float>(kind, n, d, cycles, sink, stream);
}

int affine_latency_f64(int kind, long long n, int d, long long* cycles,
                       void* sink, void* stream) {
  return latency<double>(kind, n, d, cycles, sink, stream);
}

}  // extern "C"
