// Fused S-section biquad cascade with input gain, float32 in and out, for
// Hopper.
//
// Replaces: algodsp_tpu/ops/pallas_kernels.py::_biquad_kernel (K3), whose
// front door is biquad_cascade_pallas. Same function: y = cascade(gain * x)
// over x (C, N), with per-channel per-section state (C, S, 4) =
// [x_{n-1}, x_{n-2}, y_{n-1}, y_{n-2}] read in and written out. The carry
// written out is the state after the last real sample for any N (the TPU
// kernel only returns it for N % 128 == 0).
//
// What bounds it on the H100: reading x once and writing y once is
// 8 bytes per sample, so the byte bound at 8 ch x 48128 is ~1 us. The
// recurrence, though, is a chain of dependent multiply-adds along time:
// walked by one thread per channel it is latency-bound and leaves all
// but C threads of the card idle (measured ~4 ms per launch at
// 8 x 48128 x 5 sections).
//
// Design: the TPU kernel turns each 128-sample block into a Toeplitz
// matmul for its matrix unit, with a carry correction per block. Here the
// cascade is one linear system with a d = 4S state (the (S, 4) layout,
// flattened), so time is cut into chunks of T samples and three launches
// share the work:
//   1. chunk_zero_state: one thread per (channel, chunk) runs the
//      direct-form recurrence over its chunk from zero state, writes that
//      response into y and its final state into w;
//   2. chunk_carry: one warp per channel carries the true state across
//      chunks, z_in(k+1) = A z_in(k) + w(k), with A the state transition
//      over T samples (a d x d product per chunk);
//   3. chunk_correct: one block per chunk adds the response to its
//      entering state, y[t] += sum_j z_in_j R[j][t], R (d, T) the output
//      of the cascade from each unit state with zero input.
// A, the transition over the last (shorter) chunk, and R are computed on
// the host in float64. C * ceil(N/T) threads walk time instead of C. The
// recurrence and the carry run in float64 (coefficients and state): a
// float32 direct form measured 117 dB against a float64 evaluation of the
// Butterworth cascade, short of the 120 dB bar. For up to 16 sections the
// section count is a template constant, so the state stays in registers.

#include <cuda_runtime.h>

#define MAX_SECTIONS 64

// One section of the direct-form recurrence on the state m = [x1 x2 y1 y2].
// The terms are summed oldest first: the previous output y1 enters
// second to last and this sample's input last, so the recurrence of a
// section is two multiply-adds per sample and the chain through the
// cascade one per section.
static __device__ __forceinline__ double section(const double* k, double* m,
                                                 double v) {
  const double old = k[1] * m[0] + k[2] * m[1] - k[4] * m[3];
  const double out = fma(k[0], v, fma(-k[3], m[2], old));
  m[1] = m[0];
  m[0] = v;
  m[3] = m[2];
  m[2] = out;
  return out;
}

// Pass 1: each thread runs the cascade over one chunk of one channel from
// zero state, writes that zero-state response into y and its final state
// (4S values, float64) into w. NS > 0: the section count is a compile-time
// constant and the state lives in registers; NS == 0: any count up to
// MAX_SECTIONS, the state in (cached) local memory.
template <int NS>
__global__ void chunk_zero_state(const float* __restrict__ x,
                                 float* __restrict__ y,
                                 const double* __restrict__ coef,
                                 double* __restrict__ w, float gain, int C,
                                 int N, int S_rt, int T, int K) {
  constexpr int CAP = NS > 0 ? NS : MAX_SECTIONS;
  const int S = NS > 0 ? NS : S_rt;
  extern __shared__ double sc[];  // (S, 5): b0 b1 b2 a1 a2
  for (int i = threadIdx.x; i < 5 * S; i += blockDim.x) sc[i] = coef[i];
  __syncthreads();
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= C * K) return;
  const int c = id / K, k = id % K;
  const long long start = (long long)k * T;
  const int len = (int)min((long long)T, (long long)N - start);

  double st[4 * CAP];
#pragma unroll
  for (int i = 0; i < 4 * CAP; ++i) st[i] = 0.0;
  const float* xc = x + (size_t)c * N + start;
  float* yc = y + (size_t)c * N + start;
  if constexpr (NS > 0) {
    double kr[5 * NS];
#pragma unroll
    for (int i = 0; i < 5 * NS; ++i) kr[i] = sc[i];
    for (int n = 0; n < len; ++n) {
      double v = (double)(xc[n] * gain);
#pragma unroll
      for (int s = 0; s < NS; ++s) v = section(kr + 5 * s, st + 4 * s, v);
      yc[n] = (float)v;
    }
  } else {
    for (int n = 0; n < len; ++n) {
      double v = (double)(xc[n] * gain);
      for (int s = 0; s < S; ++s) v = section(sc + 5 * s, st + 4 * s, v);
      yc[n] = (float)v;
    }
  }
  double* wk = w + (size_t)id * 4 * S;
#pragma unroll
  for (int i = 0; i < 4 * CAP; ++i)
    if (i < 4 * S) wk[i] = st[i];
}

// Pass 2: one warp per channel walks the chunks in order, carrying the
// d = 4S state: z_in(k+1) = A z_in(k) + w(k), with A the transition over
// a full chunk (A_last over the last, possibly shorter, chunk). Writes
// each chunk's entering state to zin and the final state to state_out.
__global__ void chunk_carry(const double* __restrict__ w,
                            const double* __restrict__ A_full,
                            const double* __restrict__ A_last,
                            const float* __restrict__ state_in,
                            double* __restrict__ zin,
                            float* __restrict__ state_out, int K, int d) {
  extern __shared__ double z[];  // d
  const int c = blockIdx.x, lane = threadIdx.x;
  for (int i = lane; i < d; i += 32)
    z[i] = state_in ? (double)state_in[(size_t)c * d + i] : 0.0;
  __syncwarp();
  for (int k = 0; k < K; ++k) {
    const double* A = k < K - 1 ? A_full : A_last;
    const double* wk = w + ((size_t)c * K + k) * d;
    double* zk = zin + ((size_t)c * K + k) * d;
    double next[MAX_SECTIONS * 4 / 32];
#pragma unroll
    for (int r = 0; r < MAX_SECTIONS * 4 / 32; ++r) {
      const int i = lane + 32 * r;
      if (i < d) {
        zk[i] = z[i];
        double acc = wk[i];
        for (int j = 0; j < d; ++j) acc = fma(A[(size_t)i * d + j], z[j], acc);
        next[r] = acc;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < MAX_SECTIONS * 4 / 32; ++r) {
      const int i = lane + 32 * r;
      if (i < d) z[i] = next[r];
    }
    __syncwarp();
  }
  for (int i = lane; i < d; i += 32)
    state_out[(size_t)c * d + i] = (float)z[i];
}

// Pass 3: one block per chunk adds the response to its entering state,
// y[t] += sum_j zin_j R[j][t], with R (d, T) the cascade's zero-input
// output from each unit state.
__global__ void chunk_correct(float* __restrict__ y,
                              const double* __restrict__ zin,
                              const double* __restrict__ R, int N, int T,
                              int K, int d) {
  extern __shared__ double z[];  // d
  const int id = blockIdx.x;  // c * K + k
  const int c = id / K, k = id % K;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    z[i] = zin[(size_t)id * d + i];
  __syncthreads();
  const long long start = (long long)k * T;
  const int len = (int)min((long long)T, (long long)N - start);
  float* yc = y + (size_t)c * N + start;
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    double acc = (double)yc[t];
    for (int j = 0; j < d; ++j) acc = fma(z[j], R[(size_t)j * T + t], acc);
    yc[t] = (float)acc;
  }
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (C, N); coef: (S, 5); R: (4S, T); A_full, A_last: (4S, 4S), all
// float64 from the host. state_in: (C, S, 4) or null for zero state;
// state_out: (C, S, 4). w, zin: (C, K, 4S) float64 scratch, K = ceil(N/T).
// Returns cudaGetLastError() after the launches.
int biquad_cascade_f32(const float* x, float* y, const double* coef,
                       const double* R, const double* A_full,
                       const double* A_last, const float* state_in,
                       float* state_out, double* w, double* zin, float gain,
                       int C, int N, int S, int T, void* stream) {
  if (S < 1 || S > MAX_SECTIONS || C < 1 || N < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = (int)((N + (long long)T - 1) / T);
  const int d = 4 * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32;
  const int blocks = (int)(((long long)C * K + threads - 1) / threads);
  const size_t smem = 5 * S * sizeof(double);
#define CASE(k)                                                             \
  case k:                                                                   \
    chunk_zero_state<k><<<blocks, threads, smem, st>>>(x, y, coef, w, gain, \
                                                       C, N, S, T, K);      \
    break;
  switch (S) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
    default:
      chunk_zero_state<0><<<blocks, threads, smem, st>>>(x, y, coef, w, gain,
                                                         C, N, S, T, K);
  }
#undef CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_carry<<<C, 32, d * sizeof(double), st>>>(w, A_full, A_last, state_in,
                                                 zin, state_out, K, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_correct<<<C * K, 256, d * sizeof(double), st>>>(y, zin, R, N, T, K, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
