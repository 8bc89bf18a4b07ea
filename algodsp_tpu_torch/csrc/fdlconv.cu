// Zero-state uniformly partitioned overlap-save FDL convolution, float32,
// for Hopper.
//
// Replaces: algodsp_tpu/ops/fdlconv.py::_fdl_fused_multi (K1, C >= 2) and
// ::_fdl_fused_single (K2, C = 1); both front doors are fdl_conv_fused.
// One kernel family serves every channel count. Same function: for x
// (C, N), N % B == 0, and the partition spectra H_p = FFT_2B(h[pB:(p+1)B]),
//   X_f = FFT_2B(x[(f-1)B : (f+1)B])               (x < 0 reads as 0)
//   y[fB : (f+1)B] = Re(IFFT_2B(sum_{p <= f, p < P} H_p X_{f-p}))[B : 2B].
// The spectra are kept in natural bin order, bins 0..B (the real input's
// Hermitian half), as (.., B+1) complex: not the TPU's (k1, k2) grid.
//
// What bounds it on the H100: per frame of B output samples it moves
// 8B bytes of signal (read x, write y) and does two 2B-point FFTs plus a
// P-tap complex MAC over B+1 bins. At the bench shape (8 ch x 2^24,
// B = 8192, P = 17) that is ~1.07 GB (~0.32 ms at 3.35 TB/s) against
// ~37 GFLOP (~0.55 ms at 67 TFLOP/s f32): operation-bound. What actually
// limits this first kernel is shared-memory traffic and the barriers of
// its radix-2 FFT (log2(2B) passes over the frame, one __syncthreads
// each), and the frame-spectrum scratch it round-trips through device
// memory and L2.
//
// Design: the TPU kernel computes its DFT as matmuls on the (k1, k2) grid
// with channel pairs packed as a + ib and a ring of frame spectra in VMEM
// carried over sequential grid steps. CUDA blocks run in no order, so
// the ring becomes a global scratch and the work splits in two launches:
//   1. fdl_forward, one block per (frame, channel): load the 2B-sample
//      frame bit-reversed into shared memory, radix-2 FFT in place with a
//      float64-accurate twiddle table, write bins 0..B to the scratch.
//   2. fdl_mac_inverse, one block per (frame, channel): each thread owns
//      bins k and sums H_p[k] X_{f-p}[k] from the scratch (coalesced over
//      k; the newest frames and H sit in L2), writes the Hermitian
//      extension bit-reversed, runs the inverse FFT in shared memory and
//      stores only the kept half, scaled by 1/2B.
// Each channel is transformed on its own (no a + ib pair packing), so a
// quiet channel never shares roundoff with a loud one. A frame of
// 2B <= 16384 complex values uses up to 128 KB of dynamic shared memory.

#include <cuda_runtime.h>

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-place radix-2 decimation-in-time FFT of s[0..n) whose input was
// stored in bit-reversed order. tw[k] = exp(-2 pi i k / n) for k < n/2;
// the inverse uses the conjugate twiddles and is not scaled.
static __device__ void fft_shared(float2* s, const float2* __restrict__ tw,
                                  int n, bool inverse) {
  const int half_n = n >> 1;
  for (int len = 2, stride = half_n; len <= n; len <<= 1, stride >>= 1) {
    const int half = len >> 1;
    for (int t = threadIdx.x; t < half_n; t += blockDim.x) {
      const int j = t & (half - 1);
      const int i0 = ((t - j) << 1) + j;
      const int i1 = i0 + half;
      float2 w = tw[j * stride];
      if (inverse) w.y = -w.y;
      const float2 u = s[i0];
      const float2 v = cmul(s[i1], w);
      s[i0] = make_float2(u.x + v.x, u.y + v.y);
      s[i1] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

__global__ void fdl_forward(const float* __restrict__ x,
                            const float2* __restrict__ tw,
                            float2* __restrict__ X, int N, int B, int log2n) {
  extern __shared__ float2 s[];
  const int f = blockIdx.x, c = blockIdx.y, nf = gridDim.x;
  const int n = 2 * B, shift = 32 - log2n;
  const float* xc = x + (size_t)c * N;
  const long long base = (long long)(f - 1) * B;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long src = base + i;
    const float v = src >= 0 ? xc[src] : 0.0f;
    s[__brev(i) >> shift] = make_float2(v, 0.0f);
  }
  __syncthreads();
  fft_shared(s, tw, n, false);
  float2* Xf = X + ((size_t)c * nf + f) * (B + 1);
  for (int k = threadIdx.x; k <= B; k += blockDim.x) Xf[k] = s[k];
}

__global__ void fdl_mac_inverse(const float2* __restrict__ X,
                                const float2* __restrict__ H,
                                const float2* __restrict__ tw,
                                float* __restrict__ y, int N, int B, int P,
                                int log2n) {
  extern __shared__ float2 s[];
  const int f = blockIdx.x, c = blockIdx.y, nf = gridDim.x;
  const int n = 2 * B, shift = 32 - log2n;
  const int taps = P < f + 1 ? P : f + 1;
  const float2* Xc = X + (size_t)c * nf * (B + 1);
  for (int k = threadIdx.x; k <= B; k += blockDim.x) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int p = 0; p < taps; ++p) {
      const float2 h = H[(size_t)p * (B + 1) + k];
      const float2 v = Xc[(size_t)(f - p) * (B + 1) + k];
      acc.x += h.x * v.x - h.y * v.y;
      acc.y += h.x * v.y + h.y * v.x;
    }
    s[__brev(k) >> shift] = acc;
    if (k > 0 && k < B) s[__brev(n - k) >> shift] = make_float2(acc.x, -acc.y);
  }
  __syncthreads();
  fft_shared(s, tw, n, true);
  const float scale = 1.0f / (float)n;
  float* yc = y + (size_t)c * N + (size_t)f * B;
  for (int m = threadIdx.x; m < B; m += blockDim.x) yc[m] = s[B + m].x * scale;
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (C, N) with N % B == 0; H: (P, B+1) complex; tw: (B,) complex,
// tw[k] = exp(-i pi k / B); X: (C, N/B, B+1) complex scratch.
// B is a power of two in [2, 8192]. Returns cudaGetLastError().
int fdl_conv_f32(const float* x, const float* H, const float* tw, float* X,
                 float* y, int C, int N, int B, int P, void* stream) {
  if (C < 1 || C > 65535 || B < 2 || B > 8192 || (B & (B - 1)) || N < B ||
      N % B || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = 2 * B;
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const size_t smem = (size_t)n * sizeof(float2);
  cudaError_t err;
  // opt in to the largest frame once per device, so that later calls (and
  // a CUDA graph capturing them) make no attribute call
  static int opted_in[64] = {0};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || opted_in[dev] < (int)smem) {
    const int max_smem = 2 * 8192 * (int)sizeof(float2);
    err = cudaFuncSetAttribute(fdl_forward,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(fdl_mac_inverse,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted_in[dev] = max_smem;
  }
  int threads = n / 2 < 1024 ? n / 2 : 1024;
  if (threads < 32) threads = 32;
  const dim3 grid(N / B, C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fdl_forward<<<grid, threads, smem, st>>>(
      x, reinterpret_cast<const float2*>(tw), reinterpret_cast<float2*>(X),
      N, B, log2n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fdl_mac_inverse<<<grid, threads, smem, st>>>(
      reinterpret_cast<const float2*>(X), reinterpret_cast<const float2*>(H),
      reinterpret_cast<const float2*>(tw), y, N, B, P, log2n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
