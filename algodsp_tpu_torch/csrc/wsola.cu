// W1: the WSOLA alignment search for Hopper (sm_90a).
//
// Replaces the `lax.scan` over segments in
// `WSOLAPitchShifter._time_stretch` (algodsp_tpu/effects/pitch/wsola.py:
// 112-141), which has no Pallas kernel. Segment i picks its start from a
// region of `seek` candidate offsets at the static position a_i: with the
// reference `ov` samples of x at the previous segment's tail,
//
//   scores[k] = sum_{j < ov} x[a_i + k + j] * ref[j]           (k < seek)
//   norm2[k]  = csq[a_i + ov + k] - csq[a_i + k]
//   best      = first argmax of scores / sqrt(norm2 + 1e-12)
//
// (csq the energy prefix the wrapper passes, float32 sums stored in x's
// type), or seek / 2 where every norm2 <= 1e-12 or the segment is a
// boundary one; start_i = a_i + best, and the next tail is start_i + flat.
// Each step reads from where the last one landed, so the walk over the
// segments is sequential.
//
// One block walks one channel through all its segments, so one launch
// serves a call and the host never waits on a start. Each step's scores
// are one pass over the candidate region: the threads hold up to
// kPerThread offsets each (offset k on thread k mod kThreads), and the
// region and the reference are staged through shared memory in tiles of
// kTile reference samples. A thread sums its offsets' products in order
// of j, each product and sum rounded by itself (the source is built with
// -fmad=false, _build.EXTRA_FLAGS), which is the order and rounding of the
// plain version in ops/wsola.py, so the two agree bit for bit. A block
// reduction then picks the largest normalised score with the lowest index
// (NaN counting as the largest, as jnp.argmax and torch.argmax take it).
// Bound: the seek x ov multiply-adds of each step (18.1 M a channel at the
// music preset's 28 segments) on one SM a channel; the bytes are a few
// hundred kilobytes. float and double.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                    // offsets a thread holds
constexpr int kChunk = kThreads * kPerThread;    // offsets a pass covers
constexpr int kTile = 128;                       // reference samples a tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// a (value, index) pair beats b: NaN first, then the larger value, then
// the lower index
template <typename T>
__device__ __forceinline__ bool beats(T va, int ia, T vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (na) return ia < ib;
  return va > vb || (va == vb && ia < ib);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wsola_search_kernel(
    const T* __restrict__ x, const T* __restrict__ csq,
    const int* __restrict__ region_starts, const uint8_t* __restrict__ boundary,
    int* __restrict__ starts, int C, long long n_ext, int S, int ov, int seek,
    int flat, int tail0) {
  __shared__ T ref_s[kTile];
  __shared__ T reg_s[kChunk + kTile];
  __shared__ T red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int red_loud[kWarps];
  __shared__ int next_tail;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const T* xc = x + static_cast<size_t>(c) * static_cast<size_t>(n_ext);
  const T* qc = csq + static_cast<size_t>(c) * static_cast<size_t>(n_ext + 1);
  const T eps = static_cast<T>(1e-12);
  long long tail = tail0;
  for (int s = 0; s < S; ++s) {
    const long long a = region_starts[s];
    T bv = -INFINITY;
    int bi = INT_MAX;
    int loud = 0;   // some norm2 is not <= 1e-12 (NaN included)
    for (int kb = 0; kb < seek; kb += kChunk) {
      const int width = min(kChunk, seek - kb);
      T acc[kPerThread];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) acc[r] = T(0);
      for (int j0 = 0; j0 < ov; j0 += kTile) {
        const int tj = min(kTile, ov - j0);
        __syncthreads();   // the last tile's readers are done
        for (int jj = tid; jj < tj; jj += kThreads) ref_s[jj] = xc[tail + j0 + jj];
        const int span = width + tj - 1;
        for (int u = tid; u < span; u += kThreads) reg_s[u] = xc[a + kb + j0 + u];
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
          const int kk = tid + r * kThreads;
          if (kk < width) {
            T sum = acc[r];
            for (int jj = 0; jj < tj; ++jj) sum = sum + reg_s[kk + jj] * ref_s[jj];
            acc[r] = sum;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int kk = tid + r * kThreads;
        if (kk < width) {
          const int k = kb + kk;
          const T norm2 = qc[a + ov + k] - qc[a + k];
          const T v = acc[r] / sqrt(norm2 + eps);
          if (beats(v, k, bv, bi)) {
            bv = v;
            bi = k;
          }
          loud |= !(norm2 <= eps);
        }
      }
    }
    // block reduction: the best pair and whether any offset was loud
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T other_v = __shfl_down_sync(kFull, bv, off);
      const int other_i = __shfl_down_sync(kFull, bi, off);
      if (beats(other_v, other_i, bv, bi)) {
        bv = other_v;
        bi = other_i;
      }
    }
    loud = __any_sync(kFull, loud);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
      red_loud[warp] = loud;
    }
    __syncthreads();
    if (tid == 0) {
      T v = red_v[0];
      int i = red_i[0];
      int any = red_loud[0];
      for (int w = 1; w < kWarps; ++w) {
        if (beats(red_v[w], red_i[w], v, i)) {
          v = red_v[w];
          i = red_i[w];
        }
        any |= red_loud[w];
      }
      const int best = (!any || boundary[s]) ? seek / 2 : i;
      const int start = static_cast<int>(a) + best;
      starts[static_cast<size_t>(s) * C + c] = start;
      next_tail = start + flat;
    }
    __syncthreads();
    tail = next_tail;
  }
}

// One thread's dependent sum of n products, as a thread sums its scores
// (each product and sum rounded by itself), between two clock64() stamps.
__global__ void wsola_sum_latency_kernel(long long n, float a, long long* cycles,
                                         float* sink) {
  float sum = 0.0f, b = a;
  const long long t0 = clock64();
  for (long long i = 0; i < n; ++i) {
    sum = sum + b * a;
    b = -b;
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = sum;
}

template <typename T>
int launch(const T* x, const T* csq, const int* region_starts,
           const uint8_t* boundary, int* starts, int C, long long n_ext, int S,
           int ov, int seek, int flat, int tail0, void* stream) {
  wsola_search_kernel<T><<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, csq, region_starts, boundary, starts, C, n_ext, S, ov, seek, flat,
      tail0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (C, n_ext); csq: (C, n_ext + 1); region_starts: (S,) int32;
// boundary: (S,) uint8; starts: (S, C) int32 out. The wrapper checks that
// every read lies inside x. Returns cudaGetLastError() after the launch.
int wsola_search_f32(const float* x, const float* csq, const int* region_starts,
                     const uint8_t* boundary, int* starts, int C,
                     long long n_ext, int S, int ov, int seek, int flat,
                     int tail0, void* stream) {
  return launch<float>(x, csq, region_starts, boundary, starts, C, n_ext, S, ov,
                       seek, flat, tail0, stream);
}

int wsola_search_f64(const double* x, const double* csq,
                     const int* region_starts, const uint8_t* boundary,
                     int* starts, int C, long long n_ext, int S, int ov,
                     int seek, int flat, int tail0, void* stream) {
  return launch<double>(x, csq, region_starts, boundary, starts, C, n_ext, S,
                        ov, seek, flat, tail0, stream);
}

// The cycles of n dependent steps of a score's sum on one thread
// (cycles: one int64, sink: one float, both on the device), for the
// walk's chain bound.
int wsola_sum_latency(long long n, long long* cycles, float* sink,
                      void* stream) {
  wsola_sum_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      n, 0.75f, cycles, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
