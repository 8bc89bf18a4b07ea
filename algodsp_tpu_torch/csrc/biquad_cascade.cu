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
// 8 bytes a sample, ~1 us at the flagship's 8 x 48128. The work is a
// recurrence along time in float64 (a float32 direct form reads 117 dB
// against float64 on the Butterworth cascade, under the 120 dB bar): ten
// float64 multiply-adds a sample per section here, on an FP64 pipe of 64
// a clock per SM. At the main path's shapes what bounds it is latency:
// each section costs a block scan, barriers and (in a cluster) a cluster
// barrier, several times the walk itself (PERF.md).
//
// Design: section-major, as the TPU kernel is, with a carry of two
// values per section. Each section runs in transposed direct form II,
// whose state (s1, s2) holds the whole past of the section, inputs
// included: y = b0 v + s1, s1 <- b1 v - a1 y + s2, s2 <- b2 v - a2 y. One
// block per channel stages a segment of gain * x in shared memory in
// float64; each thread owns a chunk of L consecutive samples (L odd, so
// that the threads' strided accesses fall on distinct banks). A full
// chunk maps its entering state c to G c + w: G the section's 2 x 2
// state transition over L samples, w the chunk's end state from c = 0.
// For each section in order:
//   scan: a block scan of the chunks' maps (warp shuffles, then warp 0
//         over the warp totals), with the powers G^m from a host table,
//         gives every chunk its true entering state from the segment's;
//   walk: each chunk runs the section from its true state, writing the
//         section's output in place, and at once runs the next section
//         from zero state over those outputs, which is the next
//         section's w.
// Every stored sample is the recurrence's output from a state correct to
// rounding, so nothing cancels. The state in and out is the direct
// form's (C, S, 4): converted to (s1, s2) where a segment starts, and
// read back from the section's last two inputs and outputs where it
// ends; a segment's end state seeds the next segment. Host tables per
// section (float64, ops/biquad_cascade.py::section_tables): b0 b1 b2 a1
// a2, G^1..G^32, G^64, G^128, G^256, G^512, and the transition over a
// segment; read from shared memory (the next section's copied during the
// scan and the walk).
//
// Where the channels are too few to fill the card, a channel's segments
// run at once on a cluster of B blocks (B <= 8): after each section's
// scan, block b publishes its segment's end state from a zero entering
// state, and after one cluster barrier every later block composes the
// earlier ones' through distributed shared memory into its own entering
// state, which each chunk adds through G^k (k its index). Otherwise
// (B = 1) one block walks the channel's segments in order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define MAX_SECTIONS 64
#define BQ_MAX_THREADS 512
#define BQ_SMEM_BYTES 196608
#define BQ_STAGE 48  // staged per thread: BQ_SMEM_BYTES / 8 / BQ_MAX_THREADS
#define BQ_MAX_CLUSTER 8
#define BQ_TAB 153   // doubles per section: 5 coefficients, 37 matrices
#define BQ_POW 5     // offset of G^1 in a section's table
#define BQ_SEG 149   // offset of the transition over a segment

// One step of a section in transposed direct form II with coefficients
// k = (b0 b1 b2 a1 a2): the output, and the state (s1, s2) updated.
__device__ __forceinline__ double step(const double (&k)[5], double v,
                                       double& s1, double& s2) {
  const double y = fma(k[0], v, s1);
  s1 = fma(-k[3], y, fma(k[1], v, s2));
  s2 = fma(-k[4], y, k[2] * v);
  return y;
}

__device__ __forceinline__ void load_coef(const double* tab, double (&k)[5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) k[i] = tab[i];
}

// Block scan of the chunks' maps c -> G c + w in thread order, from the
// block's entering state (c1, c2): returns in (e1, e2) the state entering
// this thread's chunk. pw in shared memory holds G^m at pw[4 (m - 1) ...]
// for m = 1..32 and G^(32 << j) at pw[4 (31 + j) ...]. Each warp scans
// its 32 chunks by shuffles, warp 0 scans the warp totals (G^32 is a full
// warp's map), and each warp takes its entering state from there. Every
// chunk but the last real one is full, so G is the map of every chunk
// whose state is used.
__device__ __forceinline__ void carry_scan(double w1, double w2,
                                           const double* pw, double c1,
                                           double c2, double* s_tot,
                                           double& e1, double& e2) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u1 = __shfl_up_sync(full, w1, o);
    const double u2 = __shfl_up_sync(full, w2, o);
    if (lane >= o) {
      const double* g = pw + 4 * (o - 1);
      w1 = fma(g[0], u1, fma(g[1], u2, w1));
      w2 = fma(g[2], u1, fma(g[3], u2, w2));
    }
  }
  if (lane == 31) {
    s_tot[2 * warp] = w1;
    s_tot[2 * warp + 1] = w2;
  }
  __syncthreads();
  if (warp == 0) {
    // lane j: the state after warp j, the block's entering state folded in
    double t1 = lane < nwarps ? s_tot[2 * lane] : 0.0;
    double t2 = lane < nwarps ? s_tot[2 * lane + 1] : 0.0;
    if (lane == 0) {
      const double* g = pw + 4 * 31;
      t1 = fma(g[0], c1, fma(g[1], c2, t1));
      t2 = fma(g[2], c1, fma(g[3], c2, t2));
    }
#pragma unroll
    for (int o = 1, j = 0; o < 32; o <<= 1, ++j) {
      const double u1 = __shfl_up_sync(full, t1, o);
      const double u2 = __shfl_up_sync(full, t2, o);
      if (lane >= o) {
        const double* g = pw + 4 * (31 + j);
        t1 = fma(g[0], u1, fma(g[1], u2, t1));
        t2 = fma(g[2], u1, fma(g[3], u2, t2));
      }
    }
    if (lane < nwarps) {
      s_tot[2 * lane] = t1;
      s_tot[2 * lane + 1] = t2;
    }
  }
  __syncthreads();
  const double p1 = warp == 0 ? c1 : s_tot[2 * warp - 2];
  const double p2 = warp == 0 ? c2 : s_tot[2 * warp - 1];
  // entering this chunk: G^lane p plus the warp's carry after lane - 1
  const double q1 = __shfl_up_sync(full, w1, 1);
  const double q2 = __shfl_up_sync(full, w2, 1);
  if (lane == 0) {
    e1 = p1;
    e2 = p2;
  } else {
    const double* g = pw + 4 * (lane - 1);
    e1 = fma(g[0], p1, fma(g[1], p2, q1));
    e2 = fma(g[2], p1, fma(g[3], p2, q2));
  }
}

// The section's walk over buf[start, end) from its true state (s1, s2),
// in place; with NEXT, the next section (coefficients kn) from zero state
// over the outputs, whose end state it leaves in (n1, n2).
template <bool NEXT>
__device__ __forceinline__ void walk(double* buf, int start, int end,
                                     const double (&k)[5],
                                     const double (&kn)[5], double s1,
                                     double s2, double& n1, double& n2) {
  n1 = 0.0;
  n2 = 0.0;
#pragma unroll 4
  for (int i = start; i < end; ++i) {
    const double out = step(k, buf[i], s1, s2);
    buf[i] = out;
    if (NEXT) step(kn, out, n1, n2);
  }
}

// Asynchronous copies (cp.async, no registers held) of src[0, len) into
// the upper half of buf as float32, and of the first section's table
// into s_tab; stage_finish waits for them and widens x to gain * x in
// float64 in place. The doubles below len / 2 lie under the floats and
// are written at once; the rest overwrite floats, so those are read into
// registers first, and written after a barrier.
__device__ __forceinline__ void stage_start(double* buf,
                                            const float* __restrict__ src,
                                            int len, double* s_tab,
                                            const double* __restrict__ tab) {
  float* f = reinterpret_cast<float*>(buf) + len;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(f + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src + i));
  }
  for (int i = threadIdx.x; i < BQ_TAB; i += blockDim.x) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s_tab + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(tab + i));
  }
}

__device__ __forceinline__ void stage_finish(double* buf, int len,
                                             float gain) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float* f = reinterpret_cast<const float*>(buf) + len;
  const int half = len / 2;
  for (int i = threadIdx.x; i < half; i += blockDim.x)
    buf[i] = (double)(f[i] * gain);
  float v[BQ_STAGE / 2 + 1];
#pragma unroll
  for (int b = 0; b < BQ_STAGE / 2 + 1; ++b) {
    const int i = half + threadIdx.x + b * blockDim.x;
    if (i < len) v[b] = f[i];
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < BQ_STAGE / 2 + 1; ++b) {
    const int i = half + threadIdx.x + b * blockDim.x;
    if (i < len) buf[i] = (double)(v[b] * gain);
  }
}

// (v1, v2) <- G^m (v1, v2), 0 <= m < 1024, from the table's powers of two
// (pw as in carry_scan).
__device__ __forceinline__ void apply_power(const double* pw, int m,
                                            double& v1, double& v2) {
  for (int j = 0; m; ++j, m >>= 1) {
    if (m & 1) {
      const double* g = pw + 4 * (j <= 5 ? (1 << j) - 1 : 26 + j);
      const double t = fma(g[0], v1, g[1] * v2);
      v2 = fma(g[2], v1, g[3] * v2);
      v1 = t;
    }
  }
}

// st: (S, 4) float64 in shared memory, the direct-form state entering
// the segment, left as the state after it. tab: (S, BQ_TAB) float64.
// Block b of a channel's cluster of B takes segments b, b + B, ... (one
// each for B > 1).
__global__ void __launch_bounds__(BQ_MAX_THREADS)
    biquad_section_major(const float* __restrict__ x, float* __restrict__ y,
                         const double* __restrict__ tab,
                         const float* __restrict__ state_in,
                         float* __restrict__ state_out, float gain,
                         long long n, int S, int seg, int L, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* buf = reinterpret_cast<double*>(smem_raw);
  __shared__ double st[4 * MAX_SECTIONS];
  __shared__ double s_tot[2 * (BQ_MAX_THREADS / 32)];
  __shared__ double s_tab[2][BQ_TAB];
  __shared__ double s_end[2][2];  // this segment's end state, by parity
  __shared__ double s_in[2];      // this segment's entering state
  const unsigned full = 0xffffffffu;
  const int rank = blockIdx.x % B, c = blockIdx.x / B;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const float* xc = x + (size_t)c * n;
  float* yc = y + (size_t)c * n;
  long long base = (long long)rank * seg;
  int len = (int)min((long long)seg, n - base);
  stage_start(buf, xc + base, len, s_tab[0], tab);
  for (int i = tid; i < 4 * S; i += nt)
    st[i] = state_in ? (double)state_in[(size_t)c * 4 * S + i] : 0.0;
  stage_finish(buf, len, gain);

  for (; base < n; base += (long long)B * seg) {
    len = (int)min((long long)seg, n - base);
    __syncthreads();
    const int start = min(tid * L, len), end = min(start + L, len);
    const bool last = start < len && end == len;  // holds sample len - 1
    double k[5], kn[5];
    load_coef(s_tab[0], k);
    // section 0 from zero state
    double w1 = 0.0, w2 = 0.0;
    for (int i = start; i < end; ++i) step(k, buf[i], w1, w2);
    for (int s = 0; s < S; ++s) {
      const double* pw = s_tab[s & 1] + BQ_POW;
      double* sts = st + 4 * s;
      // the segment's entering state in (s1, s2); in a cluster, zero but
      // for block 0 until the exchange below
      double c1 = 0.0, c2 = 0.0;
      if (rank == 0) {
        c1 = fma(k[1], sts[0], fma(k[2], sts[1],
                 fma(-k[3], sts[2], -k[4] * sts[3])));
        c2 = fma(k[2], sts[0], -k[4] * sts[2]);
      }
      // the section's last two inputs, for the direct-form state out
      double in1 = 0.0, in2 = 0.0;
      if (last) {
        in1 = buf[len - 1];
        in2 = len > 1 ? buf[len - 2] : sts[0];
      }
      // the next section's table, copied to shared memory under the scan
      // and the walk (cp.async), its coefficients to registers
      const bool next = s + 1 < S;
      const double* tnext = tab + (size_t)(s + 1) * BQ_TAB;
      if (next) {
        for (int i = tid; i < BQ_TAB; i += nt) {
          const unsigned dst =
              (unsigned)__cvta_generic_to_shared(&s_tab[(s + 1) & 1][i]);
          asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                       "l"(tnext + i));
        }
#pragma unroll
        for (int i = 0; i < 5; ++i) kn[i] = __ldg(tnext + i);
      }
      double e1, e2;
      carry_scan(w1, w2, pw, c1, c2, s_tot, e1, e2);
      if (B > 1) {
        // publish the segment's end state (the last chunk is full in
        // every segment but the channel's last), then compose the earlier
        // segments' into this one's entering state
        cg::cluster_group cluster = cg::this_cluster();
        if (last && rank + 1 < B) {
          s_end[s & 1][0] = fma(pw[0], e1, fma(pw[1], e2, w1));
          s_end[s & 1][1] = fma(pw[2], e1, fma(pw[3], e2, w2));
        }
        cluster.sync();
        if (rank > 0) {
          if (tid < 32) {
            double r1 = 0.0, r2 = 0.0;
            if (lane < rank) {
              const double* e = cluster.map_shared_rank(&s_end[s & 1][0], lane);
              r1 = e[0];
              r2 = e[1];
            }
            const double* gs = s_tab[s & 1] + BQ_SEG;
            double a1 = 0.0, a2 = 0.0;
            for (int j = 0; j < rank; ++j) {
              const double t1 = __shfl_sync(full, r1, j);
              const double t2 = __shfl_sync(full, r2, j);
              const double u = fma(gs[0], a1, fma(gs[1], a2, t1));
              a2 = fma(gs[2], a1, fma(gs[3], a2, t2));
              a1 = u;
            }
            if (lane == 0) {
              s_in[0] = a1;
              s_in[1] = a2;
            }
          }
          __syncthreads();
          double a1 = s_in[0], a2 = s_in[1];
          apply_power(pw, tid, a1, a2);
          e1 += a1;
          e2 += a2;
        }
        // after the last reads of other blocks' shared memory: no block
        // of the cluster exits before they are done (the wait below)
        if (!next)
          asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      }
      if (next)
        walk<true>(buf, start, end, k, kn, e1, e2, w1, w2);
      else
        walk<false>(buf, start, end, k, kn, e1, e2, w1, w2);
      if (next) asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (last) {
        const double out2 = len > 1 ? buf[len - 2] : sts[2];
        sts[0] = in1;
        sts[1] = in2;
        sts[3] = out2;
        sts[2] = buf[len - 1];
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) k[i] = kn[i];
    }
    for (int i = tid; i < len; i += nt) yc[base + i] = (float)buf[i];
    __syncthreads();
    const long long nbase = base + (long long)B * seg;
    if (nbase < n) {
      const int nlen = (int)min((long long)seg, n - nbase);
      stage_start(buf, xc + nbase, nlen, s_tab[0], tab);
      stage_finish(buf, nlen, gain);
    }
    if (base + len == n)
      for (int i = tid; i < 4 * S; i += nt)
        state_out[(size_t)c * 4 * S + i] = (float)st[i];
  }
  if (B > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (C, n) float32; tab: (S, BQ_TAB) float64 from
// ops/biquad_cascade.py::section_tables for chunk length L and segment
// seg; state_in: (C, S, 4) float32 or null for zero state; state_out:
// (C, S, 4). seg, L, threads and the cluster size B come from
// ops/biquad_cascade.py::segment_plan. Returns cudaGetLastError() after
// the launch.
int biquad_cascade_f32(const float* x, float* y, const double* tab,
                       const float* state_in, float* state_out, float gain,
                       int C, long long n, int S, int seg, int L, int threads,
                       int B, void* stream) {
  const long long smem = (long long)seg * sizeof(double);
  if (S < 1 || S > MAX_SECTIONS || C < 1 || n < 1 || seg < 1 || seg > n ||
      L < 1 || L % 2 == 0 || smem > BQ_SMEM_BYTES || threads < 32 ||
      threads > BQ_MAX_THREADS || threads % 32 ||
      (long long)threads * L < seg || (long long)threads * BQ_STAGE < seg ||
      B < 1 || B > BQ_MAX_CLUSTER ||
      (B > 1 && ((long long)B * seg < n || (long long)(B - 1) * seg + 2 > n ||
                 seg % L)))
    return static_cast<int>(cudaErrorInvalidValue);
  // opt in to the largest segment once per device, so that later calls
  // (and a CUDA graph capturing them) make no attribute call
  static int opted_in[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(biquad_section_major,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BQ_SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted_in[dev] = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * B));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)B;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = B > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, biquad_section_major, x, y, tab, state_in,
                           state_out, gain, n, S, seg, L, B);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
