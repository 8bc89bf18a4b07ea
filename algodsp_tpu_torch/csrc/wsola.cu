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
// Bound: each step is one dependent chain of ov adds a score (a product
// and a sum, each rounded), so the walk takes at least S x ov add
// latencies in a row (`wsola_sum_latency`, ~4.4 cycles a step); the
// seek x ov products of a step are spread over the card so that the
// chain, not the issue rate, sets the pace. The bytes are a few hundred
// kilobytes.
//
// Design: one thread-block cluster of kCluster = 8 blocks (the portable
// size) walks one channel through all its segments, so one launch serves a
// call and the host never waits on a start. Block r of the cluster owns
// the offsets [r pb, (r + 1) pb) of every step (pb = ceil(seek / 8)), two
// neighbouring ones a summing thread. A thread sums each offset's products
// in order of j, each product and sum rounded by itself (the source is
// built with -fmad=false, _build.EXTRA_FLAGS): the order and rounding of
// the plain version in ops/wsola.py, so the two agree bit for bit. One
// aligned two-sample load of the region serves both of a thread's sums,
// the reference comes four samples a load from an aligned copy in shared
// memory, and the loads of a batch of 8 steps of j issue before the last
// batch's sums. Each summing warp then reduces its (value, index) pairs by
// shuffles and pushes its pair into every block's shared memory
// (distributed shared memory stores), and after one cluster barrier every
// warp reduces its own block's copy of the cluster's pairs the same way,
// so every block knows the start without a round trip through global
// memory. The largest normalised score with the lowest index wins (NaN
// counting as the largest, as jnp.argmax and torch.argmax take it); the
// pairs are totally ordered, so the reduction's shape cannot change the
// result. Boundary segments take seek / 2 and skip their sums and the
// exchange.
//
// Two schedules feed the sums (ops/wsola.py::plan picks one):
//  - staged, where its two stages fit in shared memory (every preset at
//    48 and 96 kHz): the last warp of each block only copies. The window
//    the next reference lies in (a_{i-1} + flat + [0, seek - 1 + ov),
//    whatever offset the last step picked), the block's region slice and
//    its energies do not depend on the walk, so while step i sums,
//    cp.async copies step i + 1's into the other of two buffers, and after
//    the exchange the reference is copied from the window in shared
//    memory. The static grid (region starts, boundary flags) is read two
//    steps ahead of its use.
//  - tiled, for longer seeks and overlaps (up to the pitch-time node's 40
//    and 60 ms at 192 kHz and beyond): each step reads the reference from
//    global memory at the last start, and the block's offsets go in passes
//    of one pair a summing thread, each pass over j in tiles of kTile
//    samples of the reference and its region; the sums carry across the
//    tiles in order of j, and the energies are read from global memory.
//    The thread of an offset and the reductions are those of the staged
//    schedule, so both give the same starts.
// A step of the staged schedule is its sums, then its exchange (two warp
// reductions, the pushes and the cluster barrier). float and double.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;   // (128 registers a thread)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStaticSmem = 12288;   // room left for the kernel's inboxes
constexpr int kCluster = 8;     // blocks a channel's cluster
constexpr int kTile = 2048;     // samples of j a tile (tiled schedule)
constexpr int kGroup = 2;       // consecutive offsets a thread sums at once
constexpr int kBatch = 8;       // steps of j whose loads issue together

// two neighbouring samples, loaded together
template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T x, y;
};

// four neighbouring samples, loaded together
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T a, b, c, d;
};

// a batch of the sum loop: the pairs of the region holding samples
// j .. j + kBatch + 1 after a thread's first offset, and kBatch samples of
// the reference from j (its aligned copy: four a load, the same for every
// thread)
template <typename T>
__device__ __forceinline__ void load_batch(Pair<T>* p, T* q, const Pair<T>* r,
                                           const T* ref, int j) {
#pragma unroll
  for (int u = 0; u < kBatch / 2 + 1; ++u) p[u] = r[j / 2 + u];
#pragma unroll
  for (int u = 0; u < kBatch; u += 4) {
    const Quad<T> f = *reinterpret_cast<const Quad<T>*>(ref + j + u);
    q[u] = f.a;
    q[u + 1] = f.b;
    q[u + 2] = f.c;
    q[u + 3] = f.d;
  }
}

// A stage in shared memory (elements): the window the step's reference
// lies in (seek - 1 + ov), the block's region slice (its last pair's loads
// reach one sample past the slice) and the slice's energies at a + k and
// a + ov + k; each part starts on 16 bytes.
struct Layout {
  int pb2, ref, reg, q, stage;
  __host__ __device__ Layout(int seek, int ov, int pb) {
    pb2 = (pb + kGroup - 1) / kGroup * kGroup;
    ref = up4(ov);   // the step's reference, copied to an aligned place
    reg = up4(seek + ov - 1);
    q = reg + up4(pb2 + ov);
    stage = q + up4(2 * pb2);
  }
  // elements a block: the reference, then two stages
  __host__ __device__ int total() const { return ref + 2 * stage; }
  __host__ __device__ static int up4(int n) { return (n + 3) / 4 * 4; }
};
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

// the warp's best pair and whether any lane was loud, on every lane
template <typename T>
__device__ __forceinline__ void warp_best(T& v, int& i, int& loud) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  loud = __any_sync(kFull, loud);
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int len,
                                           int tid, int nt) {
  for (int u = tid; u < len; u += nt) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + u));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src + u), "n"(sizeof(T)));
  }
}

// The two sums of a thread's offsets over one batch of j, in order of j
template <typename T>
__device__ __forceinline__ void sum_batch(T& s0, T& s1, const Pair<T>* p,
                                          const T* q) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const T e0 = u % 2 == 0 ? p[u / 2].x : p[u / 2].y;
    const T e1 = u % 2 == 0 ? p[u / 2].y : p[u / 2 + 1].x;
    s0 = s0 + e0 * q[u];
    s1 = s1 + e1 * q[u];
  }
}

// A thread's two sums carried over len samples of j, in order of j: reg
// the region at its first offset (on a pair), ref the reference (on 4
// samples), both in shared memory. The products go in batches of kBatch
// steps of j, in two register sets in turn: a batch's loads issue before
// the last one's sums, so that their latency hides behind the two chains
// of adds. Each pair loaded once serves both sums, and neighbouring
// threads read neighbouring pairs (no bank conflict).
template <typename T>
__device__ __forceinline__ void sum_span(T& s0, T& s1, const T* reg,
                                         const T* ref, int len) {
  const Pair<T>* r = reinterpret_cast<const Pair<T>*>(reg);
  const int nb = len / kBatch;
  Pair<T> ra[kBatch / 2 + 1], rb[kBatch / 2 + 1];
  T fa[kBatch], fb[kBatch];
  if (nb > 0) load_batch(ra, fa, r, ref, 0);
  int bt = 0;
  for (; bt + 1 < nb; bt += 2) {
    load_batch(rb, fb, r, ref, (bt + 1) * kBatch);
    sum_batch(s0, s1, ra, fa);
    load_batch(ra, fa, r, ref, min(bt + 2, nb - 1) * kBatch);
    sum_batch(s0, s1, rb, fb);
  }
  if (bt < nb) sum_batch(s0, s1, ra, fa);
  for (int j = nb * kBatch; j < len; ++j) {
    s0 = s0 + reg[j] * ref[j];
    s1 = s1 + reg[1 + j] * ref[j];
  }
}

// Offsets k0 and k0 + 1 (below k_hi) with their sums into the thread's
// running best (value, index) and whether some norm2 is loud; energies
// q[u] at a + k0 + u and q[u + qs] at a + ov + k0 + u
template <typename T>
__device__ __forceinline__ void score_pair(T s0, T s1, const T* q, int qs,
                                           int k0, int k_hi, T eps, T& bv,
                                           int& bi, int& loud) {
  const T sums[kGroup] = {s0, s1};
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int k = k0 + u;
    if (k < k_hi) {
      const T norm2 = q[qs + u] - q[u];
      const T v = sums[u] / sqrt(norm2 + eps);
      if (beats(v, k, bv, bi)) {
        bv = v;
        bi = k;
      }
      loud |= !(norm2 <= eps);
    }
  }
}

template <typename T, bool kTiled>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
    wsola_cluster_kernel(const T* __restrict__ x, const T* __restrict__ csq,
                         const int* __restrict__ region_starts,
                         const uint8_t* __restrict__ boundary,
                         int* __restrict__ starts, int C, long long n_ext,
                         int S, int ov, int seek, int flat, int tail0, int pb) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  // the cluster's pairs of the last two exchanges, each summing warp's
  // pushed into every block's inbox (block rank r, warp w at r * sw + w)
  __shared__ T box_v[2][kCluster * kMaxWarps];
  __shared__ int box_i[2][kCluster * kMaxWarps];
  __shared__ int box_loud[2][kCluster * kMaxWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int sw = blockDim.x / 32 - 1;   // summing warps; the last one copies
  const int st = 32 * sw;               // summing threads
  const bool copier = warp == sw;
  const T* xc = x + static_cast<size_t>(c) * static_cast<size_t>(n_ext);
  const T* qc = csq + static_cast<size_t>(c) * static_cast<size_t>(n_ext + 1);
  const T eps = static_cast<T>(1e-12);
  const int win_len = seek + ov - 1;
  const int k_lo = min(seek, rank * pb), k_hi = min(seek, k_lo + pb);
  const Layout lay(seek, ov, pb);
  T* refbuf = reinterpret_cast<T*>(smem_raw);
  T* buf = refbuf + (kTiled ? Layout::up4(kTile) : lay.ref);

  // staged: stage s (the segment at a, a boundary one where edge), copied
  // by the copy warp: the window that holds its reference (at tail0 for
  // the first step, else after the last region's flat part), this block's
  // slice of its region, and the slice's energies csq[a + k] and
  // csq[a + ov + k]
  auto stage = [&](int s, int a_prev, int a, int edge) {
    if (s < S && !edge) {
      T* win = buf + (s & 1) * lay.stage;
      if (s == 0)
        copy_async(win, xc + tail0, ov, lane, 32);
      else
        copy_async(win, xc + a_prev + flat, win_len, lane, 32);
      if (k_hi > k_lo) {
        copy_async(win + lay.reg, xc + a + k_lo, k_hi - k_lo + ov - 1, lane, 32);
        copy_async(win + lay.q, qc + a + k_lo, k_hi - k_lo, lane, 32);
        copy_async(win + lay.q + lay.pb2, qc + a + ov + k_lo, k_hi - k_lo, lane,
                   32);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the static grid, read a step ahead of its use
  int a_cur = region_starts[0], e_cur = boundary[0];
  int a_nxt = S > 1 ? region_starts[1] : 0, e_nxt = S > 1 ? boundary[1] : 1;
  if (!kTiled && copier) stage(0, 0, a_cur, e_cur);
  int prev = 0;     // the offset the last step picked (its reference's
                    // place in this step's window)
  int tail = tail0; // the reference's start in x
  int phase = 0;    // exchanges so far: their slot is phase & 1
  for (int s = 0; s < S; ++s) {
    const int a_far = s + 2 < S ? region_starts[s + 2] : 0;
    const int e_far = s + 2 < S ? boundary[s + 2] : 1;
    if (!kTiled) {
      if (copier) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();   // stage s is in shared memory
      // the next stage's buffer was last read before the last exchange's
      // cluster barrier; its copies run while this step sums
      if (copier) stage(s + 1, a_cur, a_nxt, e_nxt);
    }
    int best = seek / 2;
    if (!e_cur) {
      const int slot = phase & 1;
      T bv = -INFINITY;
      int bi = INT_MAX;
      int loud = 0;   // some norm2 is not <= 1e-12 (NaN included)
      if (!kTiled && !copier) {
        const T* win = buf + (s & 1) * lay.stage;
        const T* reg = win + lay.reg;
        const T* q0 = win + lay.q;
        // the reference (at the last start's place in the window) to its
        // aligned copy; the summing warps' own barrier
        for (int j = tid; j < ov; j += st) refbuf[j] = win[(s == 0 ? 0 : prev) + j];
        asm volatile("bar.sync 1, %0;" ::"r"(st) : "memory");
        for (int g = tid; k_lo + kGroup * g < k_hi; g += st) {
          const int kl = kGroup * g;
          T s0 = T(0), s1 = T(0);
          sum_span(s0, s1, reg + kl, refbuf, ov);
          score_pair(s0, s1, q0 + kl, lay.pb2, k_lo + kl, k_hi, eps, bv, bi,
                     loud);
        }
      }
      if (kTiled) {
        // passes of one pair a summing thread (the staged schedule's
        // groups t, t + st, ...), each over j in tiles; all warps copy
        T* reg = buf;
        const int kl = kGroup * tid;
        for (int c0 = k_lo; c0 < k_hi; c0 += kGroup * st) {
          const int cl = min(kGroup * st, k_hi - c0);
          T s0 = T(0), s1 = T(0);
          for (int j0 = 0; j0 < ov; j0 += kTile) {
            const int jl = min(kTile, ov - j0);
            __syncthreads();   // the last tile is read
            for (int u = tid; u < jl; u += blockDim.x) refbuf[u] = xc[tail + j0 + u];
            for (int u = tid; u < cl + jl; u += blockDim.x)
              reg[u] = xc[a_cur + c0 + j0 + u];
            __syncthreads();
            if (!copier && kl < cl) sum_span(s0, s1, reg + kl, refbuf, jl);
          }
          if (!copier && kl < cl) {
            const T q[2 * kGroup] = {
                qc[a_cur + c0 + kl], qc[a_cur + c0 + kl + 1],
                qc[a_cur + ov + c0 + kl], qc[a_cur + ov + c0 + kl + 1]};
            score_pair(s0, s1, q, kGroup, c0 + kl, k_hi, eps, bv, bi, loud);
          }
        }
      }
      if (!copier) {
        warp_best(bv, bi, loud);
        if (lane < kCluster) {   // into block `lane`'s inbox
          const int at = rank * sw + warp;
          *cluster.map_shared_rank(&box_v[slot][at], lane) = bv;
          *cluster.map_shared_rank(&box_i[slot][at], lane) = bi;
          *cluster.map_shared_rank(&box_loud[slot][at], lane) = loud;
        }
      }
      cluster.sync();   // every pair in every inbox; the stage read
      // every warp reduces its block's inbox in the same way
      bv = -INFINITY;
      bi = INT_MAX;
      loud = 0;
      for (int u = lane; u < kCluster * sw; u += 32) {
        if (beats(box_v[slot][u], box_i[slot][u], bv, bi)) {
          bv = box_v[slot][u];
          bi = box_i[slot][u];
        }
        loud |= box_loud[slot][u];
      }
      warp_best(bv, bi, loud);
      if (loud) best = bi;
      ++phase;
      // a slot is written again two exchanges on, after the next cluster
      // barrier, which no block reaches before it has read this one
    }
    if (rank == 0 && tid == 0) starts[static_cast<size_t>(s) * C + c] = a_cur + best;
    prev = best;
    tail = a_cur + best + flat;
    a_cur = a_nxt;
    e_cur = e_nxt;
    a_nxt = a_far;
    e_nxt = e_far;
  }
  if (!kTiled && copier) asm volatile("cp.async.wait_all;\n" ::: "memory");
  // no block leaves while another may still write into its inbox
  cluster.sync();
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

// shared memory bytes a block: the staged schedule's reference and two
// stages, or the tiled one's reference tile and region tile (a pass of
// pairs and its last pair's loads)
template <typename T>
size_t smem_bytes(int seek, int ov, int pb, int threads, bool tiled) {
  if (tiled)
    return static_cast<size_t>(Layout::up4(kTile) +
                               Layout::up4(kGroup * (threads - 32) + kTile + 2)) *
           sizeof(T);
  return static_cast<size_t>(Layout(seek, ov, pb).total()) * sizeof(T);
}

template <typename T, bool kTiled>
int launch(const T* x, const T* csq, const int* region_starts,
           const uint8_t* boundary, int* starts, int C, long long n_ext, int S,
           int ov, int seek, int flat, int tail0, int threads, void* stream) {
  if (C < 1 || S < 1 || ov < 1 || seek < 1 || flat < 1 || threads < 64 ||
      threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pb = (seek + kCluster - 1) / kCluster;
  const size_t smem = smem_bytes<T>(seek, ov, pb, threads, kTiled);
  // opt in once per device to the largest dynamic shared memory, so that
  // later calls and a CUDA graph capturing them make no attribute call
  static int opted_in[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !opted_in[dev]) {
    int max_optin = 0;
    err = cudaDeviceGetAttribute(&max_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(wsola_cluster_kernel<T, kTiled>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_optin - kStaticSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted_in[dev] = 1;
  }
  wsola_cluster_kernel<T, kTiled>
      <<<C * kCluster, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          x, csq, region_starts, boundary, starts, C, n_ext, S, ov, seek, flat,
          tail0, pb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const T* x, const T* csq, const int* region_starts,
               const uint8_t* boundary, int* starts, int C, long long n_ext,
               int S, int ov, int seek, int flat, int tail0, int threads,
               int tiled, void* stream) {
  return tiled ? launch<T, true>(x, csq, region_starts, boundary, starts, C,
                                 n_ext, S, ov, seek, flat, tail0, threads, stream)
               : launch<T, false>(x, csq, region_starts, boundary, starts, C,
                                  n_ext, S, ov, seek, flat, tail0, threads,
                                  stream);
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (C, n_ext); csq: (C, n_ext + 1); region_starts: (S,) int32;
// boundary: (S,) uint8; starts: (S, C) int32 out; `threads` the block's
// and `tiled` the schedule (ops/wsola.py::plan). The wrapper checks that
// every read lies inside x. Returns the launch's error code (a refused
// cluster launch, or a staged schedule over the shared memory, included).
int wsola_search_f32(const float* x, const float* csq, const int* region_starts,
                     const uint8_t* boundary, int* starts, int C,
                     long long n_ext, int S, int ov, int seek, int flat,
                     int tail0, int threads, int tiled, void* stream) {
  return launch_any<float>(x, csq, region_starts, boundary, starts, C, n_ext, S,
                           ov, seek, flat, tail0, threads, tiled, stream);
}

int wsola_search_f64(const double* x, const double* csq,
                     const int* region_starts, const uint8_t* boundary,
                     int* starts, int C, long long n_ext, int S, int ov,
                     int seek, int flat, int tail0, int threads, int tiled,
                     void* stream) {
  return launch_any<double>(x, csq, region_starts, boundary, starts, C, n_ext,
                            S, ov, seek, flat, tail0, threads, tiled, stream);
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
