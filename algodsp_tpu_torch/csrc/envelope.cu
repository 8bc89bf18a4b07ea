// Branching one-pole envelope follower, float32 and float64, for Hopper.
//
// Replaces: algodsp_tpu/ops/pallas_kernels.py::_env_kernel (K4), whose
// front door is envelope_scan_pallas. Same function over x (C, T):
//   env += (x - env) * (x > env ? attack[c] : release[c])
// returning the trajectory (C, T) and env_final (C,). env_final is the
// state after the last real sample (the TPU kernel's carry-out reflects
// its padded tail and is discarded by its wrapper).
//
// What bounds it on the H100: 8 bytes a sample (read x, write the
// trajectory) and four operations, so the byte bound is ~1 us at the
// flagship's 8 x 48128. A walk along time is a chain of T dependent
// steps (~8.8 ns each), 0.42 ms at that shape on 8 threads of the card.
//
// Design: time is split by the selection fixpoint of
// algodsp_tpu/parallel/sharded.py::envelope_time_sharded, with chunks of
// one block in place of shards. Once the attack/release choice of every
// sample is fixed the recurrence is affine, env_out = A env_in + W, so
// chunks compose by a scan. One block per channel stages a segment of x
// (at most 192 KB) in shared memory; each thread owns a contiguous chunk
// of L samples, L odd so that the threads' reads fall on distinct banks.
//   seed:  each chunk runs the exact scan from a seed carry (the true
//          carry for chunk 0, zero for the others), keeping its
//          selection as bits in a register, then its affine summary
//          (A, W) under that selection in float64;
//   sweep: a block-wide exclusive scan of the summaries gives every
//          chunk its incoming carry; each chunk re-runs the plain scan
//          from it, re-deriving its selection (and its summary, where
//          the selection changed: the walks stay in the working type,
//          float64 work and conversions only where needed); repeat until
//          no selection bit flips anywhere (__syncthreads_or), or every
//          chunk's end state meets the next chunk's carry within 4 ulps
//          (flips on exact ties, whose carries differ by rounding);
//   final: each chunk re-runs once more from the converged carry,
//          writing its trajectory in place; the block stores it.
// The final pass is the plain scan's expression sample for sample from
// a carry correct to rounding, so the trajectory matches the walk to
// rounding. The sweeps are capped; at the cap the block completes
// exactly by one thread walking the segment in order (the sequential
// cost, on pathological input only). Per segment the kernel adds to
// four device counters: solves, sweeps, exact walks, and the most
// sweeps one solve took. A segment's end state seeds the next segment.
// A segment of at most ENV_MIN_CHUNK samples is one chunk: the walk.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define ENV_SMEM_BYTES 196608
#define ENV_MAX_THREADS 1024

// The plain scan over xs[start, end) from `env`, returning the end state
// and the chunk's selection (bit i: sample start + i took the attack).
template <typename T>
__device__ __forceinline__ T walk_bits(const T* xs, int start, int end, T env,
                                       T a, T r, unsigned long long& bits) {
  bits = 0ull;
  unsigned long long bit = 1ull;
#pragma unroll 4
  for (int i = start; i < end; ++i) {
    const T xv = xs[i];
    const bool up = xv > env;
    env = env + (up ? a : r) * (xv - env);
    bits |= up ? bit : 0ull;
    bit <<= 1;
  }
  return env;
}

// The same scan writing its trajectory in place.
template <typename T>
__device__ __forceinline__ T walk_write(T* xs, int start, int end, T env, T a,
                                        T r) {
#pragma unroll 4
  for (int i = start; i < end; ++i) {
    const T xv = xs[i];
    env = env + (xv > env ? a : r) * (xv - env);
    xs[i] = env;
  }
  return env;
}

// The chunk's affine map under the selection `bits`, in float64:
// env_out = A env_in + W. Only a chunk whose selection changed needs it
// again, so the walks above stay in the working type.
template <typename T>
__device__ __forceinline__ void summary(const T* xs, int start, int end,
                                        unsigned long long bits, double ad,
                                        double rd, double& A, double& W) {
  A = 1.0;
  W = 0.0;
  for (int i = start; i < end; ++i, bits >>= 1) {
    const bool up = bits & 1ull;
    const double c = up ? ad : rd, m = 1.0 - c;
    W = m * W + c * (double)xs[i];
    A *= m;
  }
}

// A chunk's end state meets the next chunk's carry: equal, both NaN, or
// within 4 ulps. Selections that flip only on ties at that level (x equal
// to the envelope, one carry an ulp off) move the trajectory by rounding.
template <typename T>
__device__ __forceinline__ bool meets(T e, T c) {
  if (e == c || (e != e && c != c)) return true;
  const T eps = sizeof(T) == 4 ? (T)1.1920929e-7 : (T)2.220446049250313e-16;
  return fabs(e - c) <= (T)4 * eps * fmax(fabs(e), fabs(c));
}

// Exclusive block scan of the affine maps (A, W) in thread order:
// returns the composition of every earlier thread's map.
__device__ __forceinline__ void exclusive_affine_scan(double& A, double& W,
                                                      double* sA, double* sW) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double A2 = __shfl_up_sync(full, A, o);
    const double W2 = __shfl_up_sync(full, W, o);
    if (lane >= o) {
      W = A * W2 + W;
      A = A * A2;
    }
  }
  if (lane == 31) {
    sA[warp] = A;
    sW[warp] = W;
  }
  __syncthreads();
  if (warp == 0) {
    double a2 = lane < nwarps ? sA[lane] : 1.0;
    double w2 = lane < nwarps ? sW[lane] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double A2 = __shfl_up_sync(full, a2, o);
      const double W2 = __shfl_up_sync(full, w2, o);
      if (lane >= o) {
        w2 = a2 * W2 + w2;
        a2 = a2 * A2;
      }
    }
    double ea = __shfl_up_sync(full, a2, 1), ew = __shfl_up_sync(full, w2, 1);
    if (lane == 0) {
      ea = 1.0;
      ew = 0.0;
    }
    if (lane < nwarps) {
      sA[lane] = ea;
      sW[lane] = ew;
    }
  }
  __syncthreads();
  double ea = __shfl_up_sync(full, A, 1), ew = __shfl_up_sync(full, W, 1);
  if (lane == 0) {
    ea = 1.0;
    ew = 0.0;
  }
  const double pa = sA[warp], pw = sW[warp];
  A = ea * pa;
  W = ea * pw + ew;
}

// Coalesced copy of src[0, len) into shared memory, ENV_LOAD_BATCH loads
// in flight per thread before their stores: one device-memory latency
// per batch, not per element.
#define ENV_LOAD_BATCH 16
template <typename T>
__device__ __forceinline__ void stage_in(T* xs, const T* __restrict__ src,
                                         int len) {
  const int stride = blockDim.x;
  for (int i0 = threadIdx.x; i0 < len; i0 += ENV_LOAD_BATCH * stride) {
    T v[ENV_LOAD_BATCH];
#pragma unroll
    for (int b = 0; b < ENV_LOAD_BATCH; ++b) {
      const int i = i0 + b * stride;
      if (i < len) v[b] = src[i];
    }
#pragma unroll
    for (int b = 0; b < ENV_LOAD_BATCH; ++b) {
      const int i = i0 + b * stride;
      if (i < len) xs[i] = v[b];
    }
  }
}

// counts: [solves, sweeps, exact walks, most sweeps in one solve]
template <typename T>
__global__ void __launch_bounds__(ENV_MAX_THREADS) envelope_kernel(const T* __restrict__ x,
                                const T* __restrict__ env0,
                                const T* __restrict__ attack,
                                const T* __restrict__ release,
                                T* __restrict__ traj, T* __restrict__ env_final,
                                long long n, int seg, int L, int max_sweeps,
                                unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ double sA[32], sW[32];
  __shared__ T s_carry[ENV_MAX_THREADS];
  __shared__ T s_end;
  const int c = blockIdx.x, tid = threadIdx.x;
  const T* xc = x + (size_t)c * n;
  T* oc = traj + (size_t)c * n;
  const T a = attack[c], r = release[c];
  const double ad = a, rd = r;
  T carry_seg = env0[c];

  for (long long base = 0; base < n; base += seg) {
    const int len = (int)min((long long)seg, n - base);
    stage_in(xs, xc + base, len);
    __syncthreads();
    const int nchunks = (len + L - 1) / L;
    const int start = min(tid * L, len), end = min(start + L, len);
    T carry = carry_seg;
    int sweeps = 0;
    bool exact = false;
    if (nchunks > 1) {
      unsigned long long bits;
      double A, W;
      walk_bits(xs, start, end, tid == 0 ? carry_seg : T(0), a, r, bits);
      summary(xs, start, end, bits, ad, rd, A, W);
      for (;;) {
        if (sweeps == max_sweeps) {
          exact = true;
          break;
        }
        double cA = A, cW = W;
        exclusive_affine_scan(cA, cW, sA, sW);
        carry = (T)(cA * (double)carry_seg + cW);
        s_carry[tid] = carry;
        ++sweeps;
        unsigned long long new_bits;
        const T e = walk_bits(xs, start, end, carry, a, r, new_bits);
        const bool flip = new_bits != bits;
        if (flip) {
          bits = new_bits;
          summary(xs, start, end, bits, ad, rd, A, W);
        }
        __syncthreads();
        const bool gap = tid + 1 < nchunks && !meets(e, s_carry[tid + 1]);
        if (!__syncthreads_or(flip) || !__syncthreads_or(gap)) break;
      }
    }
    if (exact) {
      if (tid == 0) s_end = walk_write(xs, 0, len, carry_seg, a, r);
    } else {
      const T e = walk_write(xs, start, end, carry, a, r);
      if (start < end && end == len) s_end = e;
    }
    __syncthreads();
    for (int i = tid; i < len; i += blockDim.x) oc[base + i] = xs[i];
    carry_seg = s_end;
    if (tid == 0) {
      atomicAdd(counts + 0, 1ull);
      atomicAdd(counts + 1, (unsigned long long)sweeps);
      atomicAdd(counts + 2, exact ? 1ull : 0ull);
      atomicMax(counts + 3, (unsigned long long)sweeps);
    }
    __syncthreads();
  }
  if (tid == 0) env_final[c] = carry_seg;
}

template <typename T>
static int launch(const T* x, const T* env0, const T* attack, const T* release,
                  T* traj, T* env_final, int C, long long n, int seg, int L,
                  int threads, int max_sweeps, void* counts, void* stream) {
  const long long smem = (long long)seg * sizeof(T);
  if (C < 1 || n < 1 || seg < 1 || seg > n || L < 1 || L > 64 ||
      smem > ENV_SMEM_BYTES || threads < 32 || threads > ENV_MAX_THREADS ||
      threads % 32 || (long long)threads * L < seg || max_sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // opt in to the largest segment once per device, so that later calls
  // (and a CUDA graph capturing them) make no attribute call
  static int opted_in[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(envelope_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ENV_SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted_in[dev] = 1;
  }
  envelope_kernel<T><<<C, threads, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, env0, attack, release, traj, env_final, n, seg, L, max_sweeps,
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// -- The adjoint (A3) -----------------------------------------------------
//
// Replaces: algodsp_tpu/ops/envscan.py::_envelope_bwd (the custom-VJP
// backward of the envelope, a reverse lax.scan plus selection-split sums).
// Given the forward's inputs, its own trajectory and the cotangents G (of
// the trajectory) and g_final (of env_final), per channel:
//   env_prev_n = n ? traj[n - 1] : env0;  sel_n = x_n > env_prev_n;
//   a_n = sel_n ? attack : release;       m_n = 1 - a_n;
//   s_n = G_n + m_{n+1} s_{n+1},          s_{T-1} = G_{T-1} + g_final;
//   dx_n = a_n s_n;  denv0 = m_0 s_0;
//   datt = sum_{sel} s_n (x_n - env_prev_n);  drel = the same over !sel.
// The selection comes from the saved trajectory, so unlike the forward the
// recurrence is affine from the start: no selection fixpoint.
//
// What bounds it on the H100: the bytes. It reads x, the trajectory and G
// and writes dx, 16 bytes a float32 sample (32 in float64), against about
// nine operations a sample; at the flagship's 8 x 48128 that is ~1.8 us
// at 3.35 TB/s. A reverse walk of a channel is a chain of T dependent
// steps, which is what the design splits; and eight channels fill 8 SMs
// of 132 unless a channel is spread over several.
//
// Design (plan: ops/envscan.py::adjoint_plan). Where 2 C <= SMs a
// channel's time is split into B parts (B <= 8), one block each, run as a
// thread-block cluster; otherwise B = 1. A part is walked in segments of
// at most ENV_SMEM_BYTES: each segment's x, env_prev (the trajectory
// staged from one sample earlier, env0 in front of sample 0) and G are
// staged into shared memory by coalesced 16-byte cp.async.cg copies (each
// array shifted in shared memory to its source's alignment; the elements
// outside whole 16-byte units go one at a time), so each is read once.
// In a segment each thread owns a chunk of L samples (L odd: distinct
// banks), the threads in reverse time order (thread 0 owns the last
// chunk):
//   1. each thread composes its chunk's map carry_out = A carry_in + W
//      walking backward (float64); the block's exclusive scan of the
//      maps (the forward's exclusive_affine_scan, in thread order, so
//      over the later chunks) gives each chunk the map from the carry
//      entering the segment;
//   2. in a cluster each block first composes its whole part's map from
//      its segments' (first to last, float64), publishes it in shared
//      memory, and after one cluster barrier forms the carry entering
//      its part from g_final by the later parts' maps, read through
//      distributed shared memory in rank order from the last (time runs
//      backward: the block holding the last samples starts from
//      g_final). The segment scanned last is still staged, and its
//      chunk maps still in registers, for the walk below;
//   3. the segments are walked last to first: each chunk from its
//      entering carry in the working type, as the plain scan does,
//      writing dx = a s into G's place in shared memory (stored
//      coalesced) and adding s delta into its attack or release sum
//      (float64); the segment's first chunk's end carry enters the
//      segment before it; the chunk holding sample 0 gives denv0.
// A part that fits one segment (the flagship's: 6016 samples, 72 KB) is
// read once; a longer one re-stages all but its last segment for the
// walk. With B = 1 nothing is composed ahead: the part's carry is g_final.
// The carry is formed as s - a s (one FMA), not (1 - a) s: for a
// coefficient near 0 (a compressor's release, ~1.4e-4) 1 - a in float32
// keeps only a few bits of a, an error the scan multiplies over ~1/a
// steps (85 dB against float64 at the compressor's ballistics). The two
// sums are reduced in a fixed order: warps by xor shuffles, then thread 0
// over the warp sums in warp order, then rank 0 over the cluster's
// blocks in rank order through distributed shared memory; so a run
// repeats bit for bit.

#define ENV_ADJ_MAX_CLUSTER 8
#define ENV_VEC(T) (16 / (int)sizeof(T))

// Elements of each shared array of a segment of seg: room for its
// alignment shift, a whole number of 16-byte units.
template <typename T>
__host__ __device__ __forceinline__ long long adjoint_stride(long long seg) {
  return (seg + ENV_VEC(T) - 1) / ENV_VEC(T) * ENV_VEC(T) + ENV_VEC(T);
}

// Sum of v over the block in a fixed order; the result is valid in
// thread 0. s: 32 doubles of shared memory.
__device__ __forceinline__ double block_sum(double v, double* s) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(full, v, o);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < nwarps; ++w) t += s[w];
  return t;
}

// One element of src into shared memory by cp.async.
template <typename T>
__device__ __forceinline__ void copy_one(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
}

// Coalesced asynchronous copy of src[0, len) into shared memory at
// region + shift + lead, shift in [0, ENV_VEC) chosen so that the copy's
// destination has src's alignment modulo 16 bytes: the elements before
// src's first 16-byte boundary and after its last go one a thread, the
// rest by 16-byte cp.async.cg, one a thread and step. region is 16-byte
// aligned and holds lead + len + ENV_VEC - 1 elements. Returns
// region + shift; completes at cp.async.wait_all.
template <typename T>
__device__ __forceinline__ T* copy_async(T* region, const T* __restrict__ src,
                                         int len, int lead) {
  constexpr int V = ENV_VEC(T);
  const int h = (int)(((size_t)src / sizeof(T)) % V);
  T* dst = region + (h - lead + 2 * V) % V;
  T* d = dst + lead;
  const int head = min(len, (V - h) % V);
  const int body = (len - head) / V;
  const int tail = len - head - body * V;
  const int tid = threadIdx.x;
  if (tid < head) copy_one(d + tid, src + tid);
  const int rest = head + body * V;
  if (tid < tail) copy_one(d + rest + tid, src + rest + tid);
  for (int i = tid; i < body; i += blockDim.x) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(d + head + i * V);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + head + i * V));
  }
  return dst;
}

// x, traj, g, dx: (C, n). Block rank of a channel's B holds samples
// [rank part, (rank + 1) part), part = ceil(n / B), in segments of seg;
// each of its three shared arrays holds adjoint_stride(seg) elements.
template <typename T>
__global__ void __launch_bounds__(ENV_MAX_THREADS) envelope_adjoint_kernel(
    const T* __restrict__ x, const T* __restrict__ traj,
    const T* __restrict__ env0, const T* __restrict__ attack,
    const T* __restrict__ release, const T* __restrict__ g,
    const T* __restrict__ g_final, T* __restrict__ dx, T* __restrict__ denv0,
    T* __restrict__ datt, T* __restrict__ drel, long long n, int seg, int L,
    int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const x_region = reinterpret_cast<T*>(smem_raw);
  T* const p_region = x_region + adjoint_stride<T>(seg);
  T* const g_region = p_region + adjoint_stride<T>(seg);
  T *xs = x_region, *ps = p_region, *gs = g_region;  // x, env_prev, G then dx
  __shared__ double sA[32], sW[32], s_att[32], s_rel[32];
  __shared__ double s_seg[2];   // a segment's map
  __shared__ double s_part[2];  // the part's, read by the cluster
  __shared__ double s_sums[2];  // the block's attack and release sums
  __shared__ double s_carry;
  __shared__ T s_end;
  const int rank = blockIdx.x % B, c = blockIdx.x / B, tid = threadIdx.x;
  const size_t off = (size_t)c * n;
  const long long part = (n + B - 1) / B, pbase = rank * part;
  const long long plen = min(part, n - pbase);
  const int nseg = (int)((plen + seg - 1) / seg);
  const T a = attack[c], r = release[c];
  const double ad = a, rd = r;

  // stage segment j of the part; returns its length
  auto stage = [&](int j) -> int {
    const long long base = pbase + (long long)j * seg;
    const int len = (int)min((long long)seg, plen - (long long)j * seg);
    xs = copy_async(x_region, x + off + base, len, 0);
    gs = copy_async(g_region, g + off + base, len, 0);
    if (base == 0) {
      ps = copy_async(p_region, traj + off, len - 1, 1);
      if (tid == 0) ps[0] = env0[c];
    } else {
      ps = copy_async(p_region, traj + off + base - 1, len, 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    return len;
  };
  // this thread's chunk [start, end) of a segment of len samples, and
  // whether it is the segment's first
  int start = 0, end = 0;
  bool first = false;
  auto chunk_of = [&](int len) {
    const int nchunks = (len + L - 1) / L, chunk = nchunks - 1 - tid;
    start = chunk >= 0 ? chunk * L : 0;
    end = chunk >= 0 ? min(start + L, len) : 0;
    first = chunk == 0;
  };
  // the chunk's map, and (cA, cW) the map from the carry entering the
  // segment to the one entering the chunk; the first chunk's owner puts
  // the segment's map in s_seg
  double cA = 1.0, cW = 0.0;
  auto scan = [&]() {
    double A = 1.0, W = 0.0;
    for (int i = end - 1; i >= start; --i) {
      const double coef = xs[i] > ps[i] ? ad : rd;
      const double s = (double)gs[i] + W;
      W = s - coef * s;
      A *= 1.0 - coef;
    }
    cA = A;
    cW = W;
    exclusive_affine_scan(cA, cW, sA, sW);
    if (first) {
      s_seg[0] = A * cA;
      s_seg[1] = A * cW + W;
    }
  };

  // 1-2: in a cluster, the carry entering the part (the map of every
  // segment composed, first to last)
  double carry_in = (double)g_final[c];
  int resident = -1;
  if (B > 1) {
    double PA = 1.0, PW = 0.0;
    for (int j = 0; j < nseg; ++j) {
      if (j > 0) __syncthreads();  // the last segment's readers are done
      chunk_of(stage(j));
      scan();
      __syncthreads();
      PW = PA * s_seg[1] + PW;
      PA = PA * s_seg[0];
    }
    resident = nseg - 1;
    if (tid == 0) {
      s_part[0] = PA;
      s_part[1] = PW;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (tid == 0) {
      double v = carry_in;
      for (int q = B - 1; q > rank; --q) {
        const double* m = cluster.map_shared_rank(s_part, q);
        v = m[0] * v + m[1];
      }
      s_carry = v;
    }
    __syncthreads();
    carry_in = s_carry;
  }

  // 3: walk the segments last to first
  double sum_att = 0.0, sum_rel = 0.0;
  for (int j = nseg - 1; j >= 0; --j) {
    const long long base = pbase + (long long)j * seg;
    int len;
    if (j == resident) {
      len = (int)min((long long)seg, plen - (long long)j * seg);
    } else {
      len = stage(j);
      chunk_of(len);
      scan();
    }
    T carry = (T)(cA * carry_in + cW);
    for (int i = end - 1; i >= start; --i) {
      const T xv = xs[i], ep = ps[i];
      const bool up = xv > ep;
      const T coef = up ? a : r;
      const T s = gs[i] + carry;
      gs[i] = coef * s;
      const double sd = (double)(s * (xv - ep));
      if (up)
        sum_att += sd;
      else
        sum_rel += sd;
      carry = s - coef * s;
    }
    if (first) s_end = carry;
    __syncthreads();
    for (int i = tid; i < len; i += blockDim.x) dx[off + base + i] = gs[i];
    carry_in = (double)s_end;
    __syncthreads();
  }
  sum_att = block_sum(sum_att, s_att);
  sum_rel = block_sum(sum_rel, s_rel);
  if (B == 1) {
    if (tid == 0) {
      datt[c] = (T)sum_att;
      drel[c] = (T)sum_rel;
      denv0[c] = s_end;
    }
    return;
  }
  if (tid == 0) {
    s_sums[0] = sum_att;
    s_sums[1] = sum_rel;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0 && tid == 0) {
    double ta = 0.0, tr = 0.0;
    for (int q = 0; q < B; ++q) {
      const double* s = cluster.map_shared_rank(s_sums, q);
      ta += s[0];
      tr += s[1];
    }
    datt[c] = (T)ta;
    drel[c] = (T)tr;
    denv0[c] = s_end;
  }
  // no block leaves while rank 0 reads its shared memory
  cluster.sync();
}

template <typename T>
static int launch_adjoint(const T* x, const T* traj, const T* env0,
                          const T* attack, const T* release, const T* g,
                          const T* g_final, T* dx, T* denv0, T* datt, T* drel,
                          int C, long long n, int seg, int L, int threads,
                          int B, void* stream) {
  const long long smem = 3ll * adjoint_stride<T>(seg) * (long long)sizeof(T);
  if (C < 1 || n < 1 || B < 1 || B > ENV_ADJ_MAX_CLUSTER ||
      (long long)C * B > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long part = (n + B - 1) / B;
  if ((long long)(B - 1) * part >= n || seg < 1 || seg > part || L < 1 ||
      smem > ENV_SMEM_BYTES || threads < 32 ||
      threads > ENV_MAX_THREADS || threads % 32 ||
      (long long)threads * L < seg)
    return static_cast<int>(cudaErrorInvalidValue);
  // opt in to the largest segment once per device, so that later calls
  // (and a CUDA graph capturing them) make no attribute call
  static int opted_in[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(envelope_adjoint_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ENV_SMEM_BYTES);
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
  err = cudaLaunchKernelEx(&cfg, envelope_adjoint_kernel<T>, x, traj, env0,
                           attack, release, g, g_final, dx, denv0, datt, drel,
                           n, seg, L, B);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, traj: (C, n); env0, attack, release, env_final: (C,); counts: four
// uint64 on the device, added to. seg, L and threads come from
// ops/envscan.py::chunk_plan. Returns cudaGetLastError() after the launch.
int envelope_scan_f32(const float* x, const float* env0, const float* attack,
                      const float* release, float* traj, float* env_final,
                      int C, long long n, int seg, int L, int threads,
                      int max_sweeps, void* counts, void* stream) {
  return launch<float>(x, env0, attack, release, traj, env_final, C, n, seg, L,
                       threads, max_sweeps, counts, stream);
}

int envelope_scan_f64(const double* x, const double* env0,
                      const double* attack, const double* release,
                      double* traj, double* env_final, int C, long long n,
                      int seg, int L, int threads, int max_sweeps,
                      void* counts, void* stream) {
  return launch<double>(x, env0, attack, release, traj, env_final, C, n, seg,
                        L, threads, max_sweeps, counts, stream);
}

// x, traj, g, dx: (C, n); env0, attack, release, g_final, denv0, datt,
// drel: (C,). seg, L, threads and the cluster size B come from
// ops/envscan.py::adjoint_plan. Returns cudaGetLastError() after the
// launch.
int envelope_adjoint_f32(const float* x, const float* traj, const float* env0,
                         const float* attack, const float* release,
                         const float* g, const float* g_final, float* dx,
                         float* denv0, float* datt, float* drel, int C,
                         long long n, int seg, int L, int threads, int B,
                         void* stream) {
  return launch_adjoint<float>(x, traj, env0, attack, release, g, g_final, dx,
                               denv0, datt, drel, C, n, seg, L, threads, B,
                               stream);
}

int envelope_adjoint_f64(const double* x, const double* traj,
                         const double* env0, const double* attack,
                         const double* release, const double* g,
                         const double* g_final, double* dx, double* denv0,
                         double* datt, double* drel, int C, long long n,
                         int seg, int L, int threads, int B, void* stream) {
  return launch_adjoint<double>(x, traj, env0, attack, release, g, g_final, dx,
                                denv0, datt, drel, C, n, seg, L, threads, B,
                                stream);
}

}  // extern "C"
