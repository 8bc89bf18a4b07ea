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

#include <cuda_runtime.h>

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

}  // extern "C"
