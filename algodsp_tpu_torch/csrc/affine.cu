// M2 and M3: the time-varying affine scans of the modulation effects for
// Hopper (sm_90a), as chunked scans over time.
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
// What bounds them: the bytes (the matrices and offsets read once, the
// states written once) take a few microseconds at the main path's
// shapes; a walk in order is held to N dependent steps (0.34 ms for the
// AutoWah's 48128), so both cut time into chunks of L steps and scan
// the chunks' maps, as K3 (csrc/biquad_cascade.cu) does for a
// time-invariant section. Same function as the reference's tree, summed
// in another order; products and sums may fuse (held to the plain
// versions by SNR, not bit for bit). Deterministic: every sum is taken
// in one fixed order, so two calls on the same input are bit-equal.
//
// The schedule, one pass of a block over a tile of its channel's time
// (ops/linrec.py::m3_plan and ::m2_plan pick L, the threads, the tile
// and the cluster; tests/test_torch_modulation_walks.py models both in
// numpy):
//   stage: the tile's A and w go to shared memory by 16-byte cp.async
//          (head and tail by element), coalesced; no step waits on
//          device memory;
//   local: each chunk of L steps composes its map s -> M s + b from
//          zero state (M = A_end ... A_start, b the chunk's end state);
//   carry: the chunk maps are scanned into every chunk's entering state;
//          the blocks of a channel (a cluster of B <= 8 along time)
//          publish their tile's map and, after one cluster barrier, each
//          copies the earlier ones through distributed shared memory and
//          folds them in rank order from the pass's entering state (every
//          block folds all B, so all agree on the next pass's entering
//          state bit for bit);
//   walk:  each chunk walks again from its true entering state, writing
//          the states in place over w in shared memory, then the tile
//          goes out coalesced. Every stored state is the recurrence's own
//          output from a state correct to rounding, so nothing cancels.
//
// M3 (affine2_chunked): one channel a block (A is per channel, so
// nothing is shared across channels), a thread a chunk of L = 15 steps
// (odd, so the threads' strided 16-byte and 8-byte shared loads fall on
// distinct banks), up to 512 threads; the chunk maps (six values) are
// scanned by warp shuffles, then warp 0 over the warp totals (K3's
// scheme, with maps composed from A instead of a host table of powers).
// At the AutoWah's 8 x 48128 a cluster of 8 blocks takes a channel, 416
// threads a block and one pass (64 blocks); at 64 x 512 and at
// 128 x 2^16 one block a channel (the latter in 9 passes of 7680 steps).
// Chosen on the H100 (graph replay, 8 x 48128 float32): L = 15 0.0121
// ms, against 0.0161 / 0.0176 / 0.0129 / 0.0129 for L = 7 / 11 / 23 /
// 31. There it takes 30% of its byte bound's time and ten times its
// critical path: what is left is staging and the block's barriers.
//
// M2 (affine_nd_chunked<T, D>, d a template parameter dispatched for
// 1..32 so that the row loops unroll): a block takes G <= 8 channels and
// a tile of K chunks of L = 5 steps, a thread a (channel, chunk) pair
// (channel fastest) holding its d-vector in registers. A's tile is staged
// once a block and read by every channel there (broadcast loads). The
// chunk composites P_k = A_end ... A_start do not depend on the channel:
// a warp a chunk forms them once for the block's channels, lane j holding
// column j. The carry: warp 0 forms the prefix products Q_k = P_{k-1} ...
// P_0 (Q_K the tile's map) while one thread a channel carries the
// zero-state chunk ends e0_k in order; a chunk enters at e0_k + Q_k s
// once the tile's entering state s is known. At the mod chain's 64 x 511
// (d = 7): 8 channels a block, a cluster of 8 blocks along time, 13
// chunks a block (64 blocks of 128 threads, one pass). Chosen on the
// H100 (graph replay, that block, float32): L = 5 0.0169 ms, against
// 0.0174 / 0.0195 / 0.0219 for L = 3 / 7 / 9.
//
// The adjoint (ROADMAP section 2): g_{n-1} = A_n^T g_n + dL/ds_{n-1} is
// the same scan run backward in time on the transposed matrices: the
// chunk maps become M^T composed from the chunk's end, the carry runs
// from the last rank and the last chunk down, and the walk goes from
// each chunk's end to its start.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 8;
constexpr int kSmemBytes = 225280;  // 220 KB opt-in dynamic shared memory
constexpr int kM3MaxThreads = 512;
constexpr int kM2MaxThreads = 256;
constexpr int kM2MaxGroup = 8;

// ---------------------------------------------------------------------------
// Staging: asynchronous copies into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Elements of T in 16 bytes.
template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / static_cast<int>(sizeof(T));
}

// Where `stage` puts src in a region of shared memory (16-byte aligned,
// with 16 bytes of slack): at the offset that gives it src's alignment
// modulo 16 bytes, so that the body copies in 16-byte pieces.
template <typename T>
__device__ __forceinline__ T* staged_at(T* region, const T* src) {
  return region +
         (reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T);
}

// Copy src[0, count) into shared memory at staged_at(region, src) by
// cp.async, all threads of the block taking part; cp_wait_all and a
// barrier make it visible.
template <typename T>
__device__ __forceinline__ void stage(T* region, const T* src, int count) {
  constexpr int V = vec<T>();
  T* dst = staged_at(region, src);
  const int shift = static_cast<int>(dst - region);
  const int head = min((V - shift) % V, count);
  const int body = (count - head) / V;
  const int tail0 = head + body * V;
  const int nt = blockDim.x;
  for (int i = threadIdx.x; i < head; i += nt)
    cp_async<static_cast<int>(sizeof(T))>(dst + i, src + i);
  for (int i = threadIdx.x; i < body; i += nt)
    cp_async<16>(dst + head + i * V, src + head + i * V);
  for (int i = tail0 + threadIdx.x; i < count; i += nt)
    cp_async<static_cast<int>(sizeof(T))>(dst + i, src + i);
}

// count rounded up to whole 16-byte pieces
template <typename T>
__host__ __device__ constexpr long long round_vec(long long count) {
  return (count + vec<T>() - 1) / vec<T>() * vec<T>();
}

// Elements (T) of a staging region for count elements: rounded up to
// 16 bytes, plus 16 bytes of slack.
template <typename T>
__host__ __device__ constexpr long long region_len(long long count) {
  return round_vec<T>(count) + vec<T>();
}

// ---------------------------------------------------------------------------
// M3: 2 x 2 maps a thread, scanned by shuffles
// ---------------------------------------------------------------------------

// s -> M s + b, M packed [m00, m01, m10, m11].
template <typename T>
struct Map2 {
  T m0, m1, m2, m3, b0, b1;
};

template <typename T>
__device__ __forceinline__ Map2<T> identity2() {
  return {T(1), T(0), T(0), T(1), T(0), T(0)};
}

// later after earlier: s -> l.M (e.M s + e.b) + l.b
template <typename T>
__device__ __forceinline__ Map2<T> compose(const Map2<T>& l,
                                           const Map2<T>& e) {
  return {l.m0 * e.m0 + l.m1 * e.m2, l.m0 * e.m1 + l.m1 * e.m3,
          l.m2 * e.m0 + l.m3 * e.m2, l.m2 * e.m1 + l.m3 * e.m3,
          l.m0 * e.b0 + l.m1 * e.b1 + l.b0, l.m2 * e.b0 + l.m3 * e.b1 + l.b1};
}

template <typename T>
__device__ __forceinline__ void apply(const Map2<T>& m, T& x0, T& x1) {
  const T n0 = m.m0 * x0 + m.m1 * x1 + m.b0;
  const T n1 = m.m2 * x0 + m.m3 * x1 + m.b1;
  x0 = n0;
  x1 = n1;
}

template <typename T>
__device__ __forceinline__ Map2<T> shfl_up(const Map2<T>& m, int o) {
  return {__shfl_up_sync(kFull, m.m0, o), __shfl_up_sync(kFull, m.m1, o),
          __shfl_up_sync(kFull, m.m2, o), __shfl_up_sync(kFull, m.m3, o),
          __shfl_up_sync(kFull, m.b0, o), __shfl_up_sync(kFull, m.b1, o)};
}

// A step's matrix and offset from shared memory, widened to double
// (16-byte and 8- or 16-byte loads; the wrapper hands 16-byte aligned
// tensors, so the staged tiles are aligned for them).
__device__ __forceinline__ void load_step(const float* a, const float* w,
                                          int i, double (&m)[4], double& w0,
                                          double& w1) {
  const float4 av = reinterpret_cast<const float4*>(a)[i];
  const float2 wv = reinterpret_cast<const float2*>(w)[i];
  m[0] = av.x; m[1] = av.y; m[2] = av.z; m[3] = av.w;
  w0 = wv.x;
  w1 = wv.y;
}

__device__ __forceinline__ void load_step(const double* a, const double* w,
                                          int i, double (&m)[4], double& w0,
                                          double& w1) {
  const double2 a01 = reinterpret_cast<const double2*>(a)[2 * i];
  const double2 a23 = reinterpret_cast<const double2*>(a)[2 * i + 1];
  const double2 wv = reinterpret_cast<const double2*>(w)[i];
  m[0] = a01.x; m[1] = a01.y; m[2] = a23.x; m[3] = a23.y;
  w0 = wv.x;
  w1 = wv.y;
}

// Grid: C x B blocks (a cluster of B along time); each pass p, block
// `rank` takes steps [(p B + rank) tile, + tile) of its channel, one
// chunk of L steps a thread (tile = threads x L). Dynamic shared memory:
// the tile's A and w (entry written over w). The maps, their scan and
// the walk run in double for either type: the AutoWah's resonant DF2T
// amplifies a product of its matrices tens of times over the state it
// maps to, so a float32 map loses to cancellation what a float32 walk
// keeps (86 dB against float64 where the walk reads 111, in the numpy
// model); in double the stored states round once, from float64 sums.
template <typename T>
__global__ void __launch_bounds__(kM3MaxThreads) affine2_chunked(
    const T* __restrict__ A, const T* __restrict__ w, const T* __restrict__ s0,
    T* __restrict__ entry, T* __restrict__ fin, long long N, int L, int tile,
    int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Map2<double> s_tot[kM3MaxThreads / kWarp];
  __shared__ Map2<double> s_slot[2];  // this tile's map, by the pass's parity
  __shared__ double s_pass[2];        // the pass's entering state
  __shared__ double s_tile[2];        // this tile's entering state
  T* regA = reinterpret_cast<T*>(smem_raw);
  T* regW = regA + region_len<T>(4LL * tile);
  const int rank = static_cast<int>(blockIdx.x % B);
  const long long c = blockIdx.x / B;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const T* Ac = A + c * N * 4;
  const T* wc = w + c * N * 2;
  T* ec = entry + c * N * 2;
  if (tid == 0) {
    s_pass[0] = s0[2 * c];
    s_pass[1] = s0[2 * c + 1];
  }
  const long long span = static_cast<long long>(B) * tile;
  int parity = 0;
  for (long long pbase = 0; pbase < N; pbase += span, parity ^= 1) {
    const long long base = pbase + static_cast<long long>(rank) * tile;
    const int len = static_cast<int>(max(0LL, min(static_cast<long long>(tile), N - base)));
    const T* gA = Ac + 4 * min(base, N - 1);
    const T* gW = wc + 2 * min(base, N - 1);
    if (len > 0) {
      stage(regA, gA, 4 * len);
      stage(regW, gW, 2 * len);
    }
    cp_wait_all();
    __syncthreads();
    const T* sA = staged_at(regA, gA);
    T* sW = staged_at(regW, gW);
    const int start = min(tid * L, len), end = min(start + L, len);

    // local: the chunk's map from zero state
    Map2<double> m = identity2<double>();
    for (int i = start; i < end; ++i) {
      double a[4], w0, w1;
      load_step(sA, sW, i, a, w0, w1);
      m = compose<double>({a[0], a[1], a[2], a[3], w0, w1}, m);
    }

    // carry: inclusive scan over the lanes, then over the warps
    Map2<double> incl = m;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const Map2<double> u = shfl_up(incl, o);
      if (lane >= o) incl = compose(incl, u);
    }
    if (lane == kWarp - 1) s_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      Map2<double> t = lane < nwarps ? s_tot[lane] : identity2<double>();
#pragma unroll
      for (int o = 1; o < kM3MaxThreads / kWarp; o <<= 1) {
        const Map2<double> u = shfl_up(t, o);
        if (lane >= o) t = compose(t, u);
      }
      if (lane < nwarps) s_tot[lane] = t;
    }
    __syncthreads();
    const bool last_pass = pbase + span >= N;
    if (B > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      if (tid == 0) s_slot[parity] = s_tot[nwarps - 1];
      cluster.sync();
      if (tid == 0) {
        double x0 = s_pass[0], x1 = s_pass[1];
        for (int j = 0; j < B; ++j) {
          if (j == rank) {
            s_tile[0] = x0;
            s_tile[1] = x1;
          }
          const Map2<double> mj = *cluster.map_shared_rank(&s_slot[parity], j);
          apply(mj, x0, x1);
        }
        s_pass[0] = x0;
        s_pass[1] = x1;
      }
      // after the last reads of other blocks' shared memory: no block of
      // the cluster exits before they are done (the wait at the end)
      if (last_pass)
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    } else if (tid == 0) {
      double x0 = s_pass[0], x1 = s_pass[1];
      s_tile[0] = x0;
      s_tile[1] = x1;
      apply(s_tot[nwarps - 1], x0, x1);
      s_pass[0] = x0;
      s_pass[1] = x1;
    }
    __syncthreads();

    // this chunk's entering state: the earlier warps', then the earlier
    // lanes' maps applied to the tile's
    double x0 = s_tile[0], x1 = s_tile[1];
    if (warp > 0) apply(s_tot[warp - 1], x0, x1);
    const Map2<double> before = shfl_up(incl, 1);
    if (lane > 0) apply(before, x0, x1);

    // walk: the states before each step, written over w
    for (int i = start; i < end; ++i) {
      double a[4], w0, w1;
      load_step(sA, sW, i, a, w0, w1);
      sW[2 * i] = static_cast<T>(x0);
      sW[2 * i + 1] = static_cast<T>(x1);
      const double n0 = a[0] * x0 + a[1] * x1 + w0;
      const double n1 = a[2] * x0 + a[3] * x1 + w1;
      x0 = n0;
      x1 = n1;
    }
    if (start < end && end == len && base + len == N) {
      fin[2 * c] = static_cast<T>(x0);
      fin[2 * c + 1] = static_cast<T>(x1);
    }
    __syncthreads();
    T* gE = ec + 2 * base;
    for (int i = tid; i < 2 * len; i += blockDim.x) gE[i] = sW[i];
    __syncthreads();
  }
  if (B > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// M2: d-vectors a thread, composites a warp
// ---------------------------------------------------------------------------

// Shared-memory layout of affine_nd_chunked, in elements of T (each
// region starts 16-byte aligned): A's tile, the G channels' w tiles, P
// (K composites), Q (K + 1 prefix products), the chunk ends (G x K x d),
// the pass's and the tile's entering states (G x d each), the tile's
// map by parity (2 x (d^2 + G d)) and, in a cluster, the B ranks' maps
// copied (B x (d^2 + G d)). ops/linrec.py::m2_smem_bytes mirrors it.
struct NdLayout {
  long long a, w, wstride, p, q, e, pass, tile, slot, xch, total;
};

template <typename T>
__host__ __device__ NdLayout nd_layout(int d, int G, int K, int L, int B) {
  const long long dd = static_cast<long long>(d) * d, tile = 1LL * K * L;
  const long long sl = dd + 1LL * G * d;
  NdLayout o{};
  o.a = 0;
  o.w = o.a + region_len<T>(tile * dd);
  o.wstride = region_len<T>(tile * d);
  o.p = o.w + G * o.wstride;
  o.q = o.p + round_vec<T>(K * dd);
  o.e = o.q + round_vec<T>((K + 1) * dd);
  o.pass = o.e + round_vec<T>(1LL * G * K * d);
  o.tile = o.pass + round_vec<T>(1LL * G * d);
  o.slot = o.tile + round_vec<T>(1LL * G * d);
  o.xch = o.slot + 2 * round_vec<T>(sl);
  o.total = o.xch + (B > 1 ? B * round_vec<T>(sl) : 0);
  return o;
}

// x <- M_s x + b_s for s = 0..count-1, with M_s = M + s mstep (d x d,
// row-major) and b_s = b + s bstep; after step s the state also goes to
// out + s ostep + i oelem where out is not null. Every d x d product of
// affine_nd_chunked runs here.
template <typename T, int D>
__device__ __forceinline__ void steps_body(const T* M, long long mstep,
                                           const T* b, long long bstep,
                                           int count, T* x, T* out,
                                           long long ostep, long long oelem) {
  T v[D];
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] = x[i];
  for (int s = 0; s < count; ++s) {
    const T* Ms = M + s * mstep;
    const T* bs = b + s * bstep;
    T y[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T acc = bs[i];
#pragma unroll
      for (int m = 0; m < D; ++m) acc += Ms[i * D + m] * v[m];
      y[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = y[i];
    if (out) {
#pragma unroll
      for (int i = 0; i < D; ++i) out[s * ostep + i * oelem] = v[i];
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = v[i];
}

template <typename T, int D>
__device__ __noinline__ void steps_call(const T* M, long long mstep,
                                        const T* b, long long bstep, int count,
                                        T* x, T* out, long long ostep,
                                        long long oelem) {
  steps_body<T, D>(M, mstep, b, bstep, count, x, out, ostep, oelem);
}

// The kernel's seven call sites inline the fully unrolled d x d product
// up to d = kInlineD (the Phaser's d = stages + 1 <= 13); above it they
// call one copy a (T, D). With the 64 instances' products inlined at
// every site nvcc took 385 s, with none inlined 86 s, and calling the
// one copy made the mod chain's d = 7 block 2.6x slower (0.0552 against
// 0.0215 ms on the H100); at d = 16 and 17 the two read alike (0.0681
// and 0.0672 ms at 64 x 511).
constexpr int kInlineD = 13;

template <typename T, int D>
__device__ __forceinline__ void steps(const T* M, long long mstep, const T* b,
                                      long long bstep, int count, T* x, T* out,
                                      long long ostep, long long oelem) {
  if constexpr (D <= kInlineD)
    steps_body<T, D>(M, mstep, b, bstep, count, x, out, ostep, oelem);
  else
    steps_call<T, D>(M, mstep, b, bstep, count, x, out, ostep, oelem);
}

// Grid: ceil(C / G) x B blocks (a cluster of B along time); each pass p,
// block `rank` takes steps [(p B + rank) tile, + tile) of its G channels,
// tile = K x L; thread t is channel t % G of chunk t / G.
template <typename T, int D>
__global__ void __launch_bounds__(kM2MaxThreads) affine_nd_chunked(
    const T* __restrict__ A, const T* __restrict__ w, const T* __restrict__ s0,
    T* __restrict__ after, T* __restrict__ fin, int C, long long N, int G,
    int K, int L, int B) {
  constexpr int DD = D * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const NdLayout o = nd_layout<T>(D, G, K, L, B);
  T* regA = sm + o.a;
  T* sP = sm + o.p;
  T* sQ = sm + o.q;
  T* sE = sm + o.e;
  T* sPass = sm + o.pass;
  T* sTile = sm + o.tile;
  const long long sl = DD + 1LL * G * D;
  const long long slr = round_vec<T>(sl);
  const int tile = K * L;
  const int rank = static_cast<int>(blockIdx.x % B);
  const int c0 = static_cast<int>(blockIdx.x / B) * G;
  const int g = min(G, C - c0);
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int nt = blockDim.x, nwarps = nt / kWarp;
  const int cl = tid % G, k = tid / G;
  const bool worker = k < K && cl < g;
  T zero[D];
#pragma unroll
  for (int i = 0; i < D; ++i) zero[i] = T(0);
  for (int i = tid; i < g * D; i += nt)
    sPass[i] = s0[static_cast<long long>(c0) * D + i];
  const long long span = static_cast<long long>(B) * tile;
  int parity = 0;
  for (long long pbase = 0; pbase < N; pbase += span, parity ^= 1) {
    const long long base = pbase + static_cast<long long>(rank) * tile;
    const int len = static_cast<int>(max(0LL, min(static_cast<long long>(tile), N - base)));
    const long long at = min(base, N - 1);
    const T* gA = A + at * DD;
    auto gw = [&](int j) {
      return w + (static_cast<long long>(c0 + j) * N + at) * D;
    };
    if (len > 0) {
      stage(regA, gA, len * DD);
      for (int j = 0; j < g; ++j) stage(sm + o.w + j * o.wstride, gw(j), len * D);
    }
    cp_wait_all();
    __syncthreads();
    const T* sA = staged_at(regA, gA);

    // local: the chunk composites, a warp a chunk, lane j column j
    for (int kk = warp; kk < K; kk += nwarps) {
      const int start = min(kk * L, len), end = min(start + L, len);
      T col[D];
#pragma unroll
      for (int i = 0; i < D; ++i) col[i] = T(i == lane ? 1 : 0);
      steps<T, D>(sA + start * DD, DD, zero, 0, end - start, col, nullptr, 0, 0);
      if (lane < D) {
#pragma unroll
        for (int i = 0; i < D; ++i) sP[kk * DD + i * D + lane] = col[i];
      }
    }
    // local: each (channel, chunk)'s end state from zero state
    if (worker) {
      const int start = min(k * L, len), end = min(start + L, len);
      const T* sw = staged_at(sm + o.w + cl * o.wstride, gw(cl));
      T x[D];
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = T(0);
      steps<T, D>(sA + start * DD, DD, sw + start * D, D, end - start, x,
                  nullptr, 0, 0);
#pragma unroll
      for (int i = 0; i < D; ++i) sE[(cl * K + k) * D + i] = x[i];
    }
    __syncthreads();

    // carry: warp 0 the prefix products Q_k (Q_K the tile's map, also
    // published), one thread a channel the zero-state chunk entries e0_k
    // (the tile's zero-state end published)
    T* slot = sm + o.slot + parity * slr;
    if (warp == 0) {
      T col[D];
#pragma unroll
      for (int i = 0; i < D; ++i) col[i] = T(i == lane ? 1 : 0);
      if (lane < D) {
#pragma unroll
        for (int i = 0; i < D; ++i) sQ[i * D + lane] = col[i];
      }
      steps<T, D>(sP, DD, zero, 0, K, col, lane < D ? sQ + DD + lane : nullptr,
                  DD, D);
      if (lane < D) {
#pragma unroll
        for (int i = 0; i < D; ++i) slot[i * D + lane] = col[i];
      }
    }
    const int carry0 = nwarps > 1 ? kWarp : 0;
    if (tid >= carry0 && tid < carry0 + g) {
      const int j = tid - carry0;
      T x[D];
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = T(0);
      for (int kk = 0; kk < K; ++kk) {
        T* e = sE + (j * K + kk) * D;
        T b[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          b[i] = e[i];
          e[i] = x[i];
        }
        steps<T, D>(sP + kk * DD, 0, b, 0, 1, x, nullptr, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) slot[DD + j * D + i] = x[i];
    }
    __syncthreads();

    // the tile's entering state: the earlier ranks' maps folded in order
    // from the pass's entering state (every rank folds all of them, for
    // the next pass's)
    const bool last_pass = pbase + span >= N;
    const T* maps = slot;
    long long mstride = 0;
    if (B > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      T* xch = sm + o.xch;
      for (long long i = tid; i < B * sl; i += nt) {
        const int r = static_cast<int>(i / sl);
        const long long off = i % sl;
        xch[r * slr + off] = cluster.map_shared_rank(slot, r)[off];
      }
      __syncthreads();
      if (last_pass)
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      maps = xch;
      mstride = slr;
    }
    if (tid < g) {
      T x[D];
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = sPass[tid * D + i];
      for (int r = 0; r < B; ++r) {
        if (r == rank) {
#pragma unroll
          for (int i = 0; i < D; ++i) sTile[tid * D + i] = x[i];
        }
        const T* mr = maps + r * mstride;
        steps<T, D>(mr, 0, mr + DD + tid * D, 0, 1, x, nullptr, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) sPass[tid * D + i] = x[i];
    }
    __syncthreads();

    // walk: from e0_k + Q_k s, the states after each step over w
    if (worker) {
      const int start = min(k * L, len), end = min(start + L, len);
      T* sw = staged_at(sm + o.w + cl * o.wstride, gw(cl));
      T x[D];
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = sTile[cl * D + i];
      steps<T, D>(sQ + k * DD, 0, sE + (cl * K + k) * D, 0, 1, x, nullptr, 0,
                  0);
      steps<T, D>(sA + start * DD, DD, sw + start * D, D, end - start, x,
                  sw + start * D, D, 1);
      if (start < end && end == len && base + len == N) {
#pragma unroll
        for (int i = 0; i < D; ++i) fin[static_cast<long long>(c0 + cl) * D + i] = x[i];
      }
    }
    __syncthreads();
    for (int j = 0; j < g; ++j) {
      const T* sw = staged_at(sm + o.w + j * o.wstride, gw(j));
      T* ga = after + (static_cast<long long>(c0 + j) * N + base) * D;
      for (int i = tid; i < len * D; i += nt) ga[i] = sw[i];
    }
    __syncthreads();
  }
  if (B > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename K>
static int opt_in(K* kernel, int* done) {
  // once per device and kernel, so that later calls (and a CUDA graph
  // capturing them) make no attribute call
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) done[dev] = 1;
  }
  return 0;
}

template <typename K, typename... Args>
static int launch(K* kernel, int blocks, int threads, long long smem, int B,
                  void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(B);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = B > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int two_launch(const T* A, const T* w, const T* s0, T* entry, T* fin, int C,
               long long N, int L, int threads, int B, void* stream) {
  const long long tile = 1LL * threads * L;
  const long long smem =
      (region_len<T>(4 * tile) + region_len<T>(2 * tile)) * sizeof(T);
  if (C < 1 || N < 1 || L < 1 || threads < kWarp || threads > kM3MaxThreads ||
      threads % kWarp || B < 1 || B > kMaxCluster || smem > kSmemBytes ||
      !aligned16(A) || !aligned16(w) || !aligned16(entry))
    return static_cast<int>(cudaErrorInvalidValue);
  static int done[64] = {0};
  const int err = opt_in(affine2_chunked<T>, done);
  if (err) return err;
  return launch(affine2_chunked<T>, C * B, threads, smem, B, stream, A, w, s0,
                entry, fin, N, L, static_cast<int>(tile), B);
}

template <typename T, int D>
int nd_launch_d(const T* A, const T* w, const T* s0, T* after, T* fin, int C,
                long long N, int G, int K, int L, int threads, int B,
                void* stream) {
  const long long smem = nd_layout<T>(D, G, K, L, B).total * sizeof(T);
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  static int done[64] = {0};
  const int err = opt_in(affine_nd_chunked<T, D>, done);
  if (err) return err;
  return launch(affine_nd_chunked<T, D>, (C + G - 1) / G * B, threads, smem, B,
                stream, A, w, s0, after, fin, C, N, G, K, L, B);
}

template <typename T, int D>
int nd_launch_upto(int d, const T* A, const T* w, const T* s0, T* after,
                   T* fin, int C, long long N, int G, int K, int L,
                   int threads, int B, void* stream) {
  if constexpr (D > 1) {
    if (d < D)
      return nd_launch_upto<T, D - 1>(d, A, w, s0, after, fin, C, N, G, K, L,
                                      threads, B, stream);
  }
  return nd_launch_d<T, D>(A, w, s0, after, fin, C, N, G, K, L, threads, B,
                           stream);
}

template <typename T>
int nd_launch(const T* A, const T* w, const T* s0, T* after, T* fin, int C,
              long long N, int d, int G, int K, int L, int threads, int B,
              void* stream) {
  if (C < 1 || N < 1 || d < 1 || d > kWarp || G < 1 || G > kM2MaxGroup ||
      K < 1 || L < 1 || threads < kWarp || threads > kM2MaxThreads ||
      threads % kWarp || 1LL * G * K > threads || B < 1 || B > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  return nd_launch_upto<T, kWarp>(d, A, w, s0, after, fin, C, N, G, K, L,
                                  threads, B, stream);
}

// ---------------------------------------------------------------------------
// Latency probes, for the critical paths printed beside the times
// ---------------------------------------------------------------------------

// kind 2: the walk in order's dependent step of M2 (one warp, lane i row
// i of A_n in registers, d shuffles; the earlier design's chain bound).
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

// kind 6: M2's step in the chunked design: n steps of one thread's
// d-vector through `steps` (x <- A x + w, A and w read from shared
// memory each step), the kernel's own code.
template <typename T, int D>
__global__ void nd_step_latency_kernel(long long n, long long* cycles,
                                       T* sink) {
  __shared__ T a[D * D + D];
  for (int i = threadIdx.x; i < D * D + D; i += blockDim.x)
    a[i] = T(0.9) / T(D * (i % D + 1) + i / D + 2);
  __syncthreads();
  T x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = sink[i % 32];
  const long long t0 = clock64();
  steps<T, D>(a, 0, a + D * D, 0, static_cast<int>(n), x, nullptr, 0, 0);
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < D; ++i) acc += x[i];
    sink[0] = acc;
  }
}

template <typename T, int D>
void nd_latency_upto(int kind, int d, long long n, long long* cycles, T* sink,
                     cudaStream_t st) {
  if constexpr (D > 1) {
    if (d < D) return nd_latency_upto<T, D - 1>(kind, d, n, cycles, sink, st);
  }
  if (kind == 2)
    nd_latency_kernel<T, D><<<1, kWarp, 0, st>>>(n, cycles, sink);
  else
    nd_step_latency_kernel<T, D><<<1, 1, 0, st>>>(n, cycles, sink);
}

// kind 3: the walk's step of M3 in T (one thread, coefficients in
// registers; the earlier design's chain bound, and with T = double the
// chunked walk's step); kind 4: M3's local step (the chunk map composed
// with a step in double, A and w from shared memory); kind 5: one level
// of M3's shuffle scan (six double shuffles and a composition).
template <typename T>
__global__ void two_latency_kernel(int kind, long long n, long long* cycles,
                                   T* sink) {
  __shared__ T a[12];
  for (int i = threadIdx.x; i < 12; i += blockDim.x) a[i] = sink[2 + i % 6];
  __syncthreads();
  // the coefficients come from memory, so that none folds away
  const T a0 = sink[2], a1 = sink[3], a2 = sink[4], a3 = sink[5], w0 = sink[6],
          w1 = sink[7];
  T s0v = sink[0], s1v = sink[1];
  Map2<double> m = identity2<double>();
  long long t0 = 0, t1 = 0;
  if (kind == 3) {
    t0 = clock64();
    for (long long i = 0; i < n; ++i) {
      const T n0 = a0 * s0v + a1 * s1v + w0;
      const T n1 = a2 * s0v + a3 * s1v + w1;
      s0v = n0;
      s1v = n1;
    }
    t1 = clock64();
  } else if (kind == 4) {
    t0 = clock64();
    for (long long i = 0; i < n; ++i) {
      const T* p = a + 6 * (i & 1);
      m = compose<double>({p[0], p[1], p[2], p[3], p[4], p[5]}, m);
    }
    t1 = clock64();
  } else {
    m = {a0, a1, a2, a3, w0, w1};
    t0 = clock64();
    for (long long i = 0; i < n; ++i) {
      const Map2<double> u = shfl_up(m, 1);
      if (threadIdx.x >= 1) m = compose(m, u);
    }
    t1 = clock64();
  }
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    sink[0] = static_cast<T>(s0v + m.m0 + m.b0);
    sink[1] = static_cast<T>(s1v + m.m3 + m.b1);
  }
}

template <typename T>
int latency(int kind, long long n, int d, long long* cycles, void* sink,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 2 || kind == 6)
    nd_latency_upto<T, kWarp>(kind, d, n, cycles, static_cast<T*>(sink), st);
  else
    two_latency_kernel<T><<<1, kind == 5 ? kWarp : 1, 0, st>>>(
        kind, n, cycles, static_cast<T*>(sink));
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A (N, d, d); w, after (C, N, d); s0, fin (C, d); 1 <= d <= 32; G, K, L,
// threads, B from ops/linrec.py::m2_plan. Returns cudaGetLastError()
// after the launch.
int affine_scan_nd_f32(const float* A, const float* w, const float* s0,
                       float* after, float* fin, int C, long long N, int d,
                       int G, int K, int L, int threads, int B, void* stream) {
  return nd_launch<float>(A, w, s0, after, fin, C, N, d, G, K, L, threads, B,
                          stream);
}

int affine_scan_nd_f64(const double* A, const double* w, const double* s0,
                       double* after, double* fin, int C, long long N, int d,
                       int G, int K, int L, int threads, int B, void* stream) {
  return nd_launch<double>(A, w, s0, after, fin, C, N, d, G, K, L, threads, B,
                           stream);
}

// A (C, N, 4); w, entry (C, N, 2); s0, fin (C, 2); A, w and entry 16-byte
// aligned; L, threads, B from ops/linrec.py::m3_plan.
int affine2_scan_f32(const float* A, const float* w, const float* s0,
                     float* entry, float* fin, int C, long long N, int L,
                     int threads, int B, void* stream) {
  return two_launch<float>(A, w, s0, entry, fin, C, N, L, threads, B, stream);
}

int affine2_scan_f64(const double* A, const double* w, const double* s0,
                     double* entry, double* fin, int C, long long N, int L,
                     int threads, int B, void* stream) {
  return two_launch<double>(A, w, s0, entry, fin, C, N, L, threads, B, stream);
}

// The cycles of n dependent steps: kind 2 the walk in order's step of M2
// (d <= 32, one warp), 3 M3's walk step (one thread), 4 M3's local step,
// 5 a level of M3's scan, 6 M2's chunked step (d <= 32, one thread);
// cycles: one int64 on the device; sink: 32 values of the type on the
// device.
int affine_latency_f32(int kind, long long n, int d, long long* cycles,
                       void* sink, void* stream) {
  return latency<float>(kind, n, d, cycles, sink, stream);
}

int affine_latency_f64(int kind, long long n, int d, long long* cycles,
                       void* sink, void* stream) {
  return latency<double>(kind, n, d, cycles, sink, stream);
}

}  // extern "C"
