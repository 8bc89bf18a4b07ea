// Dependent-chain latency of the Moog kernels' primitives on one SM, and
// the worst error of each float32 tanh candidate, for tools/moog_bench.py
// (--latency). Includes csrc/moog.cu, so the primitives measured are the
// kernels' own; the candidates that were not kept are defined here.
//
// moog_latency(cycles, n): one warp runs each chain n times between two
//   clock64() reads, 32 lanes on spread arguments (a branch that diverges
//   across the warp shows); cycles[lane * count + i] = that lane's cycles
//   for the n links of chain i, in the order of LATENCY_NAMES in
//   moog_bench.py.
// moog_tanh_error(err, n): each candidate on n points evenly over
//   [-12, 12] and on [-1, 1], against the float64 tanh of the same float;
//   err[3 i .. 3 i + 2] = max |error|, max error in ulp of the true value,
//   and 1 if NaN gives NaN, +-inf give +-1 and -0 gives -0, else 0.

#include <type_traits>

#include "../algodsp_tpu_torch/csrc/moog.cu"

namespace {

// tanh.approx.f32, the hardware tanh (MUFU.TANH)
__device__ __forceinline__ float tanh_hw(float z, float) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}

__device__ __forceinline__ float tanh_libm(float z, float) { return tanhf(z); }

// A clamped odd rational x P(x^2) / Q(x^2) (Eigen's float tanh), the
// quotient by rcp.approx and one FMA refinement
__device__ __forceinline__ float tanh_rational(float z, float) {
  const float x = clip(z, 7.99881172180175781f);
  const float x2 = x * x;
  float p = -2.76076847742355e-16f;
  p = fmaf(x2, p, 2.00018790482477e-13f);
  p = fmaf(x2, p, -8.60467152213735e-11f);
  p = fmaf(x2, p, 5.12229709037114e-08f);
  p = fmaf(x2, p, 1.48572235717979e-05f);
  p = fmaf(x2, p, 6.37261928875436e-04f);
  p = fmaf(x2, p, 4.89352455891786e-03f);
  p = x * p;
  float q = 1.19825839466702e-06f;
  q = fmaf(x2, q, 1.18534705686654e-04f);
  q = fmaf(x2, q, 2.26843463243900e-03f);
  q = fmaf(x2, q, 4.89352518554385e-03f);
  return quotient(p, q);
}

__device__ __forceinline__ float clip_select(float v, float lim) {
  return v < -lim ? -lim : (v > lim ? lim : v);
}

__device__ __forceinline__ float clip_minmax(float v, float lim) {
  return fminf(fmaxf(v, -lim), lim);
}

constexpr float W2 = 2.8853900817779268f;

// n links of v = f(v) between two clock64() reads; primitives unrolled
// 16 times (no loop overhead), kernel steps not unrolled (their loop
// overhead is the kernels' own, and 16 copies of a ZDF step would not
// stay in the instruction cache)
template <int UNROLL = 16, typename F>
__device__ __forceinline__ long long chain(F f, float v0, int n, float& sink) {
  float v = v0;
  const long long t0 = clock64();
#pragma unroll (UNROLL)
  for (int i = 0; i < n; ++i) v = f(v);
  const long long t1 = clock64();
  sink += v;
  return t1 - t0;
}

__global__ void latency_kernel(long long* out, float* sink_out, float a,
                               float b, float c, int n, int count,
                               LadderParams<float> huov,
                               LadderParams<float> classic) {
  const int lane = threadIdx.x;
  for (LadderParams<float>* q : {&huov, &classic}) {
    q->t_hi = tanh_ds<float, 0>(*q, STATE_LIMIT);
    q->t_lo = tanh_ds<float, 0>(*q, -STATE_LIMIT);
  }
  // arguments spread over both sides of TANH_SPLIT; the tanh chains
  // v -> c tanh(v) + b with c = -3 stay spread (the fixed point is
  // unstable), the linear ones v -> a v + b settle
  const float v0 = -1.5f + 3.0f * lane / 31.0f;
  float sink = 0.0f;
  long long* o = out + lane * count;
  auto put = [&](long long cyc) { *o++ = cyc; };
  put(chain([&](float v) { return fmaf(v, a, b); }, v0, n, sink));
  put(chain([&](float v) { return v * a; }, v0, n, sink));
  put(chain([&](float v) { return clip(fmaf(v, a, b), 32.0f); }, v0, n, sink));
  put(chain([&](float v) { return clip_select(fmaf(v, a, b), 32.0f); }, v0, n,
            sink));
  put(chain([&](float v) { return clip_minmax(fmaf(v, a, b), 32.0f); }, v0, n,
            sink));
  put(chain([&](float v) { return ex2_approx(v) - 1.25f; }, v0, n, sink));
  put(chain([&](float v) { return b / v; }, 2.0f + v0, n, sink));
  put(chain([&](float v) { return quotient(b, v); }, 2.0f + v0, n, sink));
  // the tanh candidates as a ladder stage uses them: tanh(ds * v) with
  // w = 2 log2(e) ds v, then the FMA that feeds the next stage
  const float ds = 1.0f, k2 = W2 * ds;
  put(chain([&](float v) { return fmaf(tanh_libm(ds * v, k2 * v), c, b); },
            v0, n, sink));
  put(chain([&](float v) { return fmaf(tanh_f32(ds * v, k2 * v), c, b); },
            v0, n, sink));
  put(chain([&](float v) { return fmaf(tanh_rational(ds * v, k2 * v), c, b); },
            v0, n, sink));
  put(chain([&](float v) { return fmaf(tanh_hw(ds * v, k2 * v), c, b); }, v0,
            n, sink));
  // the kernels' steps, x fixed: Huovilainen and classic ladder steps,
  // the ZDF step at newton 4
  {
    const LadderParams<float> p{0.3f, 1.0f, W2, 2.0f, 1.0f, 1.0f, 1.0f,
                                tanh_f32(32.0f, 32.0f * W2),
                                tanh_f32(-32.0f, -32.0f * W2)};
    LadderState<float> st{0.1f * v0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    put(chain<1>([&](float v) { return ladder_step<float, 2>(p, v, st); }, v0,
                 n, sink));
    put(chain<1>([&](float v) { return ladder_step<float, 0>(p, v, st); }, v0,
                 n, sink));
  }
  {
    ZdfParams<float> p;
    p.gk = 0.1f; p.shape = 1.0f; p.k = 2.0f; p.ig = 1.0f; p.osc = 1.0f;
    p.osf = 1.0f; p.vs = 0.1f; p.gs = 0.1f; p.gsw = W2 * 0.1f; p.sk = 2.0f;
    p.skw = W2 * 2.0f; p.sw = W2;
    float s[4] = {0.1f * v0, 0.0f, 0.0f, 0.0f};
    float prev = 0.0f;
    put(chain<1>([&](float v) { return zdf_step(p, v, s, prev, 4); }, v0, n,
                 sink));
  }
  // the loop overhead of one not-unrolled link
  put(chain<1>([&](float v) { return fmaf(v, a, b); }, v0, n, sink));
  // the kernels' own walk of a tile row in shared memory (y written in
  // place of x), per ladder step: Huovilainen at os 4 fixed and at run
  // time, classic at os 1; staging of the tiles is not in it
  {
    __shared__ float rows[MOOG_WARP][TileLen<float>::value + 1];
    float* row = rows[lane];
    for (int i = 0; i <= TileLen<float>::value; ++i)
      row[i] = 0.3f * __sinf(0.1f * i + lane);
    __syncwarp();
    // parameters known at compile time (folded), then the kernels' own
    // (the chain block's Huovilainen ladder at os 4, the classic ladder of
    // the 128 x 2^16 shape at os 1) passed at run time
    const LadderParams<float> fixed{0.3f, 1.0f, W2, 2.0f, 1.0f, 1.0f, 4.0f,
                                   tanh_f32(32.0f, 32.0f * W2),
                                   tanh_f32(-32.0f, -32.0f * W2)};
    LadderState<float> st{0.1f * v0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const int len = TileLen<float>::value, reps = n / (4 * len) + 1;
    auto walk = [&](auto os_tag, int os, int mode_huov,
                    const LadderParams<float>& p) {
      const long long t0 = clock64();
      for (int r = 0; r < reps; ++r) {
        if (mode_huov)
          walk_row<decltype(os_tag)::value>(row, len, os, p.osf, p.osc,
              [&](float xv) { return ladder_step<float, 2>(p, xv, st); });
        else
          walk_row<decltype(os_tag)::value>(row, len, os, p.osf, p.osc,
              [&](float xv) { return ladder_step<float, 0>(p, xv, st); });
      }
      const long long t1 = clock64();
      sink += st.s3;
      // cycles of n steps, as the chains above
      return (t1 - t0) * n / ((long long)reps * len * os);
    };
    LadderParams<float> fixed1 = fixed;
    fixed1.osf = 1.0f;
    put(walk(std::integral_constant<int, 4>(), 4, 1, fixed));
    put(walk(std::integral_constant<int, 0>(), 4, 1, fixed));
    put(walk(std::integral_constant<int, 1>(), 1, 0, fixed1));
    put(walk(std::integral_constant<int, 4>(), 4, 1, huov));
    put(walk(std::integral_constant<int, 1>(), 1, 0, classic));
  }
  // sink keeps the chains live
  sink_out[lane] = sink;
}

// Spins one thread for `cycles` SM clocks: timed by CUDA events, it gives
// the SM clock a one-warp kernel runs at
__global__ void spin_kernel(long long cycles, long long* out) {
  const long long t0 = clock64();
  long long t = t0;
  while (t - t0 < cycles) t = clock64();
  *out = t - t0;
}

// moog_ladder_kernel<float, MODE, OS> with clock64() stamps: lane 0 of
// block 0 writes [cycles of the whole kernel, cycles inside walk_row
// summed over the tiles]
template <int MODE, int OS>
__global__ void __launch_bounds__(2 * MOOG_WARP)
ladder_probe(const float* __restrict__ x, const float* __restrict__ st_in,
             float* __restrict__ y, LadderParams<float> p, int C,
             long long Tn, int os, long long* stamps) {
  const long long t_start = clock64();
  long long in_walk = 0;
  p.t_hi = tanh_ds<float, MODE>(p, STATE_LIMIT);
  p.t_lo = tanh_ds<float, MODE>(p, -STATE_LIMIT);
  const int c = blockIdx.x * MOOG_WARP + threadIdx.x;
  LadderState<float> st{};
  if (threadIdx.x < MOOG_WARP && c < C) {
    st.s0 = st_in[c];
    st.s1 = st_in[C + c];
    st.s2 = st_in[2 * C + c];
    st.s3 = st_in[3 * C + c];
    st.fbv = st.s3;
  }
  tiled_walk(x, y, C, Tn, [&](float* row, int len) {
    const long long t0 = clock64();
    walk_row<OS>(row, len, os, p.osf, p.osc,
                 [&](float xv) { return ladder_step<float, MODE>(p, xv, st); });
    in_walk += clock64() - t0;
  });
  const long long t_end = clock64();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    stamps[0] = t_end - t_start;
    stamps[1] = in_walk;
    stamps[2] = (long long)st.s3;
  }
}

__device__ __forceinline__ unsigned ord(float v) { return __float_as_uint(v); }

template <typename F>
__device__ void error_of(F f, int n, unsigned* acc) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n; i += stride) {
    const float z = i < n ? -12.0f + 24.0f * (float(i) / float(n))
                          : -1.0f + 2.0f * (float(i - n) / float(n));
    const float got = f(z, W2 * z);
    const double ref = tanh(double(z));
    const double err = fabs(double(got) - ref);
    const float rf = float(ref);
    const double ulp = fabs(double(nextafterf(fabsf(rf), 2.0f)) - fabsf(rf));
    atomicMax(acc, ord(float(err)));
    atomicMax(acc + 1, ord(float(err / ulp)));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const float nan = __int_as_float(0x7fc00000);
    const float inf = __int_as_float(0x7f800000);
    const float mz = f(-0.0f, -0.0f);
    const bool ok = isnan(f(nan, nan)) && f(inf, inf) == 1.0f &&
                    f(-inf, -inf) == -1.0f && mz == 0.0f && signbit(mz);
    acc[2] = ok ? 1u : 0u;
  }
}

__global__ void error_kernel(unsigned* acc, int n) {
  error_of(tanh_libm, n, acc);
  error_of(tanh_f32, n, acc + 3);
  error_of(tanh_rational, n, acc + 6);
  error_of(tanh_hw, n, acc + 9);
}

}  // namespace

extern "C" {

// cycles: 32 lanes x count int64 on the device (count >= the chains
// measured); sink: 32 float32; huov, classic: host arrays [coef, ds, fb,
// ig, osc, os] of the two ladders the walks run at run time
int moog_latency(long long* cycles, float* sink, int n, int count,
                 const double* huov, const double* classic) {
  auto params = [](const double* q) {
    return LadderParams<float>{float(q[0]), float(q[1]),
                               float(LOG2E_X2 * q[1]), float(q[2]),
                               float(q[3]), float(q[4]), float(q[5]), 0.0f, 0.0f};
  };
  latency_kernel<<<1, 32>>>(cycles, sink, -0.75f, 0.25f, -3.0f, n, count,
                            params(huov), params(classic));
  return static_cast<int>(cudaGetLastError());
}

// the classic ladder (os 1) or the Huovilainen ladder (os 4) over x
// (C, T) with the stamps of ladder_probe
int moog_probe(const float* x, const float* st_in, float* y,
               const double* q, int C, long long T, int huov,
               long long* stamps) {
  const LadderParams<float> p{float(q[0]), float(q[1]),
                              float(LOG2E_X2 * q[1]), float(q[2]),
                              float(q[3]), float(q[4]), float(q[5]), 0.0f, 0.0f};
  const dim3 grid((C + MOOG_WARP - 1) / MOOG_WARP);
  if (huov)
    ladder_probe<2, 4><<<grid, 2 * MOOG_WARP>>>(x, st_in, y, p, C, T, 4,
                                                stamps);
  else
    ladder_probe<0, 1><<<grid, 2 * MOOG_WARP>>>(x, st_in, y, p, C, T, 1,
                                                stamps);
  return static_cast<int>(cudaGetLastError());
}

int moog_spin(long long cycles, long long* out) {
  spin_kernel<<<1, 1>>>(cycles, out);
  return static_cast<int>(cudaGetLastError());
}

// acc: 12 uint32 on the device, zeroed; read back as float32 except
// every third
int moog_tanh_error(unsigned* acc, int n) {
  error_kernel<<<264, 256>>>(acc, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
