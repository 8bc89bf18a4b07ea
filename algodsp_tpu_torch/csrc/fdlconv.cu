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
// 8B bytes of signal (read x, write y) and does two real 2B-point FFTs
// plus a P-tap complex MAC over B+1 bins. At the bench shape (8 ch x
// 2^24, B = 8192, P = 17) that is ~1.07 GB (~0.32 ms at 3.35 TB/s)
// against ~37 GFLOP (~0.55 ms at 67 TFLOP/s f32): operation-bound. The
// frame spectra this design keeps in device memory (two scratches of
// ~1 GB at that shape) make its traffic, not its arithmetic, the limit.
//
// No tensor cores: a DFT as a wgmma product runs in TF32 or lower, which
// cannot hold the 110 dB bars, so every FFT runs on the float32 FMA units.
//
// Design: three launches, no host synchronisation.
//   1. fdl_forward, one FFT per (channel, frame): the real 2B-sample
//      frame is taken as the B-point complex signal z[n] = x[2n] +
//      i x[2n+1] (half the work of a complex 2B-point FFT, each channel
//      on its own), transformed by a register-resident Stockham FFT, and
//      split into bins 0..B of the real frame's spectrum.
//   2. fdl_mac, a block per (channel, bin slice, group of G frames):
//      one thread per bin walks the taps, holding the G outputs' sums
//      and a window of G frame spectra in registers; each tap reads one
//      new frame spectrum and one partition spectrum, so a frame
//      spectrum is read (G + P - 1) / G times, not P times.
//   3. fdl_inverse, one FFT per (channel, frame): the MAC's half
//      spectrum is folded back into a B-point complex spectrum, inverse
//      transformed, and only the kept half is stored, scaled by 1/2B.
// The FFT: B = 16^k * rem points, B/16 threads each holding 16 points in
// registers; a stage is a radix-16 (or radix-rem) butterfly in registers
// with twiddles from float64-accurate tables, one per stage, laid out so
// that a warp's loads are coalesced, and one exchange through padded
// shared memory (index + index/16: no bank conflicts) separates two
// stages. The first stage reads device memory directly and the
// inverse's last stage writes it; 1024 points take two exchanges (16,
// 16, 4), 8192 points three (16, 16, 16, 2). Each channel is transformed
// on its own (no a + ib pair packing), so a quiet channel never shares
// roundoff with a loud one.

#include <cuda_runtime.h>

#define FFT_RADIX 16
#define MAC_THREADS 128
#define MAX_BLOCK 8192
#define FFT_MAX_THREADS (MAX_BLOCK / FFT_RADIX)  // one FFT of MAX_BLOCK points

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

static __device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

static __host__ __device__ constexpr int padded(int m) { return m + (m >> 4); }

// 4-bit reversal of 0 <= i < 16, as a switch so that a constant i folds
static __device__ __forceinline__ int rev16(int i) {
  switch (i) {
    case 0: return 0;   case 1: return 8;   case 2: return 4;   case 3: return 12;
    case 4: return 2;   case 5: return 10;  case 6: return 6;   case 7: return 14;
    case 8: return 1;   case 9: return 9;   case 10: return 5;  case 11: return 13;
    case 12: return 3;  case 13: return 11; case 14: return 7;  default: return 15;
  }
}

// exp(-2 pi i e / 16) for 0 <= e < 8
static __device__ __forceinline__ float2 w16(int e) {
  switch (e) {
    case 0: return make_float2(1.0f, 0.0f);
    case 1: return make_float2(0.92387953251128676f, -0.38268343236508977f);
    case 2: return make_float2(0.70710678118654752f, -0.70710678118654752f);
    case 3: return make_float2(0.38268343236508977f, -0.92387953251128676f);
    case 4: return make_float2(0.0f, -1.0f);
    case 5: return make_float2(-0.38268343236508977f, -0.92387953251128676f);
    case 6: return make_float2(-0.70710678118654752f, -0.70710678118654752f);
    default: return make_float2(-0.92387953251128676f, -0.38268343236508977f);
  }
}

// One radix-2 decimation-in-frequency pass of span HALF over v[0..R), then
// the passes below it: every index a template constant, so v stays in
// registers.
template <int R, int HALF, bool INV>
struct DifPass {
  static __device__ __forceinline__ void run(float2* v) {
#pragma unroll
    for (int blk = 0; blk < R; blk += 2 * HALF) {
#pragma unroll
      for (int k = 0; k < HALF; ++k) {
        const float2 a = v[blk + k], b = v[blk + k + HALF];
        v[blk + k] = make_float2(a.x + b.x, a.y + b.y);
        float2 d = make_float2(a.x - b.x, a.y - b.y);
        const int e = k * (16 / (2 * HALF));
        if (e == 4) {
          d = INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
        } else if (e != 0) {
          float2 w = w16(e);
          if (INV) w.y = -w.y;
          d = cmul(d, w);
        }
        v[blk + k + HALF] = d;
      }
    }
    DifPass<R, HALF / 2, INV>::run(v);
  }
};

template <int R, bool INV>
struct DifPass<R, 0, INV> {
  static __device__ __forceinline__ void run(float2*) {}
};

// In-register R-point DFT of v[0..R), natural order in and out (the
// radix-2 passes leave it bit-reversed; the reversal is register renaming).
template <int R, bool INV>
static __device__ __forceinline__ void dft(float2* v) {
  DifPass<R, R / 2, INV>::run(v);
  float2 t[R];
#pragma unroll
  for (int i = 0; i < R; ++i) t[i] = v[rev16(i) / (16 / R)];
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = t[i];
}

// One Stockham stage of radix R on the thread's registers: butterfly j
// (j = lt + b*T for each of its nb butterflies) holds elements
// j + i*M/R; twiddle by W_{Ns R}^{(j mod Ns) i}, then the R-point DFT.
// Its outputs go to (j / Ns) Ns R + j mod Ns + i Ns. The stage's table
// holds W_{Ns R}^{jj i} at tws[(i - 1) Ns + jj], so a warp's twiddle
// loads are coalesced.
template <int R, bool INV>
static __device__ __forceinline__ void stage(float2* v, int lt, int T, int nb,
                                             int Ns,
                                             const float2* __restrict__ tws) {
#pragma unroll
  for (int b = 0; b < FFT_RADIX / R; ++b) {
    if (b < nb) {
      const int j = lt + b * T, jj = j & (Ns - 1);
      if (Ns > 1) {
#pragma unroll
        for (int i = 1; i < R; ++i) {
          float2 w = __ldg(tws + (i - 1) * Ns + jj);
          if (INV) w.y = -w.y;
          v[b * R + i] = cmul(v[b * R + i], w);
        }
      }
      dft<R, INV>(v + b * R);
    }
  }
}

template <int R>
static __device__ __forceinline__ void load_smem(float2* v, const float2* s,
                                                 int lt, int T, int nb, int M) {
#pragma unroll
  for (int b = 0; b < FFT_RADIX / R; ++b)
    if (b < nb)
#pragma unroll
      for (int i = 0; i < R; ++i) v[b * R + i] = s[pad(lt + b * T + i * (M / R))];
}

template <int R>
static __device__ __forceinline__ void store_smem(const float2* v, float2* s,
                                                  int lt, int T, int nb,
                                                  int Ns) {
#pragma unroll
  for (int b = 0; b < FFT_RADIX / R; ++b)
    if (b < nb) {
      const int j = lt + b * T, jj = j & (Ns - 1);
      const int base = (j - jj) * R + jj;
#pragma unroll
      for (int i = 0; i < R; ++i) s[pad(base + i * Ns)] = v[b * R + i];
    }
}

#define RADIX_SWITCH(r, CALL)       \
  switch (r) {                      \
    case 16: { constexpr int R = 16; CALL; } break; \
    case 8: { constexpr int R = 8; CALL; } break;   \
    case 4: { constexpr int R = 4; CALL; } break;   \
    default: { constexpr int R = 2; CALL; } break;  \
  }

// The M-point FFT whose first stage's inputs are in v: exchanges through
// s; the last stage's outputs stay in v (butterfly layout of its radix).
// tw holds the split table (M entries), then each later stage's table.
template <bool INV>
static __device__ __forceinline__ void fft(float2* v, float2* s, int lt,
                                           int T, int M, int n16, int rem,
                                           const float2* __restrict__ tw) {
  const int S = n16 + (rem > 1 ? 1 : 0);
  const float2* tws = tw + M;
  int Ns = 1;
  for (int st = 0; st < S; ++st) {
    const int r = st < n16 ? 16 : rem;
    const int nb = (M / r) / T;
    if (st > 0) {
      RADIX_SWITCH(r, load_smem<R>(v, s, lt, T, nb, M));
      __syncthreads();
    }
    RADIX_SWITCH(r, (stage<R, INV>(v, lt, T, nb, Ns, tws)));
    if (st + 1 < S) {
      RADIX_SWITCH(r, store_smem<R>(v, s, lt, T, nb, Ns));
      __syncthreads();
    }
    if (Ns > 1) tws += (r - 1) * Ns;
    Ns *= r;
  }
}

static __device__ __forceinline__ int first_radix(int n16, int rem) {
  return n16 > 0 ? 16 : rem;
}

// First stage's inputs of the forward FFT: z[n] = x[2n] + i x[2n+1] of
// the frame starting at x[base] (x < 0 reads as 0).
template <int R>
static __device__ __forceinline__ void load_frame(float2* v,
                                                  const float* __restrict__ xc,
                                                  long long base, bool active,
                                                  int lt, int T, int nb, int M) {
#pragma unroll
  for (int b = 0; b < FFT_RADIX / R; ++b)
    if (b < nb)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long src = base + 2ll * (lt + b * T + i * (M / R));
        v[b * R + i] = (active && src >= 0)
                           ? *reinterpret_cast<const float2*>(xc + src)
                           : make_float2(0.0f, 0.0f);
      }
}

// First stage's inputs of the inverse FFT, folded from the half spectrum
// Y[0..M]: Z[n] = E + i O with E = Y[n] + conj Y[M-n] and
// O = (Y[n] - conj Y[M-n]) conj(w^n), w = exp(-i pi / M).
template <int R>
static __device__ __forceinline__ void load_folded(float2* v,
                                                   const float2* __restrict__ Yf,
                                                   const float2* __restrict__ tw,
                                                   bool active, int lt, int T,
                                                   int nb, int M) {
#pragma unroll
  for (int b = 0; b < FFT_RADIX / R; ++b)
    if (b < nb)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = lt + b * T + i * (M / R);
        float2 z = make_float2(0.0f, 0.0f);
        if (active) {
          const float2 yn = Yf[n], ym = Yf[M - n];
          const float2 e = make_float2(yn.x + ym.x, yn.y - ym.y);
          float2 w = __ldg(tw + n);
          w.y = -w.y;
          const float2 o = cmul(make_float2(yn.x - ym.x, yn.y + ym.y), w);
          z = make_float2(e.x - o.y, e.y + o.x);
        }
        v[b * R + i] = z;
      }
}

// The inverse's last stage holds outputs j + i Ns (Ns = M / R) in natural
// order; z[n] for n >= M/2 are the kept samples y[2(n - M/2)] and the
// one after it, scaled by 1/2M.
template <int R>
static __device__ __forceinline__ void store_kept(const float2* v,
                                                  float* __restrict__ yf,
                                                  int lt, int T, int nb, int M) {
  const float scale = 1.0f / (2.0f * (float)M);
  const int Ns = M / R;
#pragma unroll
  for (int b = 0; b < FFT_RADIX / R; ++b)
    if (b < nb) {
      const int j = lt + b * T;
#pragma unroll
      for (int i = R / 2; i < R; ++i) {
        const int n = j + i * Ns;
        const float2 z = v[b * R + i];
        *reinterpret_cast<float2*>(yf + 2 * (n - M / 2)) =
            make_float2(z.x * scale, z.y * scale);
      }
    }
}

__global__ void __launch_bounds__(FFT_MAX_THREADS) fdl_forward(const float* __restrict__ x,
                            const float2* __restrict__ tw,
                            float2* __restrict__ X, int C, int N, int B,
                            int n16, int rem, int T) {
  extern __shared__ float2 smem[];
  const int M = B, fpb = blockDim.x / T;
  const int slot = threadIdx.x / T, lt = threadIdx.x % T;
  const int nf = N / B;
  const long long g = (long long)blockIdx.x * fpb + slot;
  const bool active = g < (long long)C * nf;
  const int c = active ? (int)(g / nf) : 0, f = active ? (int)(g % nf) : 0;
  float2* s = smem + slot * padded(M);
  const float* xc = x + (size_t)c * N;
  const long long base = (long long)(f - 1) * B;
  float2 v[FFT_RADIX];
  {
    const int r = first_radix(n16, rem), nb = (M / r) / T;
    RADIX_SWITCH(r, load_frame<R>(v, xc, base, active, lt, T, nb, M));
  }
  fft<false>(v, s, lt, T, M, n16, rem, tw);
  // the last stage's outputs, in natural order, to shared memory
  {
    const int S = n16 + (rem > 1 ? 1 : 0);
    const int r = S > n16 ? rem : 16, nb = (M / r) / T;
    __syncthreads();
    RADIX_SWITCH(r, store_smem<R>(v, s, lt, T, nb, M / r));
    __syncthreads();
  }
  if (!active) return;
  // split: X[k] = E + w^k O, X[B-k] = conj(E - w^k O), with
  // E = (Z[k] + conj Z[B-k]) / 2, O = -i (Z[k] - conj Z[B-k]) / 2
  float2* Xf = X + ((size_t)c * nf + f) * (B + 1);
#pragma unroll 4
  for (int k = lt; k <= M / 2; k += T) {
    const float2 zk = s[pad(k)], zm = s[pad((M - k) & (M - 1))];
    const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
    const float2 wk = cmul(__ldg(tw + k), o);
    Xf[k] = make_float2(e.x + wk.x, e.y + wk.y);
    Xf[M - k] = make_float2(e.x - wk.x, -(e.y - wk.y));
  }
}

template <int G>
__global__ void fdl_mac(const float2* __restrict__ X,
                        const float2* __restrict__ H, float2* __restrict__ Y,
                        int nf, int B, int P) {
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k > B) return;
  const long long g0 = (long long)blockIdx.x * G;
  const size_t stride = (size_t)B + 1;
  const float2* Xc = X + (size_t)blockIdx.z * nf * stride + k;
  float2* Yc = Y + (size_t)blockIdx.z * nf * stride + k;
  const float2 zero = make_float2(0.0f, 0.0f);
  // win holds X_m in slot (m - g0) mod G; acc[j] sums output frame g0 + j
  float2 win[G], acc[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const long long m = g0 + q;
    win[q] = m < nf ? Xc[m * stride] : zero;
    acc[q] = zero;
  }
  for (int p0 = 0; p0 < P; p0 += G) {
    // issue the G taps' loads together: one device-memory latency per
    // G taps, not one per tap
    float2 xin[G], hin[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int p = p0 + q;
      const long long m = g0 - p;
      hin[q] = p < P ? __ldg(H + (size_t)p * stride + k) : zero;
      xin[q] = (p > 0 && p < P && m >= 0) ? Xc[m * stride] : zero;
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int p = p0 + q;
      if (p >= P) break;
      if (p > 0) win[(G - q) % G] = xin[q];
      const float2 h = hin[q];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float2 xv = win[(j - q + G) % G];
        acc[j].x += h.x * xv.x - h.y * xv.y;
        acc[j].y += h.x * xv.y + h.y * xv.x;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (g0 + j < nf) Yc[(g0 + j) * stride] = acc[j];
}

__global__ void __launch_bounds__(FFT_MAX_THREADS) fdl_inverse(const float2* __restrict__ Y,
                            const float2* __restrict__ tw,
                            float* __restrict__ y, int C, int N, int B,
                            int n16, int rem, int T) {
  extern __shared__ float2 smem[];
  const int M = B, fpb = blockDim.x / T;
  const int slot = threadIdx.x / T, lt = threadIdx.x % T;
  const int nf = N / B;
  const long long g = (long long)blockIdx.x * fpb + slot;
  const bool active = g < (long long)C * nf;
  const int c = active ? (int)(g / nf) : 0, f = active ? (int)(g % nf) : 0;
  float2* s = smem + slot * padded(M);
  const float2* Yf = Y + ((size_t)c * nf + f) * (B + 1);
  float2 v[FFT_RADIX];
  {
    const int r = first_radix(n16, rem), nb = (M / r) / T;
    RADIX_SWITCH(r, load_folded<R>(v, Yf, tw, active, lt, T, nb, M));
  }
  fft<true>(v, s, lt, T, M, n16, rem, tw);
  if (!active) return;
  const int S = n16 + (rem > 1 ? 1 : 0);
  const int r = S > n16 ? rem : 16, nb = (M / r) / T;
  float* yf = y + (size_t)c * N + (size_t)f * B;
  RADIX_SWITCH(r, store_kept<R>(v, yf, lt, T, nb, M));
}

// -- The spectra adjoint (A1's dH) -----------------------------------------
//
// Replaces: the spectra half of algodsp_tpu/ops/fdlconv.py::_fdl_bwd (the
// custom-VJP backward of the fused FDL; jnp.fft plus a frame-lag
// correlation in XLA there). It is the transpose of fdl_mac: with X the
// frame spectra of the forward (its first launch's scratch) and dV the
// rfft of the embedded cotangent frames [0_B, g_f],
//   dH[p, k] = w_k sum_c sum_{f=p}^{nf-1} dV[c, f, k] conj(X[c, f-p, k])
// for p < nf, and 0 for nf <= p < P (a partition delayed past the last
// frame never meets the signal). w_k = c_k / 2B, c_k = 2 on the interior
// bins and 1 at DC and Nyquist: the adjoint of irfft at 2B points over
// the port's half spectrum. The imaginary parts at DC and Nyquist are
// read by no inverse transform, so they get no gradient (0).
//
// What bounds it on the H100: per (p, k) it runs C (nf - p) complex
// multiply-adds, ~8 C nf P (B+1) operations in all, against the bytes of
// X and dV (16 C nf (B+1)) and dH (8 P (B+1)); at IR learning's 8 x 47
// frames of B = 1024 and P = 32 that is ~0.1 GFLOP: operation-bound.
// Design: one thread per (p, k) walking (c, f), neighbouring threads on
// neighbouring bins so that every load is coalesced; the sum is float64 in
// the order (c, f), so it does not depend on the launch. Each spectrum is
// read P times (from L2 at the training shapes): simple and right first.
__global__ void fdl_spectra_adjoint_kernel(const float2* __restrict__ X,
                                           const float2* __restrict__ dV,
                                           float2* __restrict__ dH, int C,
                                           int nf, int B) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  if (k > B) return;
  const size_t stride = (size_t)B + 1;
  double re = 0.0, im = 0.0;
  for (int c = 0; c < C && p < nf; ++c) {
    const float2* Vc = dV + (size_t)c * nf * stride + k;
    const float2* Xc = X + (size_t)c * nf * stride + k;
    for (int f = p; f < nf; ++f) {
      const float2 v = __ldg(Vc + (size_t)f * stride);
      const float2 x = __ldg(Xc + (size_t)(f - p) * stride);
      re += (double)v.x * x.x + (double)v.y * x.y;
      im += (double)v.y * x.x - (double)v.x * x.y;
    }
  }
  const bool edge = k == 0 || k == B;
  const double w = (edge ? 1.0 : 2.0) / (2.0 * B);
  dH[(size_t)p * stride + k] =
      make_float2((float)(re * w), edge ? 0.0f : (float)(im * w));
}

typedef void (*MacKernel)(const float2*, const float2*, float2*, int, int, int);

static MacKernel mac_kernel(int G) {
  switch (G) {
    case 1: return fdl_mac<1>;
    case 2: return fdl_mac<2>;
    case 4: return fdl_mac<4>;
    case 8: return fdl_mac<8>;
    case 16: return fdl_mac<16>;
    default: return nullptr;
  }
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (C, N) with N % B == 0; H: (P, B+1) complex; tw: complex, the
// split table tw[k] = exp(-i pi k / B) for k < B, then for each stage
// after the first (Ns > 1 points transformed so far, radix R) the table
// W_{Ns R}^{jj i} at [(i - 1) Ns + jj]; X, Y: (C, N/B, B+1) complex scratch. B is a
// power of two in [2, 8192]. The plan comes from ops/fdlconv.py:
// B = 16^n16 * rem, T threads per FFT, fpb FFTs per block, G frames per
// MAC group. Returns cudaGetLastError() after the last launch.
int fdl_conv_f32(const float* x, const float* H, const float* tw, float* X,
                 float* Y, float* y, int C, int N, int B, int P, int n16,
                 int rem, int T, int fpb, int G, void* stream) {
  int m = 1;
  for (int i = 0; i < n16; ++i) m *= 16;
  if (C < 1 || C > 65535 || B < 2 || B > MAX_BLOCK || (B & (B - 1)) ||
      N < B || N % B || P < 1 || n16 < 0 || (rem != 1 && rem != 2 &&
      rem != 4 && rem != 8 && rem != 16) || (rem == 16 && n16) ||
      m * rem != B || T != (B >= 16 ? B / 16 : 1) || fpb < 1 ||
      fpb * T > FFT_MAX_THREADS || !mac_kernel(G))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)fpb * padded(B) * sizeof(float2);
  cudaError_t err;
  // opt in to the largest exchange buffer once per device, so that later
  // calls (and a CUDA graph capturing them) make no attribute call
  static int opted_in[64] = {0};
  const int max_smem = padded(MAX_BLOCK) * (int)sizeof(float2);
  if (smem > (size_t)max_smem) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(fdl_forward,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(fdl_inverse,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted_in[dev] = 1;
  }
  const int nf = N / B;
  const long long frames = (long long)C * nf;
  const unsigned fft_blocks = (unsigned)((frames + fpb - 1) / fpb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  fdl_forward<<<fft_blocks, fpb * T, smem, st>>>(
      x, tw2, reinterpret_cast<float2*>(X), C, N, B, n16, rem, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 mac_grid((unsigned)((nf + G - 1) / G),
                      (unsigned)((B + 1 + MAC_THREADS - 1) / MAC_THREADS),
                      (unsigned)C);
  mac_kernel(G)<<<mac_grid, MAC_THREADS, 0, st>>>(
      reinterpret_cast<const float2*>(X), reinterpret_cast<const float2*>(H),
      reinterpret_cast<float2*>(Y), nf, B, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fdl_inverse<<<fft_blocks, fpb * T, smem, st>>>(
      reinterpret_cast<const float2*>(Y), tw2, y, C, N, B, n16, rem, T);
  return static_cast<int>(cudaGetLastError());
}

// X, dV: (C, nf, B+1) complex; dH: (P, B+1) complex, written whole. B in
// [2, 8192]. Returns cudaGetLastError() after the launch.
int fdl_spectra_adjoint_f32(const float* X, const float* dV, float* dH, int C,
                            int nf, int B, int P, void* stream) {
  if (C < 1 || C > 65535 || nf < 1 || B < 2 || B > MAX_BLOCK || P < 1 ||
      P > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((B + 1 + MAC_THREADS - 1) / MAC_THREADS),
                  (unsigned)P);
  fdl_spectra_adjoint_kernel<<<grid, MAC_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(X), reinterpret_cast<const float2*>(dV),
      reinterpret_cast<float2*>(dH), C, nf, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
