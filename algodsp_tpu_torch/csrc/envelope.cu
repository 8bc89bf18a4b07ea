// Branching one-pole envelope follower, float32, for Hopper.
//
// Replaces: algodsp_tpu/ops/pallas_kernels.py::_env_kernel (K4), whose
// front door is envelope_scan_pallas. Same function over x (C, T):
//   env += (x - env) * (x > env ? attack[c] : release[c])
// returning the trajectory (C, T) and env_final (C,). env_final is the
// state after the last real sample (the TPU kernel's carry-out reflects
// its padded tail and is discarded by its wrapper).
//
// What bounds it on the H100: the branch makes the recurrence nonlinear,
// so time cannot be split; each channel is a chain of T dependent steps
// (compare, select, subtract, fused multiply-add: ~4 dependent
// instructions, some 15-20 cycles at ~1.7 GHz, i.e. ~10 ns per step).
// That latency bound is T * ~10 ns whatever the channel count up to the
// card's thread count, while the byte bound (read x, write the
// trajectory: 8 bytes per sample) is three orders of magnitude smaller:
// the kernel is latency-bound and its roofline share is necessarily tiny.
//
// Design: the chain itself is a compare, a select and a multiply-add
// per sample; a thread that also loads each sample from device memory
// waits on that load at every step. So each channel gets a block: four
// loader warps stage x through shared memory in tiles of ENV_TILE
// samples, double-buffered, and write each scanned tile back, while one
// thread of the first warp walks the tile in shared memory, four
// samples per vector load, writing the trajectory in place. x is read
// once and the trajectory written once, both coalesced.

#include <cuda_runtime.h>

#define ENV_TILE 2048
#define ENV_LOADERS 128

__global__ void envelope_kernel(const float* __restrict__ x,
                                const float* __restrict__ env0,
                                const float* __restrict__ attack,
                                const float* __restrict__ release,
                                float* __restrict__ traj,
                                float* __restrict__ env_final,
                                int C, int T) {
  __shared__ __align__(16) float buf[2][ENV_TILE];
  const int c = blockIdx.x;
  const float* xc = x + (size_t)c * T;
  float* oc = traj + (size_t)c * T;
  const int ntiles = (T + ENV_TILE - 1) / ENV_TILE;
  const bool loader = threadIdx.x >= 32;
  const int lt = threadIdx.x - 32;

  if (loader)
    for (int e = lt; e < ENV_TILE && e < T; e += ENV_LOADERS) buf[0][e] = xc[e];
  __syncthreads();

  float env = env0[c];
  const float a = attack[c];
  const float r = release[c];
  for (int i = 0; i < ntiles; ++i) {
    float* cur = buf[i & 1];
    float* nxt = buf[(i + 1) & 1];
    const long long base = (long long)i * ENV_TILE;
    const int len = (int)min((long long)ENV_TILE, (long long)T - base);
    if (threadIdx.x == 0) {
      int t = 0;
      for (; t + 4 <= len; t += 4) {
        float4 v = *reinterpret_cast<float4*>(cur + t);
        float coeff = (v.x > env) ? a : r;
        env = env + coeff * (v.x - env);
        v.x = env;
        coeff = (v.y > env) ? a : r;
        env = env + coeff * (v.y - env);
        v.y = env;
        coeff = (v.z > env) ? a : r;
        env = env + coeff * (v.z - env);
        v.z = env;
        coeff = (v.w > env) ? a : r;
        env = env + coeff * (v.w - env);
        v.w = env;
        *reinterpret_cast<float4*>(cur + t) = v;
      }
      for (; t < len; ++t) {
        const float v = cur[t];
        const float coeff = (v > env) ? a : r;
        env = env + coeff * (v - env);
        cur[t] = env;
      }
    } else if (loader) {
      // the other buffer holds tile i-1, already scanned: store it, then
      // load tile i+1 into the same places (each thread its own elements)
      const long long prev = base - ENV_TILE, next = base + ENV_TILE;
      for (int e = lt; e < ENV_TILE; e += ENV_LOADERS) {
        if (i > 0) oc[prev + e] = nxt[e];
        if (next + e < T) nxt[e] = xc[next + e];
      }
    }
    __syncthreads();
  }
  if (loader) {
    const long long base = (long long)(ntiles - 1) * ENV_TILE;
    const float* last = buf[(ntiles - 1) & 1];
    for (int e = lt; base + e < T && e < ENV_TILE; e += ENV_LOADERS)
      oc[base + e] = last[e];
  }
  if (threadIdx.x == 0) env_final[c] = env;
}

extern "C" {

const char* algodsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, traj: (C, T); env0, attack, release, env_final: (C,).
// Returns cudaGetLastError() after the launch.
int envelope_scan_f32(const float* x, const float* env0, const float* attack,
                      const float* release, float* traj, float* env_final,
                      int C, int T, void* stream) {
  if (C < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  envelope_kernel<<<C, 32 + ENV_LOADERS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, env0, attack, release, traj, env_final, C, T);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
