// Kernel 6: the Mamba-2 decode state update, one pass over each row's
// state per layer and step.
//
// Replaces no TPU kernel: the JAX package has no such model.  It was added
// for the hybrid decoder (models/granite_hybrid.py), whose decode step
// keeps a float32 SSM state of H x P x N per row and per mamba layer
// (128 x 64 x 128 = 4 MiB at granite-4.0-h's widths) and must read and
// write all of it at every step:
//
//     h  <- exp(dt * A) * h + dt * x (outer) B
//     y   = h . C + D * x
//
// Bound: the state's bytes, read once and written once (1.07 GB a layer
// step at 128 rows, 0.32 ms at 3.35 TB/s); x, dt, B and C are ~0.2 % of
// that.  Design: one block of 256 threads per (row, head) pair holds that
// pair's P x N slab; a warp takes rows p of it, each lane four
// consecutive n (one 16-byte load of a float32 state, 8 bytes of a
// bfloat16 one), and issues the loads of all its rows before it computes,
// so that each thread keeps up to eight loads in flight; the new state is
// stored in place and the row's y is a warp sum of h * C.  The new state
// is computed in float32 and y is taken from it before it is rounded to a
// bfloat16 state (the control's precision), as a fused update would.
//
// Contract (checked by ops/ssm_state_update.py): state (B, H, P, N)
// float32 or bfloat16, contiguous; x (B, H, P), dt (B, H) after softplus,
// A (H,) (negative), D (H,), B and C (B, G, N), y (B, H, P): float32,
// contiguous, 16-byte aligned; N a multiple of 4; H a multiple of G.  The
// launcher returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows of the slab a warp loads before computing

struct State4 {
  float v[4];
};

__device__ __forceinline__ State4 load4(const float* p) {
  float4 f = *reinterpret_cast<const float4*>(p);
  return {{f.x, f.y, f.z, f.w}};
}

__device__ __forceinline__ State4 load4(const __nv_bfloat16* p) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&u.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&u.y);
  float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return {{fa.x, fa.y, fb.x, fb.y}};
}

__device__ __forceinline__ void store4(float* p, const State4& s) {
  *reinterpret_cast<float4*>(p) = make_float4(s.v[0], s.v[1], s.v[2], s.v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const State4& s) {
  __nv_bfloat162 a = __floats2bfloat162_rn(s.v[0], s.v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(s.v[2], s.v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
ssm_state_update_kernel(S* __restrict__ state, const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ D, float* __restrict__ y,
                        int H, int P, int N, int G) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float dtv = dt[bh];
  const float dA = expf(dtv * A[h]);
  const float Dh = D[h];
  const float* Bp = Bm + ((size_t)b * G + g) * N;
  const float* Cp = Cm + ((size_t)b * G + g) * N;
  const float* xp = x + (size_t)bh * P;
  S* slab = state + (size_t)bh * P * N;
  for (int p0 = warp; p0 < P; p0 += kWarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int n = lane * 4; n < N; n += 128) {
      State4 s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int p = p0 + r * kWarps;
        if (p < P) s[r] = load4(slab + (size_t)p * N + n);
      }
      const State4 bv = load4(Bp + n), cv = load4(Cp + n);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int p = p0 + r * kWarps;
        if (p < P) {
          const float dtx = dtv * xp[p];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[r].v[i] = s[r].v[i] * dA + dtx * bv.v[i];
            acc[r] += s[r].v[i] * cv.v[i];
          }
          store4(slab + (size_t)p * N + n, s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float a = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      const int p = p0 + r * kWarps;
      if (lane == 0 && p < P) y[(size_t)bh * P + p] = a + Dh * xp[p];
    }
  }
}

}  // namespace

extern "C" int m2m_ssm_state_update(void* state, const void* x,
                                    const void* dt, const void* A,
                                    const void* Bm, const void* Cm,
                                    const void* D, void* y, int B, int H,
                                    int P, int N, int G, int state_bf16,
                                    void* stream) {
  const dim3 grid((unsigned)B * (unsigned)H), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const float* Df = static_cast<const float*>(D);
  float* yf = static_cast<float*>(y);
  if (state_bf16)
    ssm_state_update_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<__nv_bfloat16*>(state), xf, dtf, Af, Bf, Cf, Df, yf, H, P,
        N, G);
  else
    ssm_state_update_kernel<float><<<grid, block, 0, s>>>(
        static_cast<float*>(state), xf, dtf, Af, Bf, Cf, Df, yf, H, P, N, G);
  return (int)cudaGetLastError();
}
