// Kernels 7-10: the glue of the T5 decode step (models/t5.py::decode_step,
// infer/decode.py::DecodeProgram), fused.
//
// Replace no TPU kernel: the JAX package leaves this glue to XLA, which
// fuses it inside its compiled decode loop.  Under PyTorch each op of the
// glue was a kernel of its own: ~446 launches a decode step under replay,
// of which ~12 a layer do the model's work (six GEMMs, two of kernel 3),
// and each of the others costs the card a graph node's floor of a few
// microseconds for ~100 KB of work.  Each kernel here takes one chain of
// that glue and keeps its intermediates in registers:
//
//   7  add_rms_norm     x += delta (or x = embedding[token]), then T5's
//                       RMSNorm of x: one warp a row
//   8  quantize_write_kv  this step's K and V rows, read from the fused
//                       q|k|v projection, quantized per (row, head) and
//                       written into the int8 cache at the step the card
//                       holds, and returned as kernel 3's fresh rows: one
//                       warp a (row, head, K or V)
//   9  gelu_mul         gelu_new(gate) * lin from the fused wi_0|wi_1
//                       projection: one thread an output
//   10 greedy_commit    the suppression, the argmax, PAD for finished
//                       rows, done, the token written at step + 1: one
//                       warp a row (the wrapper then advances the step)
//
// Bound: bytes, and at the decode shapes (128 rows, d_model 384, d_ff
// 1152, 400 ids) each moves 0.1-0.6 MB, under 0.2 us at 3.35 TB/s; the
// floor that binds is a launch's.  What the design does about it: one
// launch per chain.
//
// Arithmetic: that of the ATen chain each replaces, on the card, op by op
// -- the same roundings to the compute type between ops, IEEE division
// and no FMA contraction across what were separate kernels (__fmul_rn,
// __fadd_rn), tanhf and rsqrtf as ATen calls them, a scalar divisor
// applied as ATen's CUDA kernels apply one (times its float reciprocal).
// Kernels 8-10 equal their chains bit for bit.  Kernel 7 sums its squares
// in the order of ATen's mean (Reduce.cuh's reduce over the last dim: 4-
// value vectors when d > 128, single values else; `width` threads a row,
// which the wrapper computes as ATen's launch configuration does; each
// thread's values in four accumulators, folded, then the threads folded
// by halves), which lane l of its warp plays for ATen's threads l + 32 j.
// Another order would move the norm by an ulp at most.
//
// Contract (checked by ops/decode_fused.py): every tensor contiguous on
// one device; T (the compute type) float32 or bfloat16; kernel 7: d at
// most 1024 and, above 128, a multiple of 4, x, delta, the table and the
// weight (float32 or bfloat16) 16-byte aligned, int32 ids; kernel 8:
// d_kv at most 256; the step an int32 on the card.  Each launcher
// returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNormThreads = 128;  // 4 rows a block
constexpr int kNormVecs = 8;       // 4-value vectors a lane: d <= 1024
constexpr int kMaxWidth = 8;       // ATen's block width / 32, at most
constexpr int kQuantThreads = 128;
constexpr int kQuantVals = 8;      // values a lane: d_kv <= 256
constexpr int kGeluThreads = 256;
constexpr int kCommitWarps = 8;  // rows a block
constexpr int kCommitIds = 16;   // ids a lane loads at once: chunks of 512

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// v rounded to T, back in float: a store and a load of an ATen tensor of T
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---------------------------------------------------------------------- //
// kernel 7: x += delta (or x = table[token]); out = rms_norm(x) * w        //
// ---------------------------------------------------------------------- //

// ATen's threads fold their sums by halves, then its warp folds lanes
// l + 16, l + 8, ... into lane l; lanes past ATen's width hold 0, exact
// no-ops.  -> the row's sum, in every lane.
__device__ __forceinline__ float fold_threads(float* val, int width) {
#pragma unroll
  for (int off = kMaxWidth / 2; off >= 1; off >>= 1) {
    if (32 * off < width) {
#pragma unroll
      for (int j = 0; j < off; ++j) val[j] = __fadd_rn(val[j], val[j + off]);
    }
  }
  float s = val[0];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
  return __shfl_sync(kFull, s, 0);
}

// One warp a row.  kPer 4 (d > 128): ATen loads 4-value vectors, its
// `width` (>= 32) threads take vectors t + width n into one accumulator
// per value of a vector; lane l holds vectors l + 32 m in registers, the
// n-th vector of ATen's thread l + 32 (m % (width / 32)).  kPer 1 (d <=
// 128): single values, thread t takes value t + width n into accumulator
// n % 4; lane l plays ATen's threads l + 32 j and reads the new x back.
template <typename T, typename W, int kPer>
__global__ void __launch_bounds__(kNormThreads)
add_rms_norm_kernel(T* __restrict__ x, const T* __restrict__ delta,
                    const T* __restrict__ table,
                    const int* __restrict__ token,
                    const W* __restrict__ w, T* __restrict__ out, int rows,
                    int d, int vocab, int width, float eps, float inv_d) {
  const int row = blockIdx.x * (kNormThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  T* xr = x + (size_t)row * d;
  T* orow = out + (size_t)row * d;
  const T* src = xr;
  bool bad = false;
  if (table != nullptr) {
    const int t = token[row];
    bad = t < 0 || t >= vocab;  // an id off the table: a NaN row
    src = table + (size_t)(bad ? 0 : t) * d;
  }
  const T* dr = delta == nullptr ? nullptr : delta + (size_t)row * d;
  const bool store = dr != nullptr || table != nullptr;
  const int items = d / kPer;
  float val[kMaxWidth];
#pragma unroll
  for (int j = 0; j < kMaxWidth; ++j) val[j] = 0.f;
  if constexpr (kPer == 4) {
    float v[kNormVecs][4], dv[kNormVecs][4], wv[kNormVecs][4];
#pragma unroll
    for (int m = 0; m < kNormVecs; ++m) {  // every load first
      const int it = lane + 32 * m;
      if (it < items) {
        load4(src + 4 * it, v[m]);
        load4(w + 4 * it, wv[m]);
        if (dr != nullptr) load4(dr + 4 * it, dv[m]);
      }
    }
    const int J = width >> 5;
    float acc[kMaxWidth][4];
#pragma unroll
    for (int j = 0; j < kMaxWidth; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int m = 0; m < kNormVecs; ++m) {
      const int it = lane + 32 * m;
      if (it < items) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (bad) v[m][i] = __int_as_float(0x7fc00000);
          if (dr != nullptr) v[m][i] = rnd<T>(__fadd_rn(v[m][i], dv[m][i]));
        }
        if (store) store4(xr + 4 * it, v[m]);
#pragma unroll
        for (int j = 0; j < kMaxWidth; ++j) {
          if (j == m % J) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[j][i] = __fadd_rn(acc[j][i], __fmul_rn(v[m][i], v[m][i]));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxWidth; ++j)
      val[j] = __fadd_rn(__fadd_rn(__fadd_rn(acc[j][0], acc[j][1]),
                                   acc[j][2]), acc[j][3]);
    const float r = rsqrtf(__fadd_rn(__fmul_rn(fold_threads(val, width),
                                               inv_d), eps));
#pragma unroll
    for (int m = 0; m < kNormVecs; ++m) {
      const int it = lane + 32 * m;
      if (it < items) {
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[i] = __fmul_rn(wv[m][i], rnd<T>(__fmul_rn(v[m][i], r)));
        store4(orow + 4 * it, o);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kMaxWidth; ++j) {
      const int t = lane + 32 * j;
      if (32 * j < width && t < width) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        int n = 0;
        for (int it = t; it < items; it += width, ++n) {
          float v = to_f(src[it]);
          if (bad) v = __int_as_float(0x7fc00000);
          if (dr != nullptr) v = rnd<T>(__fadd_rn(v, to_f(dr[it])));
          if (store) xr[it] = from_f<T>(v);
          const float sq = __fmul_rn(v, v);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if ((n & 3) == i) a[i] = __fadd_rn(a[i], sq);
        }
        val[j] = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
      }
    }
    const float r = rsqrtf(__fadd_rn(__fmul_rn(fold_threads(val, width),
                                               inv_d), eps));
    __syncwarp();  // the new x, to every lane
    for (int it = lane; it < items; it += 32)
      orow[it] = from_f<T>(__fmul_rn(to_f(w[it]),
                                     rnd<T>(__fmul_rn(to_f(xr[it]), r))));
  }
}

// ---------------------------------------------------------------------- //
// kernel 8: quantize this step's K and V rows and write them at the step  //
// ---------------------------------------------------------------------- //

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_write_kv_kernel(const T* __restrict__ qkv,
                         int8_t* __restrict__ k_vals,
                         float* __restrict__ k_scales,
                         int8_t* __restrict__ v_vals,
                         float* __restrict__ v_scales,
                         int8_t* __restrict__ k_new,
                         float* __restrict__ k_new_scale,
                         int8_t* __restrict__ v_new,
                         float* __restrict__ v_new_scale,
                         const int* __restrict__ step, int rows, int heads,
                         int dk, int cache_len, float levels) {
  const int item = blockIdx.x * (kQuantThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= 2 * rows * heads) return;
  const int which = item / (rows * heads);  // 0: K, 1: V
  const int bh = item - which * rows * heads;
  const int b = bh / heads, h = bh - b * heads;
  const int inner = heads * dk;
  const T* src = qkv + (size_t)b * 3 * inner + (size_t)(1 + which) * inner
      + (size_t)h * dk;
  float v[kQuantVals];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kQuantVals; ++k) {
    const int j = lane + 32 * k;
    if (j < dk) {
      v[k] = to_f(src[j]);
      const float a = fabsf(v[k]);
      amax = (a > amax || is_nan(a)) ? a : amax;  // amax keeps a NaN
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float o = __shfl_xor_sync(kFull, amax, off);
    amax = (o > amax || is_nan(o)) ? o : amax;
  }
  // clamp(amax, min=1e-8) / levels: ATen divides by a host scalar as a
  // product with its float reciprocal; x / scale is a true division
  const float tiny = static_cast<float>(1e-8);
  const float clamped = is_nan(amax) ? amax : fmaxf(amax, tiny);
  const float scale = __fmul_rn(clamped, __fdiv_rn(1.0f, levels));
  const int s = *step;
  const bool write = s >= 0 && s < cache_len;
  int8_t* vals = which ? v_vals : k_vals;
  int8_t* fresh = (which ? v_new : k_new) + (size_t)bh * dk;
  int8_t* slot = vals + ((size_t)bh * cache_len + (write ? s : 0)) * dk;
#pragma unroll
  for (int k = 0; k < kQuantVals; ++k) {
    const int j = lane + 32 * k;
    if (j < dk) {
      float q = rintf(__fdiv_rn(v[k], scale));
      q = fminf(fmaxf(q, -levels), levels);
      const int8_t q8 = static_cast<int8_t>(q);
      fresh[j] = q8;
      if (write) slot[j] = q8;
    }
  }
  if (lane == 0) {
    (which ? v_new_scale : k_new_scale)[bh] = scale;
    if (write) (which ? v_scales : k_scales)[(size_t)bh * cache_len + s] = scale;
  }
}

// ---------------------------------------------------------------------- //
// kernel 9: gelu_new(gate) * lin                                          //
// ---------------------------------------------------------------------- //

template <typename T>
__global__ void __launch_bounds__(kGeluThreads)
gelu_mul_kernel(const T* __restrict__ gate_lin, T* __restrict__ out,
                int rows, int f) {
  const size_t i = (size_t)blockIdx.x * kGeluThreads + threadIdx.x;
  if (i >= (size_t)rows * f) return;
  const size_t r = i / f, j = i - r * f;
  const T* row = gate_lin + r * 2 * f;
  const float x = to_f(row[j]), lin = to_f(row[f + j]);
  // models/t5.py::gelu_new, op by op: the polynomial in T, the tanh and
  // the products in float
  const float c3 = static_cast<float>(0.044715);
  const float c = 0x1.988454p-1f;  // float32(sqrt(2 / pi))
  const float x3 = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(x, x)), x));
  const float poly = rnd<T>(__fadd_rn(x, rnd<T>(__fmul_rn(c3, x3))));
  const float inner = __fmul_rn(poly, c);
  const float half = rnd<T>(__fmul_rn(0.5f, x));
  const float gelu = __fmul_rn(half, __fadd_rn(tanhf(inner), 1.0f));
  out[i] = from_f<T>(__fmul_rn(gelu, lin));
}

// ---------------------------------------------------------------------- //
// kernel 10: greedy selection and the loop's bookkeeping                  //
// ---------------------------------------------------------------------- //

// torch.argmax's order as one 64-bit key to maximize: the value's bits
// made monotone (a NaN above every number, -0 equal to +0) over the id
// complemented (of equal values the lower id wins).  0 is no key.
__device__ __forceinline__ unsigned long long argmax_key(float v, int j) {
  const unsigned u = __float_as_uint(v);
  const unsigned k = is_nan(v) ? 0xffffffffu
      : v == 0.f ? 0x80000000u
      : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)k << 32) | (0xffffffffu - (unsigned)j);
}

// One warp a row, kCommitWarps rows a block: a lane issues the loads of
// a chunk of kCommitIds ids before it compares.  The step is only read:
// no block can tell that every other has read it, so the wrapper
// advances it after the launch.
template <typename T>
__global__ void __launch_bounds__(32 * kCommitWarps)
greedy_commit_kernel(T* __restrict__ logits,
                     const long long* __restrict__ suppress, int n_suppress,
                     bool* __restrict__ done, int* __restrict__ tokens,
                     int* __restrict__ token, const int* __restrict__ step,
                     int rows, int vocab, int buf_len, int pad_id,
                     int eos_id) {
  const int s = *step;
  const int r0 = blockIdx.x * kCommitWarps;
  const int n_rows = min(kCommitWarps, rows - r0);
  for (int i = threadIdx.x; i < n_rows * n_suppress; i += blockDim.x) {
    const int r = r0 + i / n_suppress;
    const long long id = suppress[i % n_suppress];
    if (id >= 0 && id < vocab)  // an id off the logits is no id
      logits[(size_t)r * vocab + id] =
          from_f<T>(__int_as_float((int)0xff800000u));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, r = r0 + (threadIdx.x >> 5);
  if (r < rows) {
    const T* row = logits + (size_t)r * vocab;
    unsigned long long best = 0ull;
    for (int c0 = 0; c0 < vocab; c0 += 32 * kCommitIds) {
      float v[kCommitIds];
#pragma unroll
      for (int e = 0; e < kCommitIds; ++e) {
        const int j = c0 + lane + 32 * e;
        v[e] = j < vocab ? to_f(row[j]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kCommitIds; ++e) {
        const int j = c0 + lane + 32 * e;
        if (j < vocab) best = max(best, argmax_key(v[e], j));
      }
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      best = max(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) {
      const int id = (int)(0xffffffffu - (unsigned)best);
      const int nxt = done[r] ? pad_id : id;
      if (nxt == eos_id) done[r] = true;
      if (s + 1 >= 0 && s + 1 < buf_len)
        tokens[(size_t)r * buf_len + s + 1] = nxt;
      token[r] = nxt;
    }
  }
}

unsigned blocks(size_t n, int per) { return (unsigned)((n + per - 1) / per); }

template <typename T, typename W>
void launch_norm(dim3 grid, cudaStream_t st, void* x, const void* delta,
                 const void* table, const void* token, const void* w,
                 void* out, int rows, int d, int vocab, int width,
                 float eps) {
  const float inv_d = 1.0f / (float)d;  // ATen's mean factor
  const int* ids = static_cast<const int*>(token);
  if (d > 128)
    add_rms_norm_kernel<T, W, 4><<<grid, kNormThreads, 0, st>>>(
        static_cast<T*>(x), static_cast<const T*>(delta),
        static_cast<const T*>(table), ids, static_cast<const W*>(w),
        static_cast<T*>(out), rows, d, vocab, width, eps, inv_d);
  else
    add_rms_norm_kernel<T, W, 1><<<grid, kNormThreads, 0, st>>>(
        static_cast<T*>(x), static_cast<const T*>(delta),
        static_cast<const T*>(table), ids, static_cast<const W*>(w),
        static_cast<T*>(out), rows, d, vocab, width, eps, inv_d);
}

}  // namespace

extern "C" int m2m_add_rms_norm(void* x, const void* delta, const void* table,
                                const void* token, const void* w, void* out,
                                int rows, int d, int vocab, int width,
                                int bf16, int w_bf16, float eps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks(rows, kNormThreads / 32));
#define M2M_NORM(T, W)                                                     \
  launch_norm<T, W>(grid, st, x, delta, table, token, w, out, rows, d,     \
                    vocab, width, eps)
  if (bf16 && w_bf16) M2M_NORM(__nv_bfloat16, __nv_bfloat16);
  else if (bf16) M2M_NORM(__nv_bfloat16, float);
  else if (w_bf16) M2M_NORM(float, __nv_bfloat16);
  else M2M_NORM(float, float);
#undef M2M_NORM
  return (int)cudaGetLastError();
}

extern "C" int m2m_quantize_write_kv(const void* qkv, void* k_vals,
                                     void* k_scales, void* v_vals,
                                     void* v_scales, void* k_new,
                                     void* k_new_scale, void* v_new,
                                     void* v_new_scale, const void* step,
                                     int rows, int heads, int dk,
                                     int cache_len, int bf16, float levels,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks((size_t)2 * rows * heads, kQuantThreads / 32));
  const dim3 block(kQuantThreads);
#define M2M_QUANT(T)                                                       \
  quantize_write_kv_kernel<T><<<grid, block, 0, st>>>(                     \
      static_cast<const T*>(qkv), static_cast<int8_t*>(k_vals),           \
      static_cast<float*>(k_scales), static_cast<int8_t*>(v_vals),        \
      static_cast<float*>(v_scales), static_cast<int8_t*>(k_new),         \
      static_cast<float*>(k_new_scale), static_cast<int8_t*>(v_new),      \
      static_cast<float*>(v_new_scale), static_cast<const int*>(step),    \
      rows, heads, dk, cache_len, levels)
  if (bf16) M2M_QUANT(__nv_bfloat16);
  else M2M_QUANT(float);
#undef M2M_QUANT
  return (int)cudaGetLastError();
}

extern "C" int m2m_gelu_mul(const void* gate_lin, void* out, int rows, int f,
                            int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks((size_t)rows * f, kGeluThreads)), block(kGeluThreads);
  if (bf16)
    gelu_mul_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(gate_lin),
        static_cast<__nv_bfloat16*>(out), rows, f);
  else
    gelu_mul_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(gate_lin), static_cast<float*>(out), rows,
        f);
  return (int)cudaGetLastError();
}

extern "C" int m2m_greedy_commit(void* logits, const void* suppress,
                                 int n_suppress, void* done, void* tokens,
                                 void* token, const void* step, int rows,
                                 int vocab, int buf_len, int pad_id,
                                 int eos_id, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks(rows, kCommitWarps));
#define M2M_COMMIT(T)                                                      \
  greedy_commit_kernel<T><<<grid, 32 * kCommitWarps, 0, st>>>(             \
      static_cast<T*>(logits), static_cast<const long long*>(suppress),   \
      n_suppress, static_cast<bool*>(done), static_cast<int*>(tokens),    \
      static_cast<int*>(token), static_cast<const int*>(step), rows,      \
      vocab, buf_len, pad_id, eos_id)
  if (bf16) M2M_COMMIT(__nv_bfloat16);
  else M2M_COMMIT(float);
#undef M2M_COMMIT
  return (int)cudaGetLastError();
}
