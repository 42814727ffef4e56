// Decode-step attention over int8 K/V caches for Hopper (sm_90a).
//
// Two kernels, one thread block per (batch row, head):
//
//   decode_attention_int8_kernel replaces
//     music2midi_tpu/ops/decode_attention.py::decode_attention_int8
//     (kernel _kernel): scores = (q . k8_l) ks_l in f32, plus the
//     relative-position bias and keys <= step (causal; key `step` taken
//     from this step's fresh quantized row) or keys < enc_len (cross);
//     f32 softmax; out = sum_l (p_l vs_l) v8_l in f32, rounded to bf16.
//   decode_attention_cross_t_kernel replaces
//     music2midi_tpu/ops/decode_attention.py::decode_attention_cross_t
//     (kernel _cross_kernel): the same cross attention over TRANSPOSED
//     (B, H, D, L) int8 K/V, as its source reads: each int8 x bf16
//     product rounded to bf16 (the f32 product is exact, so one rounding),
//     sums in f32, and p vs rounded to bf16 before the PV products.
//
// Masked keys are never read: the TPU kernels give them -1e9, which
// underflows to a probability of exactly 0, so skipping them changes no
// value.  The caches are read through their strides, so a whole
// max_length buffer can be passed with no copy.
//
// Bound on the H100: the bytes of the int8 cache (4 flops per int8 byte
// read, far under the card's ~20 fp32 flops per byte of HBM bandwidth).
// The design is the simple one: q and the score row in shared memory
// (4 bytes a visible key), warp-shuffle reductions, 16-byte int8 row loads
// in the int8 kernel (4 threads per 64-byte key row) and byte loads along
// L in the transposed one (any L, e.g. 190, with no padding).  One CTA per
// (b, h) is 512 CTAs at the serving batch of 64; nothing overlaps the
// score pass with the PV pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 64;  // head dim (d_kv) the kernels are written for
constexpr unsigned kFull = 0xffffffffu;

// field order and types match the ctypes structures of
// music2midi_tpu_torch/ops/decode_attention.py
struct Int8AttnArgs {
    const __nv_bfloat16* q;  // [b q_sb + h q_sh + d]
    const int8_t* k;         // [b k_sb + h k_sh + l k_sl + d]
    const int8_t* v;
    const float* ks;         // [b ks_sb + h ks_sh + l ks_sl]
    const float* vs;
    const float* bias;       // [h bias_sh + l bias_sl] (causal)
    const int8_t* kn;        // fresh rows [b kn_sb + h kn_sh + d] (causal)
    const int8_t* vn;
    const float* kns;        // their scales [b kns_sb + h kns_sh]
    const float* vns;
    __nv_bfloat16* out;      // (B, H, D) contiguous
    int64_t q_sb, q_sh, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl;
    int64_t ks_sb, ks_sh, ks_sl, vs_sb, vs_sh, vs_sl, bias_sh, bias_sl;
    int64_t kn_sb, kn_sh, vn_sb, vn_sh, kns_sb, kns_sh, vns_sb, vns_sh;
    int H, n_keys, step, causal;
};

struct CrossTArgs {
    const __nv_bfloat16* q;  // [b q_sb + h q_sh + d]
    const int8_t* kt;        // [b kt_sb + h kt_sh + d kt_sd + l]
    const int8_t* vt;
    const float* ks;         // [b ks_sb + h ks_sh + l ks_sl]
    const float* vs;
    __nv_bfloat16* out;      // (B, H, D) contiguous
    int64_t q_sb, q_sh, kt_sb, kt_sh, kt_sd, vt_sb, vt_sh, vt_sd;
    int64_t ks_sb, ks_sh, ks_sl, vs_sb, vs_sh, vs_sl;
    int H, n_keys;
};

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

// block-wide max / sum; `red` holds kWarps floats, free again on return
__device__ float block_max(float v, float* red) {
    v = warp_max(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float r = red[0];
    for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
    __syncthreads();
    return r;
}

__device__ float block_sum(float v, float* red) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float r = 0.0f;
    for (int w = 0; w < kWarps; ++w) r += red[w];
    __syncthreads();
    return r;
}

// the 16 signed bytes of a 16-byte load, as floats
__device__ __forceinline__ void unpack16(const int4 raw, float* x) {
    const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
        }
    }
}

// softmax over s[0, n) in place, then s[l] *= scale(l); the block's
// threads all take part
template <typename Scale>
__device__ void softmax_scaled(float* s, int n, float local_max, float* red,
                               Scale scale) {
    const float m = block_max(local_max, red);
    float sum = 0.0f;
    for (int l = threadIdx.x; l < n; l += kThreads) {
        const float e = expf(s[l] - m);
        s[l] = e;
        sum += e;
    }
    sum = block_sum(sum, red);
    for (int l = threadIdx.x; l < n; l += kThreads) s[l] = scale(l, s[l] / sum);
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
decode_attention_int8_kernel(const Int8AttnArgs a) {
    extern __shared__ float s[];  // (n_keys,) scores, then p vs
    __shared__ float red[kWarps];
    __shared__ float part[kWarps][kD];

    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int c = tid & 3;  // this thread's 16 of the 64 dims
    const int n = a.n_keys;
    const bool causal = a.causal != 0;

    const int8_t* kb = a.k + b * a.k_sb + h * a.k_sh;
    const int8_t* vb = a.v + b * a.v_sb + h * a.v_sh;
    const int8_t* kfresh = causal ? a.kn + b * a.kn_sb + h * a.kn_sh : nullptr;
    const int8_t* vfresh = causal ? a.vn + b * a.vn_sb + h * a.vn_sh : nullptr;
    const float* ksb = a.ks + b * a.ks_sb + h * a.ks_sh;
    const float* vsb = a.vs + b * a.vs_sb + h * a.vs_sh;

    float qf[16];
    const __nv_bfloat16* qp = a.q + b * a.q_sb + h * a.q_sh + 16 * c;
#pragma unroll
    for (int i = 0; i < 16; ++i) qf[i] = __bfloat162float(qp[i]);

    // scores: four threads per key, eight keys per warp and pass; the loop
    // is warp-uniform so the shuffles see every lane
    float local_max = -INFINITY;
    for (int base = warp * 8; base < n; base += kWarps * 8) {
        const int l = base + (lane >> 2);
        float acc = 0.0f;
        if (l < n) {
            const bool fresh = causal && l == a.step;
            const int8_t* row = fresh ? kfresh : kb + l * a.k_sl;
            float x[16];
            unpack16(*reinterpret_cast<const int4*>(row + 16 * c), x);
#pragma unroll
            for (int i = 0; i < 16; ++i) acc = fmaf(x[i], qf[i], acc);
        }
        acc += __shfl_xor_sync(kFull, acc, 1);
        acc += __shfl_xor_sync(kFull, acc, 2);
        if (l < n && c == 0) {
            const bool fresh = causal && l == a.step;
            const float scale = fresh ? a.kns[b * a.kns_sb + h * a.kns_sh]
                                      : ksb[l * a.ks_sl];
            float sc = acc * scale;
            if (causal) sc += a.bias[h * a.bias_sh + l * a.bias_sl];
            s[l] = sc;
            local_max = fmaxf(local_max, sc);
        }
    }
    __syncthreads();

    // the lambda captures scalars by value, not the kernel's argument
    // struct (whose address would move it to local memory)
    const float vn_scale = causal ? a.vns[b * a.vns_sb + h * a.vns_sh] : 0.0f;
    const int step = a.step;
    const int64_t vs_sl = a.vs_sl;
    softmax_scaled(s, n, local_max, red, [=](int l, float p) {
        return p * ((causal && l == step) ? vn_scale : vsb[l * vs_sl]);
    });

    // out[d] = sum_l s[l] v8[l][d]: thread (key group tid / 4, dims c)
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
    for (int l = tid >> 2; l < n; l += kThreads / 4) {
        const bool fresh = causal && l == a.step;
        const int8_t* row = fresh ? vfresh : vb + l * a.v_sl;
        float x[16];
        unpack16(*reinterpret_cast<const int4*>(row + 16 * c), x);
        const float w = s[l];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = fmaf(w, x[i], acc[i]);
    }
    // sum the warp's eight key groups (lanes with the same c), then warps
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        float v = acc[i];
        v += __shfl_xor_sync(kFull, v, 4);
        v += __shfl_xor_sync(kFull, v, 8);
        v += __shfl_xor_sync(kFull, v, 16);
        acc[i] = v;
    }
    if (lane < 4) {
#pragma unroll
        for (int i = 0; i < 16; ++i) part[warp][16 * lane + i] = acc[i];
    }
    __syncthreads();
    if (tid < kD) {
        float o = 0.0f;
        for (int w = 0; w < kWarps; ++w) o += part[w][tid];
        a.out[static_cast<int64_t>(blockIdx.x) * kD + tid] = __float2bfloat16_rn(o);
    }
}

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
decode_attention_cross_t_kernel(const CrossTArgs a) {
    extern __shared__ float s[];  // (n_keys,) scores, then bf16(p vs)
    __shared__ float red[kWarps];
    __shared__ float qs[kD];

    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = a.n_keys;
    const int8_t* kt = a.kt + b * a.kt_sb + h * a.kt_sh;
    const int8_t* vt = a.vt + b * a.vt_sb + h * a.vt_sh;
    const float* ksb = a.ks + b * a.ks_sb + h * a.ks_sh;
    const float* vsb = a.vs + b * a.vs_sb + h * a.vs_sh;

    if (tid < kD) qs[tid] = __bfloat162float(a.q[b * a.q_sb + h * a.q_sh + tid]);
    __syncthreads();

    // scores: one thread per key, byte loads along L (coalesced per d)
    float local_max = -INFINITY;
    for (int l = tid; l < n; l += kThreads) {
        float acc = 0.0f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) {
            acc += bf16_round(static_cast<float>(kt[d * a.kt_sd + l]) * qs[d]);
        }
        const float sc = acc * ksb[l * a.ks_sl];
        s[l] = sc;
        local_max = fmaxf(local_max, sc);
    }
    __syncthreads();

    const int64_t vs_sl = a.vs_sl;
    softmax_scaled(s, n, local_max, red, [=](int l, float p) {
        return bf16_round(p * vsb[l * vs_sl]);
    });

    // out[d]: one warp per row d of V^T, lanes along L
    for (int d = warp; d < kD; d += kWarps) {
        const int8_t* row = vt + d * a.vt_sd;
        float acc = 0.0f;
        for (int l = lane; l < n; l += 32) {
            acc += bf16_round(static_cast<float>(row[l]) * s[l]);
        }
        acc = warp_sum(acc);
        if (lane == 0) {
            a.out[static_cast<int64_t>(blockIdx.x) * kD + d] = __float2bfloat16_rn(acc);
        }
    }
}

}  // namespace

extern "C" int m2m_decode_attention_int8(const void* args, int blocks,
                                         void* stream) {
    const Int8AttnArgs a = *static_cast<const Int8AttnArgs*>(args);
    const size_t smem = static_cast<size_t>(a.n_keys) * sizeof(float);
    decode_attention_int8_kernel<<<blocks, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int m2m_decode_attention_cross_t(const void* args, int blocks,
                                            void* stream) {
    const CrossTArgs a = *static_cast<const CrossTArgs*>(args);
    const size_t smem = static_cast<size_t>(a.n_keys) * sizeof(float);
    decode_attention_cross_t_kernel<<<blocks, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
