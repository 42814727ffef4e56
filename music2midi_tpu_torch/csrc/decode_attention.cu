// Decode-step attention over int8 K/V caches for Hopper (sm_90a).
//
// Two kernels, one thread block per (batch row, head):
//
//   decode_attention_int8_kernel<RoundPV> replaces
//     music2midi_tpu/ops/decode_attention.py::decode_attention_int8
//     (kernel _kernel): scores = (q . k8_l) ks_l in f32, plus the
//     relative-position bias and keys <= step (causal; key `step` taken
//     from this step's fresh quantized row) or keys < enc_len (cross);
//     f32 softmax; out = sum_l (p_l vs_l) v8_l in f32, rounded to bf16.
//     RoundPV = false is the TPU kernel's arithmetic; RoundPV = true
//     rounds each p_l vs_l to bf16 before the PV pass (the fresh row's
//     too), the arithmetic of music2midi_tpu/models/t5.py::_attention_int8,
//     which the JAX engine serves with and so the port's engine too.
//   decode_attention_cross_t_kernel replaces
//     music2midi_tpu/ops/decode_attention.py::decode_attention_cross_t
//     (kernel _cross_kernel): the same cross attention over TRANSPOSED
//     (B, H, D, L) int8 K/V, as its source reads: each int8 x bf16
//     product rounded to bf16 (the f32 product is exact, so one rounding),
//     sums in f32, and p vs rounded to bf16 before the PV products.
//
// Masked keys add nothing: the TPU kernels give them -1e9, which
// underflows to a probability of exactly 0.  The caches are read through
// their strides, so a whole max_length buffer can be passed with no copy.
//
// Bound on the H100: the bytes of the int8 cache (4 flops per int8 byte
// read, far under the card's ~20 fp32 flops per byte of HBM bandwidth).
// One CTA per (b, h) is 512 CTAs at the serving batch of 64, one wave, so
// a call takes one CTA's latency chain.
//
// The int8 kernel: q and the score row in shared memory (4 bytes a
// visible key), warp-shuffle reductions, 16-byte int8 row loads (4
// threads per 64-byte key row); it reads only the visible keys and
// overlaps nothing.
//
// The transposed kernel shortens that chain.  Its rows are padded to 16
// bytes (ops/decode_attention.py::transpose_cross_entry), so at the start
// the CTA issues every 16-byte cp.async of its K tile and then of its V
// tile (2 x 64 x 192 bytes at L = 190) into shared memory, and the V bytes
// arrive while the score pass runs.  The score pass reads K from shared
// memory: warp w takes dims w, w + 8, ..., each lane 8 consecutive keys
// as one 8-byte read (a warp reads one row contiguously), and the eight
// warps' partial sums meet in shared memory.  The PV pass gives each
// thread one dim and every fourth 16-key piece, read 16 bytes at a time
// (the row pitch of keys + 16 bytes spreads a warp's 8 rows over the
// banks), and sums the four pieces' threads by shuffles.

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
    int H, n_keys, step, causal, round_pv;
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

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool RoundPV>
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
        const float pv = p * ((causal && l == step) ? vn_scale : vsb[l * vs_sl]);
        return RoundPV ? bf16_round(pv) : pv;
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

constexpr int kMaxCrossTKeys = 1024;  // ops/decode_attention.py's MAX_CROSS_T_KEYS

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// shared bytes of the transposed kernel for n keys: K and V tiles (64 rows
// of `keys + 16` bytes), the eight warps' partial scores, the score row and
// the two scale rows
__host__ __device__ inline size_t cross_t_smem(int n) {
    const size_t np = (n + 15) & ~15;
    return 2 * kD * (np + 16) + (kWarps + 3) * np * sizeof(float);
}

// the four signed bytes of a word as exact floats, on the ALU rather than
// the conversion unit: byte b ^ 0x80 = s + 128 goes under the exponent of
// 2^23, and 2^23 + 128 comes off
__device__ __forceinline__ void unpack4(unsigned w, float* x) {
    const unsigned u = w ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        x[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.0f;
    }
}

// a + bf16(x) and then b + bf16(y): one packed conversion rounds both
__device__ __forceinline__ void add_bf16_pair(float& a, float& b, float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const unsigned u = *reinterpret_cast<const unsigned*>(&h);
    a += __uint_as_float(u << 16);
    b += __uint_as_float(u & 0xffff0000u);
}

__global__ void __launch_bounds__(kThreads)
decode_attention_cross_t_kernel(const CrossTArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red_max[kWarps], red_sum[kWarps];
    __shared__ float qs[kD];

    const int n = a.n_keys;
    const int np = (n + 15) & ~15;  // keys staged per row
    const int pitch = np + 16;      // row pitch of the tiles, bytes
    const int pieces = np / 16;     // 16-byte pieces per row
    int8_t* kt_s = reinterpret_cast<int8_t*>(smem);
    int8_t* vt_s = kt_s + kD * pitch;
    float* part = reinterpret_cast<float*>(vt_s + kD * pitch);  // (kWarps, np)
    float* s = part + kWarps * np;  // (np,) scores, then bf16(p vs)
    float* ks_s = s + np;           // (np,) the scales
    float* vs_s = ks_s + np;

    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int8_t* kt = a.kt + b * a.kt_sb + h * a.kt_sh;
    const int8_t* vt = a.vt + b * a.vt_sb + h * a.vt_sh;
    const float* ksb = a.ks + b * a.ks_sb + h * a.ks_sh;
    const float* vsb = a.vs + b * a.vs_sb + h * a.vs_sh;

    // q and the scales are requested first, into registers, so that they do
    // not queue behind the tiles' copies; then every copy of the tile at
    // once: K in the first group, V in the second
    constexpr int kPer = kMaxCrossTKeys / kThreads;
    float ksr[kPer], vsr[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int l = tid + j * kThreads;
        ksr[j] = l < n ? ksb[l * a.ks_sl] : 0.0f;
        vsr[j] = l < n ? vsb[l * a.vs_sl] : 0.0f;
    }
    const float qv = tid < kD ? __bfloat162float(a.q[b * a.q_sb + h * a.q_sh + tid]) : 0.0f;
    for (int i = tid; i < kD * pieces; i += kThreads) {
        const int d = i / pieces, c = 16 * (i % pieces);
        cp_async16(kt_s + d * pitch + c, kt + d * a.kt_sd + c);
    }
    cp_async_commit();
    for (int i = tid; i < kD * pieces; i += kThreads) {
        const int d = i / pieces, c = 16 * (i % pieces);
        cp_async16(vt_s + d * pitch + c, vt + d * a.vt_sd + c);
    }
    cp_async_commit();
    if (tid < kD) qs[tid] = qv;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int l = tid + j * kThreads;
        if (l < n) {
            ks_s[l] = ksr[j];
            vs_s[l] = vsr[j];
        }
    }
    cp_async_wait<1>();
    __syncthreads();

    // partial scores: warp w sums dims w, w + 8, ..., lane 8 keys
    for (int l0 = 8 * lane; l0 < np; l0 += 8 * 32) {
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < kD / kWarps; ++j) {
            const int d = warp + kWarps * j;
            const float qd = qs[d];
            const uint2 raw = *reinterpret_cast<const uint2*>(kt_s + d * pitch + l0);
            float x[8];
            unpack4(raw.x, x);
            unpack4(raw.y, x + 4);
#pragma unroll
            for (int i = 0; i < 8; i += 2) {
                add_bf16_pair(acc[i], acc[i + 1], x[i] * qd, x[i + 1] * qd);
            }
        }
        float4* dst = reinterpret_cast<float4*>(part + warp * np + l0);
        dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    __syncthreads();

    // softmax over the n keys (each thread its own keys), then bf16(p vs)
    float m = -INFINITY;
    for (int l = tid; l < n; l += kThreads) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += part[w * np + l];
        s[l] = acc * ks_s[l];
        m = fmaxf(m, s[l]);
    }
    m = warp_max(m);
    if (lane == 0) red_max[warp] = m;
    __syncthreads();
    m = red_max[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_max[w]);
    float sum = 0.0f;
    for (int l = tid; l < n; l += kThreads) {
        s[l] = expf(s[l] - m);
        sum += s[l];
    }
    sum = warp_sum(sum);
    if (lane == 0) red_sum[warp] = sum;
    __syncthreads();
    sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum += red_sum[w];
    for (int l = tid; l < np; l += kThreads) {
        s[l] = l < n ? bf16_round(s[l] / sum * vs_s[l]) : 0.0f;  // pad keys: 0
    }
    cp_async_wait<0>();
    __syncthreads();

    // out[d]: thread (d, g) takes pieces g, g + 4, ... of row d of V^T
    const int d = tid >> 2, g0 = tid & 3;
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int g = g0; g < pieces; g += 4) {
        const int4 raw = *reinterpret_cast<const int4*>(vt_s + d * pitch + 16 * g);
        const float4* p4 = reinterpret_cast<const float4*>(s + 16 * g);
        const unsigned w[4] = {static_cast<unsigned>(raw.x), static_cast<unsigned>(raw.y),
                               static_cast<unsigned>(raw.z), static_cast<unsigned>(raw.w)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float x[4];
            unpack4(w[i], x);
            const float4 p = p4[i];
            add_bf16_pair(acc0, acc1, x[0] * p.x, x[1] * p.y);
            add_bf16_pair(acc0, acc1, x[2] * p.z, x[3] * p.w);
        }
    }
    float acc = acc0 + acc1;
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    if (g0 == 0) {
        a.out[static_cast<int64_t>(blockIdx.x) * kD + d] = __float2bfloat16_rn(acc);
    }
}

}  // namespace

extern "C" int m2m_decode_attention_int8(const void* args, int blocks,
                                         void* stream) {
    const Int8AttnArgs a = *static_cast<const Int8AttnArgs*>(args);
    const size_t smem = static_cast<size_t>(a.n_keys) * sizeof(float);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (a.round_pv) {
        decode_attention_int8_kernel<true><<<blocks, kThreads, smem, st>>>(a);
    } else {
        decode_attention_int8_kernel<false><<<blocks, kThreads, smem, st>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int m2m_decode_attention_cross_t(const void* args, int blocks,
                                            void* stream) {
    const CrossTArgs a = *static_cast<const CrossTArgs*>(args);
    if (a.n_keys < 1 || a.n_keys > kMaxCrossTKeys) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = cross_t_smem(a.n_keys);
    if (smem > 48 * 1024) {  // 34 KB at L = 190; above 48 KB only opted in
        const cudaError_t err = cudaFuncSetAttribute(
            decode_attention_cross_t_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    decode_attention_cross_t_kernel<<<blocks, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
