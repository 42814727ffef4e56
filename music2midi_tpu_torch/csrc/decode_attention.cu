// Decode-step attention over int8 K/V caches for Hopper (sm_90a).
//
// Two kernels:
//
//   decode_attention_int8_kernel<Q, RoundPV> replaces
//     music2midi_tpu/ops/decode_attention.py::decode_attention_int8
//     (kernel _kernel): scores = (q . k8_l) ks_l in f32, plus the
//     relative-position bias and keys <= step (causal; key `step` taken
//     from this step's fresh quantized row) or keys < enc_len (cross);
//     f32 softmax; out = sum_l (p_l vs_l) v8_l in f32, rounded to Q.
//     Q is the query's and the output's type.  For Q = bf16, RoundPV =
//     false is the TPU kernel's arithmetic, and RoundPV = true rounds
//     each p_l vs_l to bf16 before the PV pass (the fresh row's too), the
//     arithmetic of music2midi_tpu/models/t5.py::_attention_int8, which
//     the JAX engine serves with and so the port's engine too.  Q = float
//     is that function in an fp32 engine with int8 KV: q, p_l vs_l and the
//     output stay f32 (rounding p_l vs_l to f32 is a no-op, so there is
//     one instance).  The +-7-level values of a 4-bit cache are int8 too.
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
// At the serving batch (B 64 x H 8 = 512 (b, h) pairs) one CTA per pair is
// one wave of 4 CTAs an SM, so a call takes one CTA's chain of latencies,
// and its speed at long key ranges is the bytes it keeps in flight.
//
// The int8 kernel, one CTA of 256 threads per (b, h):
//   * it requests first whatever waits on nothing: q (into shared memory),
//     each thread's first K row (one key a thread, four 16-byte loads),
//     and the scale and bias rows of every visible key into shared memory
//     by cp.async (16 bytes a copy where a row is contiguous), the latter
//     waited for only after the first keys' dot products;
//   * the next K row is in flight while a thread sums its key's; the
//     first group of V rows is asked for after the last K row, so it lands
//     during the softmax; V rows come through registers in groups of two
//     16-byte pieces a thread (four threads a key, 16 dims each), each
//     group's loads in flight while the group before is summed; key
//     `step`'s rows and scales come from the fresh rows;
//   * int8 unpacks on the ALU (unpack4); the output's sum over a warp's
//     keys halves its values at each level (14 shuffles a lane, not 48).
// The scores and the softmax are summed in the order of the plain route
// that the engine's tokens are held against on the card, models/t5.py::
// _attention_int8 (cuBLAS's f32 matmul and torch.softmax, read off the
// card by tools/c1_orders.py): q . k in four strided sums met as
// (0 + 2) + (1 + 3), and the softmax's sum with lane i of one warp adding
// keys i, i + 32, ... and the lanes meeting by a butterfly.  So where
// cuBLAS takes that order (every prefix length at 256 (b, h) rows; it
// takes another at some widths, such as two halves over a 1024-key prefix
// at 512 rows) the rounded p vs of both routes are equal bit for bit; the
// PV sums keep their own order.  What bounds it: at short n the chain (a 512-CTA
// launch, one trip to memory, the barriers, the output's reduction); at
// long n the rows in flight a thread (PERF.md).  Tried on the card and
// dropped: a split of long key ranges over a thread-block cluster, and a
// ring of key tiles in shared memory fed by cp.async or TMA bulk copies.

// The transposed kernel: its rows are padded to 16 bytes
// (ops/decode_attention.py::transpose_cross_entry), so at the start the
// CTA issues every 16-byte cp.async of its K tile and then of its V tile
// (2 x 64 x 192 bytes at L = 190) into shared memory, and the V bytes
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
constexpr int kMaxKeys = 4096;  // ops/decode_attention.py's MAX_KEYS
constexpr int kUnroll = 2;  // the int8 kernel's 16-byte loads in flight a thread
constexpr int kMinBlocks = 4;  // CTAs an SM the int8 kernel is built for

// field order and types match the ctypes structures of
// music2midi_tpu_torch/ops/decode_attention.py
struct Int8AttnArgs {
    const void* q;           // [b q_sb + h q_sh + d], bf16 or f32 (q_f32)
    const int8_t* k;         // [b k_sb + h k_sh + l k_sl + d]
    const int8_t* v;
    const float* ks;         // [b ks_sb + h ks_sh + l ks_sl]
    const float* vs;
    const float* bias;       // [h bias_sh + l bias_sl] (causal)
    const int8_t* kn;        // fresh rows [b kn_sb + h kn_sh + d] (causal)
    const int8_t* vn;
    const float* kns;        // their scales [b kns_sb + h kns_sh]
    const float* vns;
    const int* step;         // this step's position, in device memory (causal)
    void* out;               // (B, H, D) contiguous, q's type
    int64_t q_sb, q_sh, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl;
    int64_t ks_sb, ks_sh, ks_sl, vs_sb, vs_sh, vs_sl, bias_sh, bias_sl;
    int64_t kn_sb, kn_sh, vn_sb, vn_sh, kns_sb, kns_sh, vns_sb, vns_sh;
    // cross: the visible keys; causal: the keys the cache holds, so that
    // step < n_keys, and the bias row's length, key j of step s at
    // column n_keys - s - 1 + j
    int H, n_keys, causal, round_pv, q_f32;
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

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// 16 bytes of global memory into registers, asked for now (a volatile
// asm keeps the load where it is written)
__device__ __forceinline__ uint4 load16(const void* p) {
    uint4 r;
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
    return r;
}

// the 16 signed bytes of a 16-byte word as floats
__device__ __forceinline__ void unpack16(const uint4 w, float* x) {
    unpack4(w.x, x);
    unpack4(w.y, x + 4);
    unpack4(w.z, x + 8);
    unpack4(w.w, x + 12);
}

// one level of a halving warp reduction over v[0, 2 H): a lane keeps the
// half `upper` names, sends the other to lane ^ `mask`, and adds what it
// gets: v[i] = kept[i] + partner's kept[i] for i < H
template <int H>
__device__ __forceinline__ void halve(float* v, int upper, int mask) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, mask);
    }
}

// n floats of a row at stride `sl` into shared memory by cp.async: 16
// bytes a copy where the row is contiguous and aligned (the remainder,
// under four floats, 4 bytes a copy), else 4 bytes a copy; every thread of
// the block takes part
__device__ __forceinline__ void copy_row(float* dst, const float* src, int64_t sl,
                                         int n) {
    const int i = threadIdx.x;
    if (sl == 1 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int k = 4 * i; k + 4 <= n; k += 4 * kThreads) cp_async16(dst + k, src + k);
        const int k = (n & ~3) + i;
        if (k < n) cp_async4(dst + k, src + k);
    } else {
        for (int k = i; k < n; k += kThreads) cp_async4(dst + k, src + k * sl);
    }
}

// a float as the output type
template <typename Q>
__device__ __forceinline__ Q to_out(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float to_out<float>(float x) {
    return x;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// q . k over the 64 dims of one key (row: its 64 int8 bytes, q: 64 floats
// in shared memory), in the order of the plain route's f32 matmul on the
// H100 (cuBLAS; tools/c1_orders.py): four sums over the dims d = i mod 4,
// each in d's order, met as (0 + 2) + (1 + 3)
__device__ __forceinline__ float dot64(const uint4* row, const float* q) {
    const unsigned w[16] = {row[0].x, row[0].y, row[0].z, row[0].w, row[1].x, row[1].y,
                            row[1].z, row[1].w, row[2].x, row[2].y, row[2].z, row[2].w,
                            row[3].x, row[3].y, row[3].z, row[3].w};
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        float x[4];
        unpack4(w[i], x);
        const float4 qv = reinterpret_cast<const float4*>(q)[i];
        p0 = fmaf(x[0], qv.x, p0);
        p1 = fmaf(x[1], qv.y, p1);
        p2 = fmaf(x[2], qv.z, p2);
        p3 = fmaf(x[3], qv.w, p3);
    }
    return (p0 + p2) + (p1 + p3);
}

template <typename Q, bool RoundPV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_attention_int8_kernel(const Int8AttnArgs a) {
    // (n,) each: scores (then exp(score - max)), k scales, v scales, bias
    extern __shared__ __align__(16) float s[];
    __shared__ float red_max[kWarps], red_sum[kWarps];
    __shared__ float part[kWarps][kD];
    __shared__ __align__(16) float q_s[kD];

    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int c = tid & 3;   // this thread's 16 of the 64 dims
    const int j = tid >> 2;  // and its key of every 64
    const bool causal = a.causal != 0;
    // the step is read here, so that a captured launch follows it: keys
    // 0..step are visible; a step outside the cache writes NaN, which the
    // caller's output then shows
    const int step = causal ? __ldg(a.step) : -1;
    if (causal && (step < 0 || step >= a.n_keys)) {
        if (tid < kD) {
            static_cast<Q*>(a.out)[static_cast<int64_t>(blockIdx.x) * kD + tid] =
                to_out<Q>(__int_as_float(0x7fc00000));
        }
        return;
    }
    const int n = causal ? step + 1 : a.n_keys, np = (n + 3) & ~3;
    float* ks_s = s + np;
    float* vs_s = ks_s + np;
    float* bias_s = vs_s + np;
    // group g's V loads: for u < kUnroll, this thread's 16-byte piece of
    // the row of key 64 (kUnroll g + u) + tid / 4 (key `step`'s from the
    // fresh row)
    auto load_v = [&](int base, uint4* row) {
        const int8_t* rows = a.v + b * a.v_sb + h * a.v_sh;
        const int8_t* fresh = causal ? a.vn + b * a.vn_sb + h * a.vn_sh : nullptr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int l = base + 64 * u + j;
            if (l < n) row[u] = load16((causal && l == step ? fresh : rows + l * a.v_sl) + 16 * c);
        }
    };

    // first every request that does not wait on another: q, this
    // thread's first K row, and the scale and bias rows into shared memory
    if (tid < kD) {
        q_s[tid] = to_float(static_cast<const Q*>(a.q)[b * a.q_sb + h * a.q_sh + tid]);
    }
    const int8_t* krows = a.k + b * a.k_sb + h * a.k_sh;
    const int8_t* kfresh = causal ? a.kn + b * a.kn_sb + h * a.kn_sh : nullptr;
    // key l's whole K row, four 16-byte loads (key `step`'s from the
    // fresh row)
    auto load_k = [&](int l, uint4* row) {
        const int8_t* p = causal && l == step ? kfresh : krows + l * a.k_sl;
#pragma unroll
        for (int i = 0; i < 4; ++i) row[i] = load16(p + 16 * i);
    };
    uint4 cur[4], nxt[4];
    if (tid < n) load_k(tid, cur);
    copy_row(ks_s, a.ks + b * a.ks_sb + h * a.ks_sh, a.ks_sl, n);
    copy_row(vs_s, a.vs + b * a.vs_sb + h * a.vs_sh, a.vs_sl, n);
    if (causal) {
        copy_row(bias_s, a.bias + h * a.bias_sh + (a.n_keys - n) * a.bias_sl, a.bias_sl, n);
    }
    cp_async_commit();
    // key `step`'s scales from the fresh scales (the rows copied above hold
    // that key's cache entry)
    const float kn_scale = causal ? a.kns[b * a.kns_sb + h * a.kns_sh] : 0.0f;
    const float vn_scale = causal ? a.vns[b * a.vns_sb + h * a.vns_sh] : 0.0f;
    __syncthreads();  // q_s

    // scores: one thread a key (keys tid + 256 i), the next key's row in
    // flight while this one is summed; the scale and bias rows are waited
    // for after the first keys' dot products
    float m = -INFINITY;
    for (int base = 0; base < n; base += kThreads) {
        const int l = base + tid;
        if (l + kThreads < n) load_k(l + kThreads, nxt);
        float acc = 0.0f;
        if (l < n) acc = dot64(cur, q_s);
        if (base == 0) {
            cp_async_wait<0>();
            __syncthreads();
        }
        if (l < n) {
            float sc = acc * (causal && l == step ? kn_scale : ks_s[l]);
            if (causal) sc += bias_s[l];
            s[l] = sc;
            m = fmaxf(m, sc);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
    }
    uint4 vcur[kUnroll], vnxt[kUnroll];
    load_v(0, vcur);  // the first V group lands during the softmax

    m = warp_max(m);
    if (lane == 0) red_max[warp] = m;
    __syncthreads();
    m = red_max[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_max[w]);
    for (int l = tid; l < n; l += kThreads) s[l] = expf(s[l] - m);
    __syncthreads();
    // the sum in torch.softmax's order: lane i of one warp adds keys
    // i, i + 32, ... in turn, then the lanes meet by a butterfly
    if (warp == 0) {
        float part_sum = 0.0f;
        for (int l = lane; l < n; l += 32) part_sum += s[l];
        part_sum = warp_sum(part_sum);
        if (lane == 0) red_sum[0] = part_sum;
    }
    __syncthreads();
    const float sum = red_sum[0];

    // out[d] = sum_l (p_l vs_l) v8[l][d]: thread (keys tid / 4 + 64 i,
    // dims c)
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
    for (int base = 0; base < n; base += 64 * kUnroll) {
        if (base + 64 * kUnroll < n) load_v(base + 64 * kUnroll, vnxt);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int l = base + 64 * u + j;
            if (l < n) {
                const float pv = s[l] / sum * (causal && l == step ? vn_scale : vs_s[l]);
                const float w = RoundPV ? bf16_round(pv) : pv;
                float x[16];
                unpack16(vcur[u], x);
#pragma unroll
                for (int i = 0; i < 16; ++i) acc[i] = fmaf(w, x[i], acc[i]);
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) vcur[u] = vnxt[u];
    }
    // sum the warp's eight keys (lanes with the same c) by halving: at the
    // level of lane bit 2 + k each lane keeps half of its sums and adds
    // its partner's, 14 shuffles in all where an all-reduce takes 48 (the
    // same additions in the same order); lane (c, g) ends with dims
    // 16 c + 2 rev3(g) + {0, 1}; then the warps
    halve<8>(acc, lane & 4, 4);
    halve<4>(acc, lane & 8, 8);
    halve<2>(acc, lane & 16, 16);
    const int d0 = 16 * c + 8 * ((lane >> 2) & 1) + 4 * ((lane >> 3) & 1)
        + 2 * ((lane >> 4) & 1);
    part[warp][d0] = acc[0];
    part[warp][d0 + 1] = acc[1];
    __syncthreads();
    if (tid < kD) {
        float o = 0.0f;
        for (int w = 0; w < kWarps; ++w) o += part[w][tid];
        static_cast<Q*>(a.out)[static_cast<int64_t>(blockIdx.x) * kD + tid] = to_out<Q>(o);
    }
}

// dynamic shared memory up to `bytes` (above 48 KB only so opted in);
// once per kernel
template <typename Kernel>
bool allow_smem(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes)) == cudaSuccess;
}

int launch_int8(const Int8AttnArgs& a, int pairs, void* stream) {
    if (a.n_keys < 1 || a.n_keys > kMaxKeys) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    // the score, scale and bias rows of the most keys a launch can see
    // (the cache's length for the causal kernel, which reads its step on
    // the card): 16 KB at 1024 keys, 64 at MAX_KEYS
    const size_t smem = 4 * static_cast<size_t>((a.n_keys + 3) & ~3) * sizeof(float);
    static const bool opted =
        allow_smem(decode_attention_int8_kernel<__nv_bfloat16, false>, 16 * kMaxKeys)
        && allow_smem(decode_attention_int8_kernel<__nv_bfloat16, true>, 16 * kMaxKeys)
        && allow_smem(decode_attention_int8_kernel<float, false>, 16 * kMaxKeys);
    if (!opted) return static_cast<int>(cudaErrorInvalidValue);
    if (a.q_f32) {
        decode_attention_int8_kernel<float, false><<<pairs, kThreads, smem, st>>>(a);
    } else if (a.round_pv) {
        decode_attention_int8_kernel<__nv_bfloat16, true><<<pairs, kThreads, smem, st>>>(a);
    } else {
        decode_attention_int8_kernel<__nv_bfloat16, false><<<pairs, kThreads, smem, st>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxCrossTKeys = 1024;  // ops/decode_attention.py's MAX_CROSS_T_KEYS

// shared bytes of the transposed kernel for n keys: K and V tiles (64 rows
// of `keys + 16` bytes), the eight warps' partial scores, the score row and
// the two scale rows
__host__ __device__ inline size_t cross_t_smem(int n) {
    const size_t np = (n + 15) & ~15;
    return 2 * kD * (np + 16) + (kWarps + 3) * np * sizeof(float);
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

// One launch of the int8 kernel: the argument block with the fields that
// stay fixed over a generation (ops/decode_attention.py packs it once per
// cache buffer), and what moves from call to call: q, and for the causal
// kernel this step's fresh rows and the address of the step, an int32 in
// device memory that the kernel reads, so that a CUDA graph that captured
// the launch follows the step as the decode loop advances it.
extern "C" int m2m_decode_attention_int8(
    const void* args, int pairs, const void* q, long long q_sb, long long q_sh,
    const void* kn, const void* vn, const void* kns, const void* vns,
    const void* step, void* stream) {
    Int8AttnArgs a = *static_cast<const Int8AttnArgs*>(args);
    a.q = q;
    a.q_sb = q_sb;
    a.q_sh = q_sh;
    if (a.causal) {
        if (step == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        a.kn = static_cast<const int8_t*>(kn);
        a.vn = static_cast<const int8_t*>(vn);
        a.kns = static_cast<const float*>(kns);
        a.vns = static_cast<const float*>(vns);
        a.step = static_cast<const int*>(step);
    }
    return launch_int8(a, pairs, stream);
}

extern "C" int m2m_decode_attention_cross_t(const void* args, int blocks,
                                            void* stream) {
    const CrossTArgs a = *static_cast<const CrossTArgs*>(args);
    if (a.n_keys < 1 || a.n_keys > kMaxCrossTKeys) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = cross_t_smem(a.n_keys);  // 34 KB at L = 190
    static const bool opted = allow_smem(decode_attention_cross_t_kernel,
                                         cross_t_smem(kMaxCrossTKeys));
    if (!opted) return static_cast<int>(cudaErrorInvalidValue);
    decode_attention_cross_t_kernel<<<blocks, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
