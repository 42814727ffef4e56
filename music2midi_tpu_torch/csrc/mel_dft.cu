// Log-mel front end as a direct DFT on the tensor cores, for Hopper (sm_90a).
//
// Replaces music2midi_tpu/ops/mel_pallas.py::log_mel_spectrogram_pallas
// (kernel _mel_kernel): the same log-mel as mel_fft.cu (center reflect pad,
// periodic Hann window, power spectrum, HTK mel, clamp, log), with the
// spectrum computed as the TPU kernel computes it: a matrix product of the
// windowed frames with the cos / sin basis at full fp32 precision
// (Precision.HIGHEST there).
//
// The product.  Frames are rows (M = B F, 12,032 at the serving shape).
// The periodic Hann window is symmetric, w_{N-n} = w_n, and so is the
// windowed basis under n -> N - n, so each frame x is folded:
//   e_n = x_n + x_{N-n},  o_n = x_n - x_{N-n}  (0 <= n < N/2)
//   Re_k = sum_{n < N/2} e_n w_n cos(2 pi n k / N) + (-1)^k w_{N/2} x_{N/2}
//   Im_k = -sum_{n < N/2} o_n w_n sin(2 pi n k / N)
// for the bins k < N/2 (w_0 = 0, so e_0's stray x_N adds nothing): K = N/2
// = 1024 against the windowed basis [w cos | w sin] of N = 2 x 1024
// columns (bin 0's sin column is zero).  The Nyquist bin N/2 (Re = sum_n
// (-1)^n w_n x_n, Im = 0) and the (-1)^k w_{N/2} x_{N/2} term are added on
// the CUDA cores.
//
// Precision: 3xTF32.  Each fp32 operand x is split into a TF32 high part
// hi = rna(x) and a TF32 low part lo = rna(x - hi), and the tensor cores
// sum lo*hi + hi*lo + hi*hi: the error of the dropped lo*lo term is
// ~2^-22 relative, fp32's own order.  The tensor cores truncate as they
// accumulate, so each 32-deep stage is summed in fresh accumulators and
// added to the running sums by ordinary (rounding) fp32 adds; summed on
// the tensor cores over the whole K, the log-mel missed the 1e-3 bar on
// noise.  One TF32 or bf16 pass would not be this function at this
// precision.  The basis is computed in float64,
// rounded to fp32 and split by the wrapper (ops/mel_cuda.py, 16 MB cached
// on the device); the frames are split as they are folded.
//
// Route: wgmma (m64n128k8 TF32) through inline PTX, A from registers, B
// from shared memory.  An mma.sync.m16n8k8 version was slower on an
// H100: with one CTA of 8 warps a SM, the fragment loads, splits and
// staging around each small product kept the warps issuing while the
// tensor cores waited.  No CuTe/CUTLASS headers: the
// build stays at seconds of nvcc.
//
// Tiles.  One CTA of two warpgroups per (chunk b, 64 consecutive frames):
// 3 CTAs per 188-frame chunk, 192 CTAs at the serving shape, one a SM
// (213 KB of shared memory).  Warpgroup 0 multiplies e by the cos columns,
// warpgroup 1 o by the sin columns of the same 128 bins, each over all 64
// rows (M = 64).  The CTA copies its frames' wave segment (63 hop + N + 1
// samples, reflect pad applied, skewed 4 words every 256 so that reads of
// 8 frames hop = 256 apart hit 8 banks) into shared memory once, then
// walks the 1024 bins in chunks of 128 and K in stages of 32.  Each basis
// stage (64 KB: cos, sin, hi, lo, in wgmma's K-major core matrices of
// 8 bins x 4 k) is one bulk copy (TMA) into a two-slot ring, issued by one
// thread a stage ahead and landing on the slot's mbarrier.  A is folded by
// each thread straight into its registers (wgmma's register operand);
// the wrapper orders each stage's K rows so that a thread's 16 values are
// 8 consecutive samples and 8 mirrored ones of each of its two frames,
// read 16 bytes at a time.  Per stage: 12 wgmma (4 k-steps x 3 passes)
// per warpgroup, then, while they run, the next stage's fold; wait; add.
// Epilogue per chunk: Re^2 and then Im^2 go into a 64 x 128 power tile in
// the ring slot just read, and the mel bins whose HTK triangle meets the
// chunk add its part of their sum into the CTA's own rows of the output
// (zeroed first; the chunk holding a triangle's first bin stores, a later
// one adds; the CTA alone writes them, in chunk order, so no atomics).
// The log is taken when the last chunk is done.  No frame or power tensor
// goes to device memory.
//
// Bound on the H100: the function is mel_fft.cu's, so its bound is a real
// FFT's operations, 0.79 GFLOP, 12 us at the 67 TFLOP/s fp32 rate
// (chip_smoke.py's bound_ms).  This algorithm does 3 TF32 passes of
// 2 M K N = 2 x 12,032 x 1024 x 2048 flops, 151 GFLOP: 0.31 ms at the
// 495 TFLOP/s dense TF32 rate (chip_smoke.py's algorithm_bound_ms).  With
// 192 CTAs of 64 frames on 132 SMs, 60 SMs run a second CTA, so the
// tensor cores' own least time here is 2 x 64 / (12,032 / 132) of that,
// 0.43 ms.  Measured times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // frames per CTA (wgmma's M)
constexpr int kBN = 128;       // bins per chunk (wgmma's N), cos and sin each
constexpr int kBK = 32;        // K per stage: four k-steps of 8
constexpr int kThreads = 256;  // two warpgroups
constexpr int kSlots = 2;      // basis stages in the ring: one in flight
constexpr int kCore = 32;      // words of one 8 x 4 core matrix
constexpr int kSplit = kBK / 4 * (kBN / 8) * kCore;  // one (kind, hi|lo) B tile
constexpr int kStageB = 4 * kSplit;                   // one basis stage
constexpr int kPP = kBN + 4;   // pitch of the power tile (column kBN: Nyquist)

// the wave segment of kBM frames, one pad of 4 words after every 256
__host__ __device__ inline int skew(int s) { return s + 4 * (s >> 8); }

__host__ __device__ inline int segment_words(int n_fft, int hop) {
    return (skew((kBM - 1) * hop + n_fft + 1) + 3) & ~3;
}

__host__ __device__ inline size_t dft_smem_words(int n_fft, int hop) {
    return kSlots * static_cast<size_t>(kStageB)    // B: slot x kind x hi|lo
           + segment_words(n_fft, hop)              // wave segment
           + n_fft                                  // window
           + 2 * kBM;  // Nyquist, xw_{N/2}; the power tile lives in a slot
}

__device__ __forceinline__ int reflect_index(int s, int n) {
    // torch reflect: x[-1] = x[1], x[n] = x[n - 2]; the caller guarantees
    // n > n_fft / 2, so one reflection always lands in range
    if (s < 0) s = -s;
    if (s >= n) s = 2 * (n - 1) - s;
    return s;
}

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// wait until the mbarrier at `bar` has completed the phase of `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// a K-major, unswizzled wgmma operand: 8-row core matrices of 16 bytes a
// row; lbo between the two core matrices of a k-step (K), sbo between
// 8-row groups (M or N)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
    const uint32_t a = smem_u32(p);
    return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
           | static_cast<uint64_t>(lbo >> 4) << 16
           | static_cast<uint64_t>(sbo >> 4) << 32;
}

// keeps the compiler from moving a register across the asynchronous
// products that read or write it
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// d (+)= a b on the tensor cores: m64n128k8, A (tf32) from registers in
// the m16n8k8 fragment layout of each warp's 16 rows, B (tf32, K-major,
// no swizzle) through its shared-memory descriptor; scale_d = 0 writes d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

__global__ void __launch_bounds__(kThreads, 1)
log_mel_dft_kernel(
    const float* __restrict__ wave,    // (B, S)
    float* __restrict__ out,           // (B, F, n_mels)
    const float* __restrict__ hann,    // (n_fft,)
    const float* __restrict__ basis,   // (n_chunks, K / kBK) stages of kStageB
    const int* __restrict__ lo,        // (n_mels,) first nonzero bin
    const int* __restrict__ hi,        // (n_mels,) one past the last
    const int* __restrict__ woff,      // (n_mels,) offset into wts
    const float* __restrict__ wts,     // concatenated triangle weights
    const int2* __restrict__ chunk_mels,  // (n_chunks,) mel bins meeting a chunk
    int S, int F, int n_fft, int hop, int n_mels, float log_floor) {
    extern __shared__ __align__(1024) float smem[];
    __shared__ __align__(8) uint64_t full[kSlots];  // a basis stage has landed
    const int K = n_fft / 2;
    const int n_chunks = K / kBN;
    const int n_stages = K / kBK;
    const uint32_t* Bsp = reinterpret_cast<const uint32_t*>(smem);  // [slot]
    float* wv = smem + kSlots * kStageB;                 // skewed wave segment
    float* win = wv + segment_words(n_fft, hop);         // (n_fft,)
    float* nyq = win + n_fft;                            // (kBM,)
    float* xmid = nyq + kBM;                             // (kBM,)

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int kind = warp >> 2;  // warpgroup 0: cos columns (e), 1: sin (o)
    const int wq = warp & 3;     // this warp's 16 rows of the 64
    const int f0 = blockIdx.x * kBM;
    const int b = blockIdx.y;
    const int nrows = min(kBM, F - f0);
    const float* x = wave + static_cast<int64_t>(b) * S;
    float* orow = out + (static_cast<int64_t>(b) * F + f0) * n_mels;

    // basis stage `it` (chunk it / n_stages, K rows kBK (it % n_stages)),
    // split and laid out by the wrapper as wgmma reads it, [cos|sin][hi|lo]
    // core matrices [k / 4][bin / 8][bin % 8][k % 4]: one bulk copy (TMA)
    // into ring slot it % kSlots, issued by one thread, landing on the
    // slot's mbarrier
    auto load_basis = [&](int it) {
        if (tid != 0) return;
        const uint32_t bar = smem_u32(&full[it % kSlots]);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(bar), "r"(kStageB * 4) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            ::"r"(smem_u32(smem + (it % kSlots) * kStageB)),
              "l"(basis + static_cast<int64_t>(it) * kStageB), "r"(kStageB * 4), "r"(bar)
            : "memory");
    };
    // this thread's A fragments of stage `it`, hi and lo.  The wrapper
    // orders each stage's 32 K rows so that thread t's k columns (t and
    // t + 4 of each k-step) are the stage's rows 8 t .. 8 t + 7, in the
    // order 2 k-step + (column >= 4): 8 consecutive samples of each of its
    // two frames (rows wq 16 + g and + 8) and 8 mirrored ones, read 16 bytes
    // at a time.  e or o by the warpgroup; the window is in the basis.
    const int r0 = 16 * wq + g;
    auto fold = [&](int it, uint32_t (&ah)[kBK / 8][4], uint32_t (&al)[kBK / 8][4]) {
        const int nb = kBK * (it % n_stages) + 8 * t;
#pragma unroll
        for (int rs = 0; rs < 2; ++rs) {
            const int s0 = (r0 + 8 * rs) * hop + nb;  // x_{nb .. nb + 7}
            const int m0 = s0 - 2 * nb + n_fft;       // x_{N - nb}, descending
            const float4 d0 = ld4(wv + skew(s0)), d1 = ld4(wv + skew(s0) + 4);
            const float4 e0 = ld4(wv + skew(m0 - 8)), e1 = ld4(wv + skew(m0 - 8) + 4);
            const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
            const float mv[8] = {wv[skew(m0)], e1.w, e1.z, e1.y, e1.x, e0.w, e0.z, e0.y};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float v = kind ? dv[j] - mv[j] : dv[j] + mv[j];
                split(v, ah[j >> 1][(j & 1) << 1 | rs], al[j >> 1][(j & 1) << 1 | rs]);
            }
        }
    };

    // the frames' wave segment (reflect pad; zero past the last frame) and
    // the window; the CTA's output rows zeroed for the mel sums
    const int base = f0 * hop - K;
    const int seg = (kBM - 1) * hop + n_fft + 1;
    for (int i = tid; i < seg; i += kThreads) {
        const int s = base + i;
        wv[skew(i)] = s < S + K ? x[reflect_index(s, S)] : 0.0f;
    }
    for (int i = tid; i < n_fft; i += kThreads) win[i] = hann[i];
    for (int i = tid; i < nrows * n_mels; i += kThreads) orow[i] = 0.0f;
    const int total = n_chunks * n_stages;
    if (tid == 0) {
        for (int i = 0; i < kSlots; ++i) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[i]))
                         : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    load_basis(0);
    __syncthreads();

    // Nyquist bin and the xw_{N/2} term, one warp per row
    for (int r = warp; r < kBM; r += kThreads / 32) {
        float acc = 0.0f;
        for (int n = lane; n < n_fft; n += 32) {
            const float v = win[n] * wv[skew(r * hop + n)];
            acc += (n & 1) ? -v : v;
        }
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) {
            nyq[r] = acc;
            xmid[r] = win[K] * wv[skew(r * hop + K)];
        }
    }
    uint32_t ah[kBK / 8][4], al[kBK / 8][4], nh[kBK / 8][4], nl[kBK / 8][4];
    fold(0, ah, al);

    float acc[64], st[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    for (int it = 0; it < total; ++it) {
        // basis stage it has landed; slot (it + 1) % kSlots was last read
        // by stage it - 1's products, which every warpgroup has waited
        // for, and written by the power tile, fenced here before the copy
        mbar_wait(smem_u32(&full[it % kSlots]), (it / kSlots) & 1);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (it + 1 < total) load_basis(it + 1);

        const uint32_t* bt = Bsp + (it % kSlots) * kStageB + kind * 2 * kSplit;
#pragma unroll
        for (int i = 0; i < 64; ++i) pin(st[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kBK / 8; ++ks) {
            const uint64_t dh = smem_desc(bt + 2 * ks * (kBN / 8) * kCore,
                                          (kBN / 8) * kCore * 4, kCore * 4);
            const uint64_t dl = smem_desc(bt + kSplit + 2 * ks * (kBN / 8) * kCore,
                                          (kBN / 8) * kCore * 4, kCore * 4);
            wgmma_tf32(st, al[ks], dh, ks);  // the small products first
            wgmma_tf32(st, ah[ks], dl, 1);
            wgmma_tf32(st, ah[ks], dh, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // meanwhile: stage it + 1's A
        if (it + 1 < total) fold(it + 1, nh, nl);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            pin(st[i]);
            acc[i] += st[i];
        }
#pragma unroll
        for (int ks = 0; ks < kBK / 8; ++ks)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                pin(ah[ks][i]);
                pin(al[ks][i]);
                ah[ks][i] = nh[ks][i];
                al[ks][i] = nl[ks][i];
            }

        if (it % n_stages == n_stages - 1) {
            // epilogue of chunk c: power tile, then the mel sums; the power
            // tile takes slot it % kSlots once both warpgroups are done
            // with it
            const int c = it / n_stages, c0 = c * kBN;
            float* P = smem + (it % kSlots) * kStageB;  // (kBM, kPP)
            __syncthreads();
            const bool last = c == n_chunks - 1;
            for (int pass = 0; pass < 2; ++pass) {
                if (kind == pass) {
#pragma unroll
                    for (int i = 0; i < 64; ++i) {
                        const int r = r0 + 8 * ((i >> 1) & 1);
                        const int j = 8 * (i >> 2) + 2 * t + (i & 1);
                        float v = acc[i];
                        if (pass == 0) {
                            v += (j & 1) ? -xmid[r] : xmid[r];  // c0 is even
                            P[r * kPP + j] = v * v;
                        } else {
                            P[r * kPP + j] += v * v;
                        }
                        acc[i] = 0.0f;
                    }
                }
                if (pass == 0 && last && tid < kBM) P[tid * kPP + kBN] = nyq[tid] * nyq[tid];
                __syncthreads();
            }
            const int cend = last ? K + 1 : c0 + kBN;
            const int2 mr = chunk_mels[c];
            const int nm = mr.y - mr.x;
            for (int i = tid; i < nrows * nm; i += kThreads) {
                const int r = i / nm, m = mr.x + i % nm;
                const int kl = max(lo[m], c0), kh = min(hi[m], cend);
                const float* w = wts + woff[m] - lo[m];
                const float* p = P + r * kPP - c0;
                float s = 0.0f;
                for (int k = kl; k < kh; ++k) s = fmaf(p[k], w[k], s);
                // the chunk that holds a triangle's first bin stores its
                // sum, a later one adds to it
                float* o = orow + r * n_mels + m;
                *o = lo[m] >= c0 ? s : *o + s;
            }
            __syncthreads();
        }
    }

    for (int i = tid; i < nrows * n_mels; i += kThreads) {
        orow[i] = logf(fmaxf(orow[i], log_floor));
    }
}

}  // namespace

extern "C" int m2m_log_mel_dft(
    const void* wave, void* out, const void* hann, const void* basis,
    const void* lo, const void* hi, const void* woff, const void* wts,
    const void* chunk_mels, int batch, int S, int F, int n_fft, int hop,
    int n_mels, float log_floor, void* stream) {
    if (n_fft % (2 * kBN) != 0 || S <= n_fft / 2) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = dft_smem_words(n_fft, hop) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        log_mel_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((F + kBM - 1) / kBM, batch);
    log_mel_dft_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(wave), static_cast<float*>(out),
        static_cast<const float*>(hann), static_cast<const float*>(basis),
        static_cast<const int*>(lo), static_cast<const int*>(hi),
        static_cast<const int*>(woff), static_cast<const float*>(wts),
        static_cast<const int2*>(chunk_mels), S, F, n_fft, hop, n_mels,
        log_floor);
    return static_cast<int>(cudaGetLastError());
}
