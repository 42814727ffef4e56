// Fused log-mel front end for Hopper (sm_90a).
//
// Replaces music2midi_tpu/ops/mel_pallas.py::log_mel_spectrogram_pallas_fft
// (kernel _mel_fft_kernel): center reflect pad -> hop framing -> periodic
// Hann window -> n_fft-point real FFT -> power -> HTK mel projection ->
// clamp -> log, with no frame, spectrum or power tensor in device memory.
//
// The n_fft-point real FFT runs as an M = n_fft / 2 point complex FFT of
// the packed frame z[m] = x[2m] + i x[2m+1], followed by the standard
// split step that recovers bins 0..M of the real transform.  All
// arithmetic is fp32; the window and every twiddle come from float64 host
// tables rounded to fp32 (ops/mel_cuda.py::_tables, _fft_twiddles).  The
// kernel is a template on n_fft, one instance for each power of two from
// 256 to 4096 (the serving config's is 2048).
//
// Design.  A CTA takes kFrames consecutive frames of one chunk, one warp a
// frame, so the grid is ceil(F / 8) x B (1536 CTAs at 64 x 48000, not one
// CTA a frame):
//   * the CTA loads the union of its frames' samples once, (kFrames - 1)
//     hop + n_fft of them, coalesced, reflecting at the chunk's two edges
//     by index, and the window and twiddle tables once;
//   * each warp runs its M points as R1 x 32 (four-step; R1 = M / 32, 32
//     at n_fft 2048): lane m2 holds z[32 m1 + m2] for every m1 in
//     registers and runs an R1-point radix-2 FFT on them (twiddles
//     broadcast from shared memory), multiplies by W_M^(m2 k1) from an
//     R1 x 32 table, one transpose through a padded (conflict-free)
//     shared buffer gives lane k1 (and k1 + 32, ... where R1 > 32) every
//     m2, and a 32-point FFT leaves Z[k1 + R1 k2] in lane k1: two
//     exchanges in all, each behind a __syncwarp, none behind a block
//     barrier; where R1 < 32, lanes R1..31 sit out the second pass;
//   * the spectrum goes back into the same buffer, the split step reads
//     Z[k] and Z[M - k] there and writes the power row over it; after one
//     block barrier every thread sums (frame, mel) outputs over the
//     nonzero span of the mel's triangle and stores the (kFrames, n_mels)
//     tile coalesced.
//
// Bound on the H100: at the serving shape (64 chunks x 48000 samples, 188
// frames, 384 mels) the function moves 30.8 MB (wave in, mels out), ~9 us
// at 3.35 TB/s, and does 0.79 GFLOP of fp32 work (the real FFT's
// 2.5 N log2 N per frame, plus window, power and mel sums), ~12 us at the
// 67 TFLOP/s fp32 (non-tensor-core) rate, so operations bound it, just
// ahead of the memory; the kernel issues several instructions a flop
// (shared-memory twiddles and exchanges, the mel spans), see PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 32;              // lanes a frame; the second pass's points
constexpr int kFrames = 8;          // frames a CTA, one warp each
constexpr int kThreads = 32 * kFrames;
constexpr int kPitch = kR + 1;      // the transpose's row pitch, floats

__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }

// The shape of the n_fft = N point transform
template <int N>
struct Fft {
    static constexpr int M = N / 2;          // packed complex points
    static constexpr int R1 = M / kR;        // the first pass's points a lane
    static constexpr int Cols = R1 > kR ? R1 / kR : 1;  // second-pass columns a lane
    static constexpr int Buf = 2 * R1 * kPitch;  // a warp's buffer, floats
    static_assert(N >= 256 && N <= 4096 && (N & (N - 1)) == 0, "n_fft");
};

__device__ __forceinline__ int reflect_index(int s, int n) {
    // jnp.pad / torch reflect: x[-1] = x[1], x[n] = x[n - 2]; the caller
    // guarantees n > n_fft / 2, so one reflection always lands in range
    if (s < 0) s = -s;
    if (s >= n) s = 2 * (n - 1) - s;
    return s;
}

// the Bits low bits of i reversed, folded at compile time in unrolled
// loops (a register array indexed at run time would go to local memory)
template <int Bits>
__host__ __device__ constexpr int brev(int i) {
    int r = 0;
    for (int b = 0; b < Bits; ++b) r |= ((i >> b) & 1) << (Bits - 1 - b);
    return r;
}

// t e^{-i theta} for w = (cos theta, sin theta)
__device__ __forceinline__ float2 turn(float2 t, float2 w) {
    return make_float2(t.x * w.x + t.y * w.y, t.y * w.x - t.x * w.y);
}

// P-point radix-2 DIT FFT in registers: v in bit-reversed order on entry,
// natural order on exit; W_P^j = tw[j N / P] (tw: W_N^k, k < N / 2)
template <int P, int N>
__device__ __forceinline__ void fft(float2 (&v)[P], const float2* tw) {
#pragma unroll
    for (int len = 2; len <= P; len <<= 1) {
        const int half = len >> 1;
#pragma unroll
        for (int j = 0; j < half; ++j) {
            const float2 w = tw[j * (N / len)];
#pragma unroll
            for (int i = 0; i < P; i += len) {
                const float2 u = v[i + j];
                // W^0 = 1 and W^(len / 4) = -i exactly; the table's cos of
                // pi / 2 is 6e-17, not 0
                const float2 b = v[i + j + half];
                const float2 t = j == 0 ? b
                    : 4 * j == len ? make_float2(b.y, -b.x) : turn(b, w);
                v[i + j] = make_float2(u.x + t.x, u.y + t.y);
                v[i + j + half] = make_float2(u.x - t.x, u.y - t.y);
            }
        }
    }
}

// dynamic shared floats: twiddles, R1 x 32 twiddles, window, the frames'
// samples, one buffer a warp
template <int N>
__host__ __device__ inline int mel_fft_smem_floats(int hop) {
    const int span = ((kFrames - 1) * hop + N + 3) & ~3;
    return 2 * Fft<N>::M + 2 * Fft<N>::R1 * kR + N + span + kFrames * Fft<N>::Buf;
}

template <int N>
__global__ void __launch_bounds__(kThreads, N > 2048 ? 1 : 2) log_mel_fft_kernel(
    const float* __restrict__ wave,    // (B, S)
    float* __restrict__ out,           // (B, F, n_mels)
    const float* __restrict__ hann_g,  // (n_fft,)
    const float2* __restrict__ tw_g,   // (M,) (cos, sin) of 2 pi k / n_fft
    const float2* __restrict__ tw2_g,  // (R1, 32): [k1][m2] W_M^(m2 k1)
    const int* __restrict__ lo,        // (n_mels,) first nonzero bin
    const int* __restrict__ hi,        // (n_mels,) one past the last
    const int* __restrict__ woff,      // (n_mels,) offset into wts
    const float* __restrict__ wts,     // concatenated triangle weights
    int S, int F, int hop, int n_mels, float log_floor) {
    constexpr int kM = Fft<N>::M, kR1 = Fft<N>::R1, kBuf = Fft<N>::Buf;
    extern __shared__ __align__(16) float smem[];
    float2* tw = reinterpret_cast<float2*>(smem);
    float2* tw2 = tw + kM;
    float* hann = reinterpret_cast<float*>(tw2 + kR1 * kR);
    float* span = hann + N;
    float* bufs = span + (((kFrames - 1) * hop + N + 3) & ~3);

    const int b = blockIdx.y, f0 = blockIdx.x * kFrames;
    const int nf = min(kFrames, F - f0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* x = wave + static_cast<int64_t>(b) * S;
    const int base = f0 * hop - N / 2;

    for (int i = tid; i < kM / 2; i += kThreads) {
        reinterpret_cast<float4*>(tw)[i] = __ldg(reinterpret_cast<const float4*>(tw_g) + i);
    }
    for (int i = tid; i < kR1 * kR / 2; i += kThreads) {
        reinterpret_cast<float4*>(tw2)[i] = __ldg(reinterpret_cast<const float4*>(tw2_g) + i);
    }
    for (int i = tid; i < N / 4; i += kThreads) {
        reinterpret_cast<float4*>(hann)[i] = __ldg(reinterpret_cast<const float4*>(hann_g) + i);
    }
    for (int i = tid; i < (nf - 1) * hop + N; i += kThreads) {
        span[i] = __ldg(x + reflect_index(base + i, S));
    }
    __syncthreads();

    if (warp < nf) {
        float* buf = bufs + warp * kBuf;
        const float* xf = span + warp * hop;
        {
            // z[32 m1 + lane], windowed, at the bit-reversed place of m1
            float2 v[kR1];
#pragma unroll
            for (int m1 = 0; m1 < kR1; ++m1) {
                const int n0 = 64 * m1 + 2 * lane;
                const float2 s2 = *reinterpret_cast<const float2*>(xf + n0);
                const float2 h2 = *reinterpret_cast<const float2*>(hann + n0);
                v[brev<ilog2(kR1)>(m1)] = make_float2(s2.x * h2.x, s2.y * h2.y);
            }
            fft<kR1, N>(v, tw);  // v[k1] = sum_m1 z[32 m1 + lane] W_R1^(m1 k1)
#pragma unroll
            for (int k1 = 1; k1 < kR1; ++k1) v[k1] = turn(v[k1], tw2[k1 * kR + lane]);
            // transpose: row k1 holds every m2's value of its k1
#pragma unroll
            for (int k1 = 0; k1 < kR1; ++k1) {
                buf[k1 * kPitch + lane] = v[k1].x;
                buf[(kR1 + k1) * kPitch + lane] = v[k1].y;
            }
        }
        __syncwarp();
        // lane takes the rows k1 = lane + 32 c: Z[k1 + R1 k2] = u[c][k2]
        float2 u[Fft<N>::Cols][kR];
#pragma unroll
        for (int c = 0; c < Fft<N>::Cols; ++c) {
            const int k1 = lane + kR * c;
            if (k1 < kR1) {
#pragma unroll
                for (int m2 = 0; m2 < kR; ++m2) {
                    u[c][brev<5>(m2)] = make_float2(buf[k1 * kPitch + m2],
                                                    buf[(kR1 + k1) * kPitch + m2]);
                }
                fft<kR, N>(u[c], tw);
            }
        }
        __syncwarp();
        float2* z = reinterpret_cast<float2*>(buf);
#pragma unroll
        for (int c = 0; c < Fft<N>::Cols; ++c) {
            const int k1 = lane + kR * c;
            if (k1 < kR1) {
#pragma unroll
                for (int k2 = 0; k2 < kR; ++k2) z[k1 + kR1 * k2] = u[c][k2];
            }
        }
        __syncwarp();
        // split step: X[k] = (A + W^k (-i) B) / 2 with A = Z[k] + conj
        // Z[M-k], B = Z[k] - conj Z[M-k]; k = M uses Z[0] and W^M = -1.
        // Where R1 >= 32 lane k1 holds Z[k] for its k = lane + 32 j
        float pw[kR1];
#pragma unroll
        for (int j = 0; j < kR1; ++j) {
            constexpr int kCols = Fft<N>::Cols;
            const int k = lane + kR * j;
            const float2 zk = kR1 >= kR ? u[j % kCols][j / kCols] : z[k];
            const float2 zm = z[(kM - k) & (kM - 1)];
            const float ar = zk.x + zm.x, ai = zk.y - zm.y;
            const float br = zk.x - zm.x, bi = zk.y + zm.y;
            const float c = tw[k].x, s = tw[k].y;
            const float xr = 0.5f * (ar + bi * c - br * s);
            const float xi = 0.5f * (ai - bi * s - br * c);
            pw[j] = xr * xr + xi * xi;
        }
        float nyquist = 0.0f;
        if (lane == 0) {
            const float2 z0 = z[0];
            const float ar = z0.x + z0.x, ai = z0.y - z0.y;
            const float br = z0.x - z0.x, bi = z0.y + z0.y;
            const float xr = 0.5f * (ar + bi * -1.0f - br * 0.0f);
            const float xi = 0.5f * (ai - bi * 0.0f - br * -1.0f);
            nyquist = xr * xr + xi * xi;
        }
        __syncwarp();
        float* power = buf;  // (M + 1,)
#pragma unroll
        for (int j = 0; j < kR1; ++j) power[lane + kR * j] = pw[j];
        if (lane == 0) power[kM] = nyquist;
    }
    __syncthreads();

    // mel sums over each triangle's nonzero span, every frame of the tile
    // at once (a weight read once for all of them), then clamp and log
    float* o = out + (static_cast<int64_t>(b) * F + f0) * n_mels;
    for (int m = tid; m < n_mels; m += kThreads) {
        const int l = __ldg(lo + m), h = __ldg(hi + m);
        const float* w = wts + __ldg(woff + m) - l;
        float acc[kFrames];
#pragma unroll
        for (int fr = 0; fr < kFrames; ++fr) acc[fr] = 0.0f;
        for (int k = l; k < h; ++k) {
            const float wk = __ldg(w + k);
#pragma unroll
            for (int fr = 0; fr < kFrames; ++fr) {
                acc[fr] = fmaf(bufs[fr * kBuf + k], wk, acc[fr]);
            }
        }
#pragma unroll
        for (int fr = 0; fr < kFrames; ++fr) {
            if (fr < nf) o[fr * n_mels + m] = logf(fmaxf(acc[fr], log_floor));
        }
    }
}

template <int N>
int launch(const void* wave, void* out, const void* hann, const void* tw,
           const void* tw2, const void* lo, const void* hi, const void* woff,
           const void* wts, int batch, int S, int F, int hop, int n_mels,
           float log_floor, cudaStream_t stream) {
    // 105 KB at n_fft 2048, hop 256: two CTAs an SM, above 48 KB only so
    // opted in
    const int smem = mel_fft_smem_floats<N>(hop) * static_cast<int>(sizeof(float));
    static int opted = 0;
    if (smem > opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            log_mel_fft_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted = smem;
    }
    dim3 grid((F + kFrames - 1) / kFrames, batch);
    log_mel_fft_kernel<N><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(wave), static_cast<float*>(out),
        static_cast<const float*>(hann), static_cast<const float2*>(tw),
        static_cast<const float2*>(tw2), static_cast<const int*>(lo),
        static_cast<const int*>(hi), static_cast<const int*>(woff),
        static_cast<const float*>(wts), S, F, hop, n_mels, log_floor);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int m2m_log_mel_fft(
    const void* wave, void* out, const void* hann, const void* tw,
    const void* tw2, const void* lo, const void* hi, const void* woff,
    const void* wts, int batch, int S, int F, int n_fft, int hop, int n_mels,
    float log_floor, void* stream) {
    if (hop < 1 || S <= n_fft / 2) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define M2M_MEL_FFT(N) \
    case N: \
        return launch<N>(wave, out, hann, tw, tw2, lo, hi, woff, wts, batch, S, F, \
                         hop, n_mels, log_floor, st);
    switch (n_fft) {
        M2M_MEL_FFT(256)
        M2M_MEL_FFT(512)
        M2M_MEL_FFT(1024)
        M2M_MEL_FFT(2048)
        M2M_MEL_FFT(4096)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef M2M_MEL_FFT
}
