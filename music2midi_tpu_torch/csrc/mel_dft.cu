// Log-mel front end as a direct DFT, for Hopper (sm_90a).
//
// Replaces music2midi_tpu/ops/mel_pallas.py::log_mel_spectrogram_pallas
// (kernel _mel_kernel): the same log-mel as mel_fft.cu (center reflect pad,
// periodic Hann window, power spectrum, HTK mel, clamp, log), but each
// spectrum bin is the dot product of the windowed frame with the cos and
// -sin basis, as the TPU kernel computes it with its windowed basis
// matrices.  The TPU kernel's framing trick (hop-row tiles, hop | n_fft) is
// a layout for its matrix unit; here a block reads its frames straight
// from the wave.
//
// Design.  One block per (chunk, tile of kFrames consecutive frames).  The
// windowed frames go to shared memory interleaved as x[n][f], so one pair
// of float4 loads gives sample n of all eight frames.  The basis is a
// table of cos / sin(2 pi m / n_fft), m < n_fft (float64 on the host,
// rounded to float32), indexed by (n k) mod n_fft, so every basis value is
// the correctly rounded one.  Thread t computes bins t, t + blockDim, ...
// for the eight frames at once: per sample one table load, two frame loads
// and sixteen FMAs.  Power goes to shared memory; each mel bin then sums
// its triangle's nonzero span with the float32 filterbank weights.
//
// Shared memory: 8 n_fft (table) + 4 kFrames n_fft (frames)
// + 4 kFrames (n_fft / 2 + 1) (power) bytes: 112 KB at n_fft 2048, so the
// launch raises the block's dynamic shared-memory limit first.
//
// Bound on the H100: the function is the one mel_fft.cu computes, so its
// bound is the same, set by a real FFT's operations: 0.79 GFLOP at the
// serving shape (64 x 48000, 12,032 frames), 12 us at the 67 TFLOP/s fp32
// rate (chip_smoke.py's bound_ms).  The direct-DFT algorithm itself does
// 4 n_fft (n_fft / 2 + 1) fp32 flops a frame (cos and sin halves, a
// multiply-add each), 8.4 MFLOP at n_fft 2048 and 101 GFLOP in all, some
// 130x more: 1.5 ms at the fp32 rate is the least this algorithm can take
// (chip_smoke.py's algorithm_bound_ms).  Measured times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 8;     // frames per block
constexpr int kThreads = 352;  // 11 warps: 1025 bins in 3 passes

__device__ __forceinline__ int reflect_index(int s, int n) {
    // torch reflect: x[-1] = x[1], x[n] = x[n - 2]; the caller guarantees
    // n > n_fft / 2, so one reflection always lands in range
    if (s < 0) s = -s;
    if (s >= n) s = 2 * (n - 1) - s;
    return s;
}

__global__ void __launch_bounds__(kThreads)
log_mel_dft_kernel(
    const float* __restrict__ wave,    // (B, S)
    float* __restrict__ out,           // (B, F, n_mels)
    const float* __restrict__ hann,    // (n_fft,)
    const float2* __restrict__ trig,   // (n_fft,) (cos, sin) of 2 pi m / n_fft
    const int* __restrict__ lo,        // (n_mels,) first nonzero bin
    const int* __restrict__ hi,        // (n_mels,) one past the last
    const int* __restrict__ woff,      // (n_mels,) offset into wts
    const float* __restrict__ wts,     // concatenated triangle weights
    int S, int F, int n_fft, int hop, int n_mels, float log_floor) {
    extern __shared__ float4 smem4[];
    float2* tab = reinterpret_cast<float2*>(smem4);               // (n_fft,)
    float* xs = reinterpret_cast<float*>(tab + n_fft);            // (n_fft, kFrames)
    const int n_bins = n_fft / 2 + 1;
    float* power = xs + static_cast<size_t>(n_fft) * kFrames;     // (kFrames, n_bins)

    const int f0 = blockIdx.x * kFrames;
    const int b = blockIdx.y;
    const int nf = min(kFrames, F - f0);
    const float* x = wave + static_cast<int64_t>(b) * S;

    for (int m = threadIdx.x; m < n_fft; m += blockDim.x) tab[m] = trig[m];
    for (int f = 0; f < kFrames; ++f) {
        const int base = (f0 + f) * hop - (n_fft >> 1);
        for (int n = threadIdx.x; n < n_fft; n += blockDim.x) {
            xs[n * kFrames + f] =
                f < nf ? x[reflect_index(base + n, S)] * hann[n] : 0.0f;
        }
    }
    __syncthreads();

    const int mask = n_fft - 1;
    for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
        float re[kFrames], im[kFrames];
#pragma unroll
        for (int f = 0; f < kFrames; ++f) re[f] = im[f] = 0.0f;
        int idx = 0;  // (n k) mod n_fft
        for (int n = 0; n < n_fft; ++n) {
            const float2 cs = tab[idx];
            idx = (idx + k) & mask;
            const float4 a = *reinterpret_cast<const float4*>(xs + n * kFrames);
            const float4 c = *reinterpret_cast<const float4*>(xs + n * kFrames + 4);
            const float v[kFrames] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
            for (int f = 0; f < kFrames; ++f) {
                re[f] = fmaf(v[f], cs.x, re[f]);
                im[f] = fmaf(-v[f], cs.y, im[f]);
            }
        }
#pragma unroll
        for (int f = 0; f < kFrames; ++f) {
            power[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < nf * n_mels; i += blockDim.x) {
        const int f = i / n_mels, m = i % n_mels;
        const int l = lo[m], h = hi[m];
        const float* w = wts + woff[m] - l;
        const float* p = power + f * n_bins;
        float acc = 0.0f;
        for (int k = l; k < h; ++k) acc = fmaf(p[k], w[k], acc);
        out[(static_cast<int64_t>(b) * F + f0 + f) * n_mels + m] =
            logf(fmaxf(acc, log_floor));
    }
}

}  // namespace

extern "C" int m2m_log_mel_dft(
    const void* wave, void* out, const void* hann, const void* trig,
    const void* lo, const void* hi, const void* woff, const void* wts,
    int batch, int S, int F, int n_fft, int hop, int n_mels,
    float log_floor, void* stream) {
    const size_t smem = static_cast<size_t>(n_fft) * sizeof(float2)
        + static_cast<size_t>(n_fft) * kFrames * sizeof(float)
        + static_cast<size_t>(n_fft / 2 + 1) * kFrames * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        log_mel_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((F + kFrames - 1) / kFrames, batch);
    log_mel_dft_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(wave), static_cast<float*>(out),
        static_cast<const float*>(hann), static_cast<const float2*>(trig),
        static_cast<const int*>(lo), static_cast<const int*>(hi),
        static_cast<const int*>(woff), static_cast<const float*>(wts),
        S, F, n_fft, hop, n_mels, log_floor);
    return static_cast<int>(cudaGetLastError());
}
