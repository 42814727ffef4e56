// Fused log-mel front end for Hopper (sm_90a).
//
// Replaces music2midi_tpu/ops/mel_pallas.py::log_mel_spectrogram_pallas_fft
// (kernel _mel_fft_kernel): center reflect pad -> hop framing -> periodic
// Hann window -> n_fft-point real FFT -> power -> HTK mel projection ->
// clamp -> log, with no frame, spectrum or power tensor in device memory.
//
// Design.  One thread block per (chunk, frame).  The frame is read straight
// from the (B, S) fp32 wave: the reflect pad is index arithmetic, nothing is
// materialised.  The n_fft-point real FFT runs as an M = n_fft/2 point
// complex FFT of the packed frame z[m] = x[2m] + i x[2m+1] (iterative
// radix-2 decimation in time, in shared memory) followed by the standard
// split step that recovers bins 0..M of the real transform.  Power goes to
// shared memory, and each mel bin sums only over the nonzero span
// [lo, hi) of its triangle, with weights taken from the same float32
// filterbank as the plain PyTorch version.  All arithmetic is fp32; the
// window and twiddles come from float64 host tables rounded to fp32.
//
// Shared memory: M complex values, M twiddles and M + 1 powers, i.e.
// 20 * M + 4 bytes (20.5 KB at n_fft 2048).
//
// Bound on the H100: at the serving shape (64 chunks x 48000 samples,
// 188 frames, 384 mels) the function moves 30.8 MB (wave in, mels out),
// ~9 us at 3.35 TB/s, and does 0.79 GFLOP of fp32 work (the real FFT's
// 2.5 N log2 N per frame, plus window, power and mel sums), ~12 us at the
// 67 TFLOP/s fp32 (non-tensor-core) rate, so operations bound it, just
// ahead of the memory: see PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int reflect_index(int s, int n) {
    // jnp.pad / torch reflect: x[-1] = x[1], x[n] = x[n - 2]; the caller
    // guarantees n > n_fft / 2, so one reflection always lands in range
    if (s < 0) s = -s;
    if (s >= n) s = 2 * (n - 1) - s;
    return s;
}

__global__ void log_mel_fft_kernel(
    const float* __restrict__ wave,    // (B, S)
    float* __restrict__ out,           // (B, F, n_mels)
    const float* __restrict__ hann,    // (n_fft,)
    const float2* __restrict__ tw,     // (M,) (cos, sin) of 2 pi k / n_fft
    const int* __restrict__ lo,        // (n_mels,) first nonzero bin
    const int* __restrict__ hi,        // (n_mels,) one past the last
    const int* __restrict__ woff,      // (n_mels,) offset into wts
    const float* __restrict__ wts,     // concatenated triangle weights
    int S, int F, int n_fft, int log2m, int hop, int n_mels,
    float log_floor) {
    extern __shared__ float smem[];
    const int M = n_fft >> 1;
    float2* z = reinterpret_cast<float2*>(smem);   // (M,)
    float2* t = z + M;                             // (M,)
    float* power = reinterpret_cast<float*>(t + M);  // (M + 1,)

    const int frame = blockIdx.x;
    const int b = blockIdx.y;
    const float* x = wave + static_cast<int64_t>(b) * S;
    const int base = frame * hop - (n_fft >> 1);

    for (int k = threadIdx.x; k < M; k += blockDim.x) t[k] = tw[k];
    // windowed, packed frame, stored at the bit-reversed index
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
        const int n0 = 2 * m;
        const float a = x[reflect_index(base + n0, S)] * hann[n0];
        const float c = x[reflect_index(base + n0 + 1, S)] * hann[n0 + 1];
        const int r = __brev(static_cast<unsigned>(m)) >> (32 - log2m);
        z[r] = make_float2(a, c);
    }
    __syncthreads();

    // M-point radix-2 DIT; W_M^j = W_{n_fft}^{2j}, so the twiddle of a
    // butterfly at offset j in a span of length len is t[j * (n_fft / len)]
    for (int len = 2; len <= M; len <<= 1) {
        const int half = len >> 1;
        const int stride = n_fft / len;
        for (int q = threadIdx.x; q < (M >> 1); q += blockDim.x) {
            const int j = q & (half - 1);
            const int i0 = (q - j) * 2 + j;
            const int i1 = i0 + half;
            const float2 w = t[j * stride];  // e^{-i theta} = (c, -s)
            const float2 u = z[i0];
            const float2 v = z[i1];
            const float vr = v.x * w.x + v.y * w.y;
            const float vi = v.y * w.x - v.x * w.y;
            z[i0] = make_float2(u.x + vr, u.y + vi);
            z[i1] = make_float2(u.x - vr, u.y - vi);
        }
        __syncthreads();
    }

    // split step: X[k] = (A + W^k (-i) B) / 2 with A = Z[k] + conj Z[M-k],
    // B = Z[k] - conj Z[M-k]; k = M uses Z[0] and W^M = -1
    for (int k = threadIdx.x; k <= M; k += blockDim.x) {
        const float2 zk = z[k & (M - 1)];
        const float2 zm = z[(M - k) & (M - 1)];
        const float ar = zk.x + zm.x, ai = zk.y - zm.y;
        const float br = zk.x - zm.x, bi = zk.y + zm.y;
        float c, s;
        if (k < M) {
            c = t[k].x;
            s = t[k].y;
        } else {
            c = -1.0f;
            s = 0.0f;
        }
        const float xr = 0.5f * (ar + bi * c - br * s);
        const float xi = 0.5f * (ai - bi * s - br * c);
        power[k] = xr * xr + xi * xi;
    }
    __syncthreads();

    float* o = out + (static_cast<int64_t>(b) * F + frame) * n_mels;
    for (int m = threadIdx.x; m < n_mels; m += blockDim.x) {
        const int l = lo[m], h = hi[m];
        const float* w = wts + woff[m] - l;
        float acc = 0.0f;
        for (int k = l; k < h; ++k) acc = fmaf(power[k], w[k], acc);
        o[m] = logf(fmaxf(acc, log_floor));
    }
}

}  // namespace

extern "C" int m2m_log_mel_fft(
    const void* wave, void* out, const void* hann, const void* tw,
    const void* lo, const void* hi, const void* woff, const void* wts,
    int batch, int S, int F, int n_fft, int hop, int n_mels,
    float log_floor, void* stream) {
    int log2m = 0;
    while ((1 << log2m) < (n_fft >> 1)) ++log2m;
    const int M = n_fft >> 1;
    const size_t smem = static_cast<size_t>(M) * 2 * sizeof(float2)
        + static_cast<size_t>(M + 1) * sizeof(float);
    dim3 grid(F, batch);
    log_mel_fft_kernel<<<grid, 256, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(wave), static_cast<float*>(out),
        static_cast<const float*>(hann), static_cast<const float2*>(tw),
        static_cast<const int*>(lo), static_cast<const int*>(hi),
        static_cast<const int*>(woff), static_cast<const float*>(wts),
        S, F, n_fft, log2m, hop, n_mels, log_floor);
    return static_cast<int>(cudaGetLastError());
}
