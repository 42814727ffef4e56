// m2m_dsp: native DSP kernels for the music2midi-tpu host runtime.
//
// The reference repo's native surfaces live in dependencies (torchaudio C++
// DSP, numba-JIT kernels, FFmpeg — SURVEY.md §2.1).  This library provides
// the framework's own native implementations of the host-side hot paths:
//
//   * phase-vocoder pitch shift (the training-loader bottleneck; reference
//     music2midi/dataset.py:132-133 via librosa)
//   * polyphase windowed-sinc resampling
//   * fix_invalid_offsets (reference data/midi_to_numpy.py:12-26, O(n^2)
//     per pitch in numba; O(n log n) here via per-pitch sort)
//
// Exposed as a plain C ABI consumed through ctypes
// (music2midi_tpu/native.py).  Build: `make -C native` (g++ -O3).
// Numerics match music2midi_tpu/dsp.py (the numpy reference) to float
// tolerance; parity is enforced in tests/test_native.py.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ----------------------------------------------------------------------
// radix-2 complex FFT (n power of two), iterative, with cached twiddles
// ----------------------------------------------------------------------

void fft_inplace(std::complex<double>* a, int n, bool inverse) {
  // bit reversal
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (int len = 2; len <= n; len <<= 1) {
    double ang = 2.0 * kPi / len * (inverse ? 1.0 : -1.0);
    std::complex<double> wlen(std::cos(ang), std::sin(ang));
    for (int i = 0; i < n; i += len) {
      std::complex<double> w(1.0);
      for (int k = 0; k < len / 2; ++k) {
        std::complex<double> u = a[i + k];
        std::complex<double> v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (inverse) {
    for (int i = 0; i < n; ++i) a[i] /= n;
  }
}

std::vector<std::complex<double>> rfft(const double* x, int n) {
  std::vector<std::complex<double>> buf(n);
  for (int i = 0; i < n; ++i) buf[i] = x[i];
  fft_inplace(buf.data(), n, false);
  buf.resize(n / 2 + 1);
  return buf;
}

std::vector<double> irfft(const std::complex<double>* X, int n) {
  std::vector<std::complex<double>> buf(n);
  for (int k = 0; k <= n / 2; ++k) buf[k] = X[k];
  for (int k = n / 2 + 1; k < n; ++k) buf[k] = std::conj(X[n - k]);
  fft_inplace(buf.data(), n, true);
  std::vector<double> out(n);
  for (int i = 0; i < n; ++i) out[i] = buf[i].real();
  return out;
}

std::vector<double> hann_periodic(int n) {
  std::vector<double> w(n);
  for (int i = 0; i < n; ++i)
    w[i] = 0.5 - 0.5 * std::cos(2.0 * kPi * i / n);
  return w;
}

double wrap_phase(double p) {
  return p - 2.0 * kPi * std::round(p / (2.0 * kPi));
}

double i0(double x) {  // modified Bessel I0 (for the Kaiser window)
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

}  // namespace

extern "C" {

// Polyphase rational resampling with a Kaiser-windowed sinc filter —
// mirrors scipy.signal.resample_poly(window=("kaiser", beta)) semantics
// used by music2midi_tpu.audio.resample (beta 14.7697).
// out must hold ceil(n * up / down) samples.  Returns output length.
int m2m_resample(const float* in, int64_t n, int up, int down, float* out,
                 double beta) {
  if (up == down) {
    std::memcpy(out, in, sizeof(float) * n);
    return (int)n;
  }
  const int max_rate = std::max(up, down);
  const int half_len = 10 * max_rate;  // scipy default: 2*10*max_rate+1 taps
  const int taps = 2 * half_len + 1;
  const double f_c = 1.0 / max_rate;  // cutoff (normalized to Nyquist)
  std::vector<double> h(taps);
  const double denom = i0(beta);
  for (int i = 0; i < taps; ++i) {
    const double m = i - half_len;
    const double sinc =
        (m == 0.0) ? f_c : std::sin(kPi * f_c * m) / (kPi * m);
    const double r = 2.0 * (i - (taps - 1) / 2.0) / (taps - 1);
    const double kaiser = i0(beta * std::sqrt(std::max(0.0, 1.0 - r * r))) /
                          denom;
    h[i] = (double)up * sinc * kaiser;
  }
  const int64_t out_len = (n * up + down - 1) / down;
  // y[m] = sum_k h[m*down - k*up + half_len] * x[k]
  for (int64_t m = 0; m < out_len; ++m) {
    const int64_t t = (int64_t)m * down;  // position in upsampled grid
    double acc = 0.0;
    // k range where |t - k*up| <= half_len
    int64_t k0 = (t - half_len + up - 1) / up;
    int64_t k1 = (t + half_len) / up;
    k0 = std::max<int64_t>(k0, 0);
    k1 = std::min<int64_t>(k1, n - 1);
    for (int64_t k = k0; k <= k1; ++k) {
      acc += h[t - k * up + half_len] * in[k];
    }
    out[m] = (float)acc;
  }
  return (int)out_len;
}

// Phase-vocoder pitch shift by n_steps semitones; output length == input
// length.  Same recipe as music2midi_tpu.dsp.pitch_shift (librosa recipe):
// time-stretch by 2^(-steps/12) with n_fft=2048 hop=512, resample back.
void m2m_pitch_shift(const float* in, int64_t n, int sr, double n_steps,
                     float* out) {
  if (n_steps == 0.0 || n == 0) {
    std::memcpy(out, in, sizeof(float) * n);
    return;
  }
  const int n_fft = 2048, hop = 512;
  const double rate = std::pow(2.0, -n_steps / 12.0);

  // --- STFT (center reflect pad) ---------------------------------------
  const int pad = n_fft / 2;
  std::vector<double> x(n + 2 * pad);
  for (int64_t i = 0; i < (int64_t)x.size(); ++i) {
    int64_t j = i - pad;
    if (j < 0) j = -j;                       // reflect left
    if (j >= n) j = 2 * (n - 1) - j;         // reflect right
    j = std::clamp<int64_t>(j, 0, n - 1);
    x[i] = in[j];
  }
  const int n_frames = 1 + (int)((x.size() - n_fft) / hop);
  const auto window = hann_periodic(n_fft);
  const int n_bins = n_fft / 2 + 1;
  std::vector<std::vector<std::complex<double>>> D(n_frames);
  std::vector<double> frame(n_fft);
  for (int f = 0; f < n_frames; ++f) {
    for (int i = 0; i < n_fft; ++i)
      frame[i] = x[(int64_t)f * hop + i] * window[i];
    D[f] = rfft(frame.data(), n_fft);
  }

  // --- phase vocoder ----------------------------------------------------
  const int out_frames = (int)std::ceil(n_frames / rate);
  std::vector<double> phi_advance(n_bins);
  for (int b = 0; b < n_bins; ++b)
    phi_advance[b] = kPi * hop * b / (n_bins - 1);
  std::vector<double> phase_acc(n_bins);
  for (int b = 0; b < n_bins; ++b) phase_acc[b] = std::arg(D[0][b]);
  std::vector<std::vector<std::complex<double>>> S(out_frames);
  for (int t = 0; t < out_frames; ++t) {
    const double step = t * rate;
    const int i = (int)step;
    const double frac = step - i;
    const auto& cur = (i < n_frames) ? D[i] : D[n_frames - 1];
    static const std::vector<std::complex<double>> kZero;
    const bool has_next = (i + 1) < n_frames;
    S[t].resize(n_bins);
    for (int b = 0; b < n_bins; ++b) {
      const std::complex<double> nxt =
          has_next ? D[i + 1][b] : std::complex<double>(0.0);
      const double mag =
          (1.0 - frac) * std::abs(cur[b]) + frac * std::abs(nxt);
      S[t][b] = std::polar(mag, phase_acc[b]);
      const double dphase =
          wrap_phase(std::arg(nxt) - std::arg(cur[b]) - phi_advance[b]);
      phase_acc[b] += phi_advance[b] + dphase;
    }
  }

  // --- iSTFT (overlap-add, squared-window normalization) ----------------
  const int64_t y_len = n_fft + (int64_t)(out_frames - 1) * hop;
  std::vector<double> y(y_len, 0.0), norm(y_len, 0.0);
  for (int t = 0; t < out_frames; ++t) {
    auto fr = irfft(S[t].data(), n_fft);
    for (int i = 0; i < n_fft; ++i) {
      y[(int64_t)t * hop + i] += fr[i] * window[i];
      norm[(int64_t)t * hop + i] += window[i] * window[i];
    }
  }
  for (int64_t i = 0; i < y_len; ++i)
    y[i] /= std::max(norm[i], 1e-8);
  // strip center pad, fix length to round(n / rate)
  const int64_t stretched_len = (int64_t)std::llround(n / rate);
  std::vector<float> stretched(stretched_len, 0.0f);
  for (int64_t i = 0; i < stretched_len; ++i) {
    const int64_t j = i + pad;
    stretched[i] = (j < y_len) ? (float)y[j] : 0.0f;
  }

  // --- resample back by `rate` (rational approx, denominator <= 1000) ---
  // continued-fraction best rational approximation of `rate`
  double target = rate;
  int64_t best_num = 1, best_den = 1;
  double best_err = 1e18;
  for (int64_t den = 1; den <= 1000; ++den) {
    const int64_t num = (int64_t)std::llround(target * den);
    if (num <= 0) continue;
    const double err = std::abs(target - (double)num / den);
    if (err < best_err - 1e-15) {
      best_err = err;
      best_num = num;
      best_den = den;
    }
  }
  // resample_poly(stretched, up=den, down=num) stretches length by den/num
  // = 1/rate... we need length n = stretched_len * rate: up=num, down=den
  std::vector<float> shifted(
      (stretched_len * best_num + best_den - 1) / best_den + 8, 0.0f);
  const int out_len = m2m_resample(stretched.data(), stretched_len,
                                   (int)best_num, (int)best_den,
                                   shifted.data(), 14.769656459379492);
  for (int64_t i = 0; i < n; ++i)
    out[i] = (i < out_len) ? shifted[i] : 0.0f;
}

// Clamp each note's offset to the next same-pitch onset (reference
// data/midi_to_numpy.py:12-26).  notes: (n, 4) float64 rows
// [onset, offset, pitch, velocity], modified in place.
void m2m_fix_invalid_offsets(double* notes, int64_t n) {
  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    const double pa = notes[a * 4 + 2], pb = notes[b * 4 + 2];
    if (pa != pb) return pa < pb;
    return notes[a * 4] < notes[b * 4];
  });
  for (int64_t i = 0; i + 1 < n; ++i) {
    const int64_t a = idx[i];
    // next same-pitch note with STRICTLY later onset (equal onsets do not
    // clamp each other in the reference: `notes[i,0] < notes[j,0]`)
    for (int64_t j = i + 1; j < n; ++j) {
      const int64_t b = idx[j];
      if (notes[a * 4 + 2] != notes[b * 4 + 2]) break;  // pitch boundary
      if (notes[a * 4] < notes[b * 4]) {
        notes[a * 4 + 1] = std::min(notes[a * 4 + 1], notes[b * 4]);
        break;
      }
    }
  }
}

// Banded weighted-step DTW over the cosine cost 1 - <fa_i, fb_j>
// (replaces the pure-Python inner loops of data/align.py; the reference
// delegates this to synctoolbox's numba kernels, data/align_audio_midi.py
// :235-247).  The cost matrix is never materialized: cells are evaluated
// on the fly inside the band, so a 3-minute song at feature rate 50
// (n=m~9000, band ~200) costs ~2M cells instead of an 81M-cell / 648 MB
// full matrix.
//
//   fa: (n, d) row-major float32 — time-major feature vectors
//   fb: (m, d) row-major float32
//   lo/hi: per-row allowed column range [lo[i], hi[i]); pass 0/m for full
//   steps: (1,0) w_up, (0,1) w_left, (1,1) w_diag; tie-break prefers
//          up, then left, then diag under strict < (matches align.dtw_path)
//   out_path: caller buffer of 2*(n+m) int64, filled with (i, j) pairs in
//             start->end order.  Returns the path length, or -1 on error.
int64_t m2m_dtw_band(const float* fa, const float* fb, int64_t d, int64_t n,
                     int64_t m, const int64_t* lo, const int64_t* hi,
                     double w_up, double w_left, double w_diag,
                     int64_t* out_path) {
  if (n <= 0 || m <= 0 || d <= 0) return -1;
  const double INF = std::numeric_limits<double>::infinity();
  // band layout: row i occupies [offs[i], offs[i] + width[i]) in D/P
  std::vector<int64_t> offs(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t w = std::max<int64_t>(0, hi[i] - lo[i]);
    offs[i + 1] = offs[i] + w;
  }
  std::vector<double> D((size_t)offs[n], INF);
  std::vector<int8_t> P((size_t)offs[n], 0);

  auto cell_cost = [&](int64_t i, int64_t j) -> double {
    const float* a = fa + i * d;
    const float* b = fb + j * d;
    double dot = 0.0;
    for (int64_t k = 0; k < d; ++k) dot += (double)a[k] * (double)b[k];
    return 1.0 - dot;
  };
  auto dval = [&](int64_t i, int64_t j) -> double {
    if (i < 0 || j < lo[i] || j >= hi[i]) return INF;
    return D[(size_t)(offs[i] + (j - lo[i]))];
  };

  if (lo[0] > 0 || hi[0] <= 0) return -1;  // (0,0) must be in the band
  D[(size_t)offs[0]] = cell_cost(0, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t jb = lo[i], je = hi[i];
    for (int64_t j = jb; j < je; ++j) {
      if (i == 0 && j == 0) continue;
      const double c = cell_cost(i, j);
      double best = dval(i - 1, j) + w_up * c;
      int8_t step = 0;
      const double left = dval(i, j - 1) + w_left * c;
      if (left < best) { best = left; step = 1; }
      const double diag =
          (i > 0) ? dval(i - 1, j - 1) + w_diag * c : INF;
      if (diag < best) { best = diag; step = 2; }
      if (best < INF) {
        D[(size_t)(offs[i] + (j - jb))] = best;
        P[(size_t)(offs[i] + (j - jb))] = step;
      }
    }
  }

  // backtrack from (n-1, m-1); mirrors align.dtw_path
  static const int64_t STEPS[3][2] = {{1, 0}, {0, 1}, {1, 1}};
  std::vector<int64_t> rev;
  rev.reserve(2 * (size_t)(n + m));
  int64_t i = n - 1, j = m - 1;
  rev.push_back(i);
  rev.push_back(j);
  while (i > 0 || j > 0) {
    int8_t s = 0;
    if (j >= lo[i] && j < hi[i]) s = P[(size_t)(offs[i] + (j - lo[i]))];
    i -= STEPS[s][0];
    j -= STEPS[s][1];
    if (i < 0 || j < 0) break;
    rev.push_back(i);
    rev.push_back(j);
  }
  const int64_t len = (int64_t)rev.size() / 2;
  for (int64_t k = 0; k < len; ++k) {
    out_path[2 * k] = rev[rev.size() - 2 * (size_t)(k + 1)];
    out_path[2 * k + 1] = rev[rev.size() - 2 * (size_t)(k + 1) + 1];
  }
  return len;
}

int m2m_version() { return 2; }

}  // extern "C"
