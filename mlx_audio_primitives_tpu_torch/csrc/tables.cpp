// Native float64 table builders of the PyTorch port of
// mlx-audio-primitives-tpu: its own copy of the JAX package's
// csrc/tables.cpp, built by the port's `_native.py` with one g++ call.
//
// The exact float64 host math of the library's lookup tables (windows, the
// mel scale and filterbank, the bark and linear filterbanks, the DCT-II
// basis); the device kernels are the CUDA sources beside this file. The
// code is the JAX package's, so the tables agree bit for bit.
//
// Exposed through a plain C ABI consumed via ctypes. All functions write
// into caller-allocated float64 buffers and return 0 on success, negative on
// error. The Python side keeps a NumPy fallback for every builder.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// Slaney mel-scale constants (reference mel.py:24-28).
constexpr double kFMin = 0.0;
constexpr double kFSp = 200.0 / 3.0;
constexpr double kMinLogHz = 1000.0;
constexpr double kMinLogMel = (kMinLogHz - kFMin) / kFSp;
const double kLogStep = std::log(6.4) / 27.0;

double hz_to_mel_one(double f, bool htk) {
  if (htk) return 2595.0 * std::log10(1.0 + f / 700.0);
  if (f >= kMinLogHz) return kMinLogMel + std::log(f / kMinLogHz) / kLogStep;
  return (f - kFMin) / kFSp;
}

double mel_to_hz_one(double m, bool htk) {
  if (htk) return 700.0 * (std::pow(10.0, m / 2595.0) - 1.0);
  if (m >= kMinLogMel) return kMinLogHz * std::exp(kLogStep * (m - kMinLogMel));
  return kFMin + kFSp * m;
}

// numpy.linspace-compatible evaluation (start + k*step, endpoint exact).
inline double linspace_at(double start, double stop, int64_t n, int64_t k) {
  if (n == 1) return start;
  if (k == n - 1) return stop;
  return start + static_cast<double>(k) * ((stop - start) / static_cast<double>(n - 1));
}

// Symmetric generalized-cosine window of length n with coefficients a[0..nc).
// Negative values are kept as-is (blackman endpoints are ~-1.4e-17 in
// scipy; clamping them would break byte-exact parity).
void general_cosine(int64_t n, const double* a, int64_t nc, double* out) {
  if (n == 1) {
    out[0] = 1.0;
    return;
  }
  for (int64_t k = 0; k < n; ++k) {
    // scipy formulation: fac = linspace(-pi, pi, n)
    double fac = linspace_at(-kPi, kPi, n, k);
    double w = 0.0;
    for (int64_t j = 0; j < nc; ++j) w += a[j] * std::cos(j * fac);
    out[k] = w;
  }
}

int symmetric_window(int32_t kind, int64_t n, double beta, double* out) {
  static const double hann[] = {0.5, 0.5};
  static const double hamming[] = {0.54, 0.46};
  static const double blackman[] = {0.42, 0.5, 0.08};
  if (n <= 0) return -1;
  switch (kind) {
    case 0:  // hann
      general_cosine(n, hann, 2, out);
      return 0;
    case 1:  // hamming
      general_cosine(n, hamming, 2, out);
      return 0;
    case 2:  // blackman: scipy keeps the ~-1e-17 f64 endpoints, so do we
      general_cosine(n, blackman, 3, out);
      return 0;
    case 3: {  // bartlett
      if (n == 1) {
        out[0] = 1.0;
        return 0;
      }
      for (int64_t k = 0; k < n; ++k)
        out[k] = 1.0 - std::fabs(2.0 * k / static_cast<double>(n - 1) - 1.0);
      return 0;
    }
    case 4:  // rectangular
      for (int64_t k = 0; k < n; ++k) out[k] = 1.0;
      return 0;
    case 5: {  // kaiser (numpy i0 formulation)
      if (n == 1) {
        out[0] = 1.0;
        return 0;
      }
      double alpha = (static_cast<double>(n) - 1.0) / 2.0;
      double denom = std::cyl_bessel_i(0.0, beta);
      for (int64_t k = 0; k < n; ++k) {
        double r = (static_cast<double>(k) - alpha) / alpha;
        double arg = beta * std::sqrt(std::max(0.0, 1.0 - r * r));
        out[k] = std::cyl_bessel_i(0.0, arg) / denom;
      }
      return 0;
    }
    default:
      return -2;
  }
}

// Bark conversions, matching ops/filterbanks.py bit for bit (same libm calls
// in the same order as the NumPy expressions; ** with an integer exponent is
// repeated multiplication in npy_pow, so q^2/q^4 are q*q / (q*q)*(q*q)).
double hz_to_bark_one(double f, int32_t formula) {
  if (formula == 0) {  // zwicker
    double q = f / 7500.0;
    return 13.0 * std::atan(0.00076 * f) + 3.5 * std::atan(q * q);
  }
  // traunmuller, with edge corrections (mutually exclusive regions)
  double bark = (26.81 * f) / (1960.0 + f) - 0.53;
  if (bark < 2.0) bark = bark + 0.15 * (2.0 - bark);
  if (bark > 20.1) bark = bark + 0.22 * (bark - 20.1);
  return bark;
}

double zwicker_derivative_one(double f) {
  double p = 0.00076 * f;
  double q = f / 7500.0;
  double q2 = q * q;
  double t1 = 13.0 * 0.00076 / (1.0 + p * p);
  double t2 = 3.5 * (2.0 * f / 56250000.0) / (1.0 + q2 * q2);
  return t1 + t2;
}

double bark_to_hz_one(double z, int32_t formula) {
  if (formula == 0) {  // zwicker: sinh guess + 8 Newton steps
    double hz = 600.0 * std::sinh(z / 6.0);
    for (int i = 0; i < 8; ++i) {
      double err = hz_to_bark_one(hz, 0) - z;
      double d = zwicker_derivative_one(hz);
      hz = std::max(hz - err / std::max(d, 1e-12), 0.0);
    }
    return hz;
  }
  double zz = z < 2.0 ? (z - 0.3) / 0.85 : z;
  if (zz > 20.1) zz = (zz + 0.22 * 20.1) / 1.22;
  return 1960.0 * (zz + 0.53) / (26.28 - zz);
}

// Triangular filters on hz edge points (n_bands+2 points), optional slaney
// norm — the shared bark/linear construction (ops/filterbanks.py:76-93).
void triangular_filterbank(const double* hz_points, int32_t sr, int32_t n_fft,
                           int32_t n_bands, int32_t norm, double* out) {
  const int64_t n_bins = n_fft / 2 + 1;
  for (int64_t m = 0; m < n_bands; ++m) {
    double f_lower = hz_points[m];
    double f_center = hz_points[m + 1];
    double f_upper = hz_points[m + 2];
    double enorm = norm == 1 ? 2.0 / (hz_points[m + 2] - hz_points[m]) : 1.0;
    for (int64_t k = 0; k < n_bins; ++k) {
      double freq = linspace_at(0.0, sr / 2.0, n_bins, k);
      double lower = (freq - f_lower) / (f_center - f_lower + 1e-10);
      double upper = (f_upper - freq) / (f_upper - f_center + 1e-10);
      double w = std::min(lower, upper);
      w = w > 0.0 ? w : 0.0;
      out[m * n_bins + k] = w * enorm;
    }
  }
}

}  // namespace

extern "C" {

// ABI version for the Python-side smoke test.
// 2: single-pass WAV read (actual-count outputs) replaced the capacity-only
// signature; loaders built for ABI 1 must not call into this library.
int32_t mapt_abi_version() { return 2; }

// Window table. kind: 0 hann, 1 hamming, 2 blackman, 3 bartlett,
// 4 rectangular, 5 kaiser(beta). fftbins: periodic (n+1 symmetric, drop last).
int32_t mapt_window(int32_t kind, int64_t n, int32_t fftbins, double beta,
                    double* out) {
  if (n <= 0 || out == nullptr) return -1;
  if (fftbins && n > 1) {
    std::vector<double> tmp(n + 1);
    int rc = symmetric_window(kind, n + 1, beta, tmp.data());
    if (rc) return rc;
    std::memcpy(out, tmp.data(), sizeof(double) * n);
    return 0;
  }
  return symmetric_window(kind, n, beta, out);
}

int32_t mapt_hz_to_mel(const double* f, int64_t n, int32_t htk, double* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = hz_to_mel_one(f[i], htk != 0);
  return 0;
}

int32_t mapt_mel_to_hz(const double* m, int64_t n, int32_t htk, double* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = mel_to_hz_one(m[i], htk != 0);
  return 0;
}

// Mel filterbank (n_mels, n_fft/2+1), librosa fdiff/ramps algorithm
// (reference mel_filterbank.cpp:144-228). norm: 0 none, 1 slaney.
int32_t mapt_mel_filterbank(int32_t sr, int32_t n_fft, int32_t n_mels,
                            double fmin, double fmax, int32_t htk,
                            int32_t norm, double* out) {
  if (n_mels <= 0 || n_fft <= 0 || out == nullptr) return -1;
  const int64_t n_bins = n_fft / 2 + 1;
  std::vector<double> fftfreqs(n_bins);
  for (int64_t k = 0; k < n_bins; ++k)
    fftfreqs[k] = linspace_at(0.0, sr / 2.0, n_bins, k);

  const int64_t npts = n_mels + 2;
  std::vector<double> mel_f(npts);
  double mmin = hz_to_mel_one(fmin, htk != 0);
  double mmax = hz_to_mel_one(fmax, htk != 0);
  for (int64_t i = 0; i < npts; ++i)
    mel_f[i] = mel_to_hz_one(linspace_at(mmin, mmax, npts, i), htk != 0);

  for (int64_t m = 0; m < n_mels; ++m) {
    double fdiff_lo = mel_f[m + 1] - mel_f[m];
    double fdiff_hi = mel_f[m + 2] - mel_f[m + 1];
    double enorm =
        norm == 1 ? 2.0 / (mel_f[m + 2] - mel_f[m]) : 1.0;
    for (int64_t k = 0; k < n_bins; ++k) {
      double lower = -(mel_f[m] - fftfreqs[k]) / fdiff_lo;
      double upper = (mel_f[m + 2] - fftfreqs[k]) / fdiff_hi;
      double w = std::min(lower, upper);
      out[m * n_bins + k] = (w > 0.0 ? w : 0.0) * enorm;
    }
  }
  return 0;
}

// Transposed DCT-II basis (n_in, n_out), matching ops/mfcc.py::_dct_basis_t.
// norm: 0 scipy-unnormalized (x2), 1 ortho.
int32_t mapt_dct_basis_t(int32_t n_out, int32_t n_in, int32_t norm,
                         double* out) {
  if (n_out <= 0 || n_in <= 0 || out == nullptr) return -1;
  for (int32_t k = 0; k < n_out; ++k) {
    double scale;
    if (norm == 1) {
      scale = k == 0 ? 1.0 / std::sqrt(static_cast<double>(n_in))
                     : std::sqrt(2.0 / static_cast<double>(n_in));
    } else {
      scale = 2.0;
    }
    for (int32_t n = 0; n < n_in; ++n) {
      double v = std::cos(kPi * k * (2.0 * n + 1.0) / (2.0 * n_in)) * scale;
      out[static_cast<int64_t>(n) * n_out + k] = v;  // transposed layout
    }
  }
  return 0;
}

// Bark-scale filterbank (n_bands, n_fft/2+1). formula: 0 zwicker,
// 1 traunmuller. norm: 0 none, 1 slaney. (ops/filterbanks.py:96-105)
int32_t mapt_bark_filterbank(int32_t sr, int32_t n_fft, int32_t n_bands,
                             double fmin, double fmax, int32_t formula,
                             int32_t norm, double* out) {
  if (n_bands <= 0 || n_fft <= 0 || out == nullptr) return -1;
  if (formula != 0 && formula != 1) return -2;
  const int64_t npts = n_bands + 2;
  double bmin = hz_to_bark_one(fmin, formula);
  double bmax = hz_to_bark_one(fmax, formula);
  std::vector<double> hz_points(npts);
  for (int64_t i = 0; i < npts; ++i)
    hz_points[i] = bark_to_hz_one(linspace_at(bmin, bmax, npts, i), formula);
  triangular_filterbank(hz_points.data(), sr, n_fft, n_bands, norm, out);
  return 0;
}

// Linear-scale filterbank (n_bands, n_fft/2+1). norm: 0 none, 1 slaney.
// (ops/filterbanks.py:108-113)
int32_t mapt_linear_filterbank(int32_t sr, int32_t n_fft, int32_t n_bands,
                               double fmin, double fmax, int32_t norm,
                               double* out) {
  if (n_bands <= 0 || n_fft <= 0 || out == nullptr) return -1;
  const int64_t npts = n_bands + 2;
  std::vector<double> hz_points(npts);
  for (int64_t i = 0; i < npts; ++i)
    hz_points[i] = linspace_at(fmin, fmax, npts, i);
  triangular_filterbank(hz_points.data(), sr, n_fft, n_bands, norm, out);
  return 0;
}

}  // extern "C"
