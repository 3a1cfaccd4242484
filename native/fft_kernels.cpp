// fftnative — native CPU FFT behind a C ABI.
//
// The analog of the reference's MLX FFI shim (reference
// ffi/mlx_fft.c): a native-code transform reached through a plain C boundary
// with split-complex f32 buffers on both sides and integer error codes
// (mirroring mlx_fft.c's -1/-2/-3 contract).  Where the reference shim
// delegates to Apple's MLX, this is a self-contained Stockham autosort FFT —
// the same self-sorting formulation the Pallas kernels are designed around
// (no bit-reversal pass; every stage reads/writes contiguously), so the
// native backend doubles as an independent numerical oracle for the parity
// suite.
//
// Build: make -C native          (produces libfftnative.so)
// ABI:   fftnative_transform(re_in, im_in, re_out, im_out, batch, n, sign)
//        sign = -1 forward, +1 inverse (unnormalized; caller scales by 1/n,
//        matching the library convention and reference src/ifft.rs:140-146).

#include <cmath>
#include <cstddef>
#include <vector>

namespace {

constexpr double kTau = 6.283185307179586476925286766559;

// One Stockham pass: combine stride-s DFT blocks of length n into length-2
// merges, ping-ponging between x and y.  Classic self-sorting DIF recursion
// (Van Loan's framework): output lands in natural order with no permutation.
void stockham_step(std::size_t n, std::size_t s, bool eo, int sign,
                   float* xr, float* xi, float* yr, float* yi) {
  const std::size_t m = n / 2;
  const double theta0 = kTau / static_cast<double>(n);
  if (n == 1) {
    if (eo) {
      for (std::size_t q = 0; q < s; q++) {
        yr[q] = xr[q];
        yi[q] = xi[q];
      }
    }
    return;
  }
  for (std::size_t p = 0; p < m; p++) {
    const double ang = theta0 * static_cast<double>(p);
    // sign = -1 (forward) -> w = exp(-i*ang); sign = +1 (inverse) -> exp(+i*ang).
    const float wr = static_cast<float>(std::cos(ang));
    const float wi = static_cast<float>(sign * std::sin(ang));
    float* ar = xr + s * p;
    float* ai = xi + s * p;
    float* br = xr + s * (p + m);
    float* bi = xi + s * (p + m);
    float* cr = yr + s * 2 * p;
    float* ci = yi + s * 2 * p;
    float* dr = yr + s * (2 * p + 1);
    float* di = yi + s * (2 * p + 1);
    for (std::size_t q = 0; q < s; q++) {
      const float are = ar[q], aim = ai[q];
      const float bre = br[q], bim = bi[q];
      cr[q] = are + bre;
      ci[q] = aim + bim;
      const float tr = are - bre;
      const float ti = aim - bim;
      dr[q] = tr * wr - ti * wi;
      di[q] = tr * wi + ti * wr;
    }
  }
  stockham_step(m, 2 * s, !eo, sign, yr, yi, xr, xi);
}

void fft_one(std::size_t n, int sign, float* xr, float* xi, float* wr, float* wi) {
  stockham_step(n, 1, false, sign, xr, xi, wr, wi);
}

bool is_pow2(std::size_t n) { return n != 0 && (n & (n - 1)) == 0; }

}  // namespace

extern "C" {

// Returns 0 on success; -1: null pointer; -2: n not a power of two;
// -3: sign not in {-1, +1}
// (error-code contract mirroring reference ffi/mlx_fft.c:17,48,62).
int fftnative_transform(const float* re_in, const float* im_in, float* re_out,
                     float* im_out, std::size_t batch, std::size_t n,
                     int sign) {
  if (!re_in || !im_in || !re_out || !im_out) return -1;
  if (!is_pow2(n)) return -2;
  if (sign != -1 && sign != 1) return -3;

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (long long b = 0; b < static_cast<long long>(batch); b++) {
    std::vector<float> xr(re_in + b * n, re_in + (b + 1) * n);
    std::vector<float> xi(im_in + b * n, im_in + (b + 1) * n);
    std::vector<float> wr(n), wi(n);
    fft_one(n, sign, xr.data(), xi.data(), wr.data(), wi.data());
    for (std::size_t j = 0; j < n; j++) {
      re_out[b * n + j] = xr[j];
      im_out[b * n + j] = xi[j];
    }
  }
  return 0;
}

// Library version tag, for ctypes sanity checks.
int fftnative_abi_version() { return 1; }

}  // extern "C"
