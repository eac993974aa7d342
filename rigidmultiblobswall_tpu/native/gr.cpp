// Native core for the pseudo-2D radial distribution function.
//
// This framework's equivalent of the reference's standalone analysis
// executable (reference: multi_bodies/examples/Radial_Dist_Test/
// gr_pseudo2D_single_blob.cpp:20-85): accumulate a pair-distance
// histogram with minimum-image convention along x and y only (quasi-2D
// systems, e.g. particles sedimented over a wall), full 3D pair
// distance, and 2 counts per unordered pair.  Normalization to g(r)
// happens host-side in Python (utils/gr.py) against the 2D ideal-gas
// density.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// OpenMP-parallel over frames with per-thread histograms reduced at the
// end — the frame loop is embarrassingly parallel.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline double min_image(double d, double L) {
  if (L > 0.0) d -= L * std::nearbyint(d / L);
  return d;
}

}  // namespace

extern "C" {

// xyz: (n_frames, np, 3) row-major doubles.
// hist_out: n_bins int64, zero-initialised by the caller.
// Returns the number of frames accumulated (after `skip`).
std::int64_t gr_pseudo2d_accumulate(const double* xyz, std::int64_t n_frames,
                                    std::int64_t np, double lx, double ly,
                                    double dr, std::int64_t n_bins,
                                    std::int64_t skip,
                                    std::int64_t* hist_out) {
  if (n_frames <= skip || np < 2 || n_bins <= 0 || dr <= 0.0) return 0;

  const double inv_dr = 1.0 / dr;

#pragma omp parallel
  {
    std::vector<std::int64_t> local(static_cast<std::size_t>(n_bins), 0);

#pragma omp for schedule(dynamic)
    for (std::int64_t f = skip; f < n_frames; ++f) {
      const double* frame = xyz + f * np * 3;
      for (std::int64_t i = 0; i < np - 1; ++i) {
        const double xi = frame[3 * i], yi = frame[3 * i + 1],
                     zi = frame[3 * i + 2];
        for (std::int64_t j = i + 1; j < np; ++j) {
          const double dx = min_image(xi - frame[3 * j], lx);
          const double dy = min_image(yi - frame[3 * j + 1], ly);
          const double dz = zi - frame[3 * j + 2];
          const double r = std::sqrt(dx * dx + dy * dy + dz * dz);
          const std::int64_t bin = static_cast<std::int64_t>(r * inv_dr);
          if (bin < n_bins) local[static_cast<std::size_t>(bin)] += 2;
        }
      }
    }

#pragma omp critical
    for (std::int64_t b = 0; b < n_bins; ++b)
      hist_out[b] += local[static_cast<std::size_t>(b)];
  }

  return n_frames - skip;
}

}  // extern "C"
