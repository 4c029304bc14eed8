// Host data-path ops of the port: its own copy of densify_events and
// gather_windows from native/mmedema_native.cpp, with the same C ABI and
// the same arithmetic. A source of its own, apart from jpeg_decode.cpp,
// because it needs no libjpeg: g++ and -pthread build it on any host (the
// card's host may decode JPEGs on the card and lack libjpeg's headers).
// Built at first use by data/native_loader.py.
//
//   densify_events   sparse event rows -> dense z-scored [S, L, 2V] grid
//   gather_windows   dense grid + anchor (row, slot_end) -> [B, T, 2V]
//
// Both run on a caller-chosen number of threads, each taking the next
// stay (or window) from a shared counter; every output element is written
// by one thread, so the result does not depend on the thread count.
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Scatter sparse per-slot event rows into a dense normalized grid.
//  offsets      [n_stays+1] row ranges per stay
//  slot_idx     [n_rows]; rows whose slot is outside [0, max_len) are
//               dropped
//  values       [n_rows, V] raw values
//  counts       [n_rows, V] observation counts, clipped to [0, count_clip]
//  means, stds  [V] train-split stats
//  out          [n_stays, max_len, 2V] preallocated, zero-filled here: a
//               cell with a clipped count above 0 holds the z-scored value
//               in its first V columns and the count in its last V
void densify_events(const int64_t* offsets, int64_t n_stays,
                    const int32_t* slot_idx, const float* values,
                    const int32_t* counts, int64_t n_rows, int32_t V,
                    const float* means, const float* stds, int32_t max_len,
                    int32_t count_clip, float* out, int32_t n_threads) {
  (void)n_rows;
  const int64_t stride_stay = (int64_t)max_len * 2 * V;
  const int64_t stride_slot = 2 * V;
  std::memset(out, 0, sizeof(float) * n_stays * stride_stay);
  n_threads = std::max(1, (int)n_threads);
  std::vector<std::thread> workers;
  std::atomic<int64_t> next_stay{0};
  auto work = [&]() {
    int64_t s;
    while ((s = next_stay.fetch_add(1)) < n_stays) {
      float* grid = out + s * stride_stay;
      for (int64_t r = offsets[s]; r < offsets[s + 1]; ++r) {
        int32_t t = slot_idx[r];
        if (t < 0 || t >= max_len) continue;
        float* row = grid + (int64_t)t * stride_slot;
        const float* v = values + r * V;
        const int32_t* c = counts + r * V;
        for (int32_t j = 0; j < V; ++j) {
          int32_t cj = std::min(std::max(c[j], 0), count_clip);
          if (cj > 0) {
            row[j] = (v[j] - means[j]) / (stds[j] + 1e-7f);
            row[V + j] = (float)cj;
          }
        }
      }
    }
  };
  for (int i = 0; i < n_threads; ++i) workers.emplace_back(work);
  for (auto& w : workers) w.join();
}

// Gather [B, T, C] anchor windows ending (exclusive) at slot_end. The
// caller checks that each window lies inside its stay's [L, C] grid.
void gather_windows(const float* grid, int64_t n_stays, int32_t L, int32_t C,
                    const int32_t* stay_rows, const int32_t* slot_end,
                    int32_t T, int64_t B, float* out, int32_t n_threads) {
  (void)n_stays;
  const int64_t stride_stay = (int64_t)L * C;
  n_threads = std::max(1, (int)n_threads);
  std::vector<std::thread> workers;
  std::atomic<int64_t> next{0};
  auto work = [&]() {
    int64_t b;
    while ((b = next.fetch_add(1)) < B) {
      const int64_t lo = (int64_t)slot_end[b] - T;
      const float* src = grid + (int64_t)stay_rows[b] * stride_stay + lo * C;
      std::memcpy(out + b * (int64_t)T * C, src, sizeof(float) * T * C);
    }
  };
  for (int i = 0; i < n_threads; ++i) workers.emplace_back(work);
  for (auto& w : workers) w.join();
}

}  // extern "C"
