// Native host-side batch assembly for the training data pipeline.
//
// The reference delegates its loading to torch's DataLoader (single-process:
// its num_workers config is never wired through, reference train.py:21 vs
// generate_data.py:298).  Here batch assembly -- the shuffled row-gather of
// several float32 feature arrays into contiguous per-batch buffers -- runs in
// C++ worker threads with the GIL released, so host batch prep overlaps with
// device compute.  Exposed through a minimal C ABI (ctypes; no pybind11).
//
// Built at first use by admmnet_tpu_torch/data/loader.py (g++, one
// translation unit, no dependencies) into build/native/ at the repository
// root.  The shuffle (SplitMix64-seeded Fisher-Yates) is the JAX package's
// native loader's, bit for bit, so both trainers draw the same minibatches.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct GatherJob {
  const float* src;      // (rows, cols) row-major
  float* dst;            // (n_idx, cols)
  const int64_t* idx;    // row indices
  int64_t n_idx;
  int64_t cols;
};

void run_gather(const GatherJob& job, int64_t begin, int64_t end) {
  const int64_t cols = job.cols;
  for (int64_t i = begin; i < end; ++i) {
    const float* s = job.src + job.idx[i] * cols;
    std::memcpy(job.dst + i * cols, s, sizeof(float) * cols);
  }
}

}  // namespace

extern "C" {

// Gather rows from one array: dst[i, :] = src[idx[i], :], multithreaded.
void fl_gather_rows(const float* src, int64_t rows, int64_t cols,
                    const int64_t* idx, int64_t n_idx, float* dst,
                    int n_threads) {
  (void)rows;
  GatherJob job{src, dst, idx, n_idx, cols};
  if (n_threads <= 1 || n_idx < 256) {
    run_gather(job, 0, n_idx);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min<int64_t>(n_idx, b + chunk);
    if (b >= e) break;
    ts.emplace_back([job, b, e] { run_gather(job, b, e); });
  }
  for (auto& t : ts) t.join();
}

// Gather the same index set from many arrays (one batch across all features).
// srcs/dsts are arrays of pointers; colss gives each array's row width.
void fl_gather_batch(const float** srcs, float** dsts, const int64_t* colss,
                     int n_arrays, const int64_t* idx, int64_t n_idx,
                     int n_threads) {
  std::atomic<int> next{0};
  auto worker = [&] {
    for (;;) {
      const int a = next.fetch_add(1);
      if (a >= n_arrays) return;
      GatherJob job{srcs[a], dsts[a], idx, n_idx, colss[a]};
      run_gather(job, 0, n_idx);
    }
  };
  const int nt = std::max(1, std::min(n_threads, n_arrays));
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

// Fisher-Yates shuffle of [0, n) with SplitMix64 seeded deterministically.
void fl_shuffle_indices(int64_t* idx, int64_t n, uint64_t seed) {
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  uint64_t x = seed + 0x9E3779B97F4A7C15ULL;
  auto next_u64 = [&x]() {
    x += 0x9E3779B97F4A7C15ULL;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  };
  for (int64_t i = n - 1; i > 0; --i) {
    const int64_t j = static_cast<int64_t>(next_u64() % (i + 1));
    std::swap(idx[i], idx[j]);
  }
}

}  // extern "C"
