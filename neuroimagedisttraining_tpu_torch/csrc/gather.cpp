// Multithreaded row gather of uint8 volumes on the host: dst[i] =
// src[idx[i]], rows of row_bytes each. The streamed feed (data/stream.py)
// gathers a chunk's rows with it straight into a pinned staging slab.
// A flagship row is 121*145*121 = 2.12 MB, so the copy is bound by host
// memory bandwidth and scales with threads until DRAM saturates.
//
// Plain C interface for ctypes (utils/native.py builds it with g++ at
// first use); ctypes releases the GIL for the call, so the gather runs
// beside the trainer's Python thread.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void copy_span(const uint8_t* src, const int64_t* idx, int64_t row_bytes,
               uint8_t* dst, int64_t begin, int64_t end) {
  for (int64_t i = begin; i < end; ++i) {
    std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                static_cast<size_t>(row_bytes));
  }
}

template <typename Fn>
void parallel_rows(int64_t n_rows, int n_threads, Fn fn) {
  if (n_threads <= 1 || n_rows < 2) {
    fn(0, n_rows);
    return;
  }
  std::vector<std::thread> workers;
  int64_t per = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = t * per;
    int64_t end = begin + per < n_rows ? begin + per : n_rows;
    if (begin >= end) break;
    workers.emplace_back([=] { fn(begin, end); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// dst[i] = src[idx[i]] for uint8 rows of row_bytes each.
void nidt_gather_rows_u8(const uint8_t* src, const int64_t* idx,
                         int64_t n_rows, int64_t row_bytes, uint8_t* dst,
                         int n_threads) {
  parallel_rows(n_rows, n_threads, [&](int64_t b, int64_t e) {
    copy_span(src, idx, row_bytes, dst, b, e);
  });
}

}  // extern "C"
