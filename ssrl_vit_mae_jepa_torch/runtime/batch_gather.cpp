// Native data-path kernels for the host side of the input pipeline.
//
// The reference outsources this work to 4 torch DataLoader worker PROCESSES
// (reference src/data.py:86-99: PIL decode + CPU transforms + pinned-memory
// copies). Here the host work is reduced to a gather + layout transform over
// the STL-10 binary memmap — implemented natively with a thread pool so one
// prefetch thread can saturate memory bandwidth without the GIL.
//
// Layouts:
//   raw  : (N, C, W, H) uint8   — the on-disk STL-10 binary layout
//                                 (column-major within channel)
//   out  : (B, H, W, C) uint8   — the NHWC device-upload layout
//
// out[b, h, w, c] = raw[idx[b], c, w, h]
//
// Build: g++ -O3 -shared -fPIC -pthread (see native.py).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather images at `indices` from `raw` and emit NHWC.
void gather_nhwc(const uint8_t* raw, const int64_t* indices, int64_t n_idx,
                 int64_t n_images, int64_t C, int64_t W, int64_t H,
                 uint8_t* out, int32_t n_threads) {
  const int64_t img_bytes = C * W * H;
  const int64_t out_bytes = H * W * C;
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      int64_t idx = indices[b];
      if (idx < 0 || idx >= n_images) {
        std::memset(out + b * out_bytes, 0, out_bytes);
        continue;
      }
      const uint8_t* img = raw + idx * img_bytes;  // (C, W, H)
      uint8_t* dst = out + b * out_bytes;          // (H, W, C)
      for (int64_t c = 0; c < C; ++c) {
        const uint8_t* ch = img + c * W * H;
        for (int64_t w = 0; w < W; ++w) {
          const uint8_t* col = ch + w * H;  // raw column w = pixels (h = 0..H)
          uint8_t* d = dst + w * C + c;
          for (int64_t h = 0; h < H; ++h) {
            d[h * W * C] = col[h];
          }
        }
      }
    }
  };
  if (n_threads == 1 || n_idx < 2 * n_threads) {
    worker(0, n_idx);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b0 = t * chunk;
    int64_t b1 = b0 + chunk < n_idx ? b0 + chunk : n_idx;
    if (b0 >= b1) break;
    threads.emplace_back(worker, b0, b1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
