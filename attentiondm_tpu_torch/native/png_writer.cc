// Multithreaded PNG batch writer (C++ / zlib), exposed via a C ABI for ctypes
// (a copy of attentiondm_tpu/native/png_writer.cc; each file is written under
// "<name>.tmp" and renamed into place, so an interrupted run leaves no
// half-written <id>.png).
//
// Purpose: the 50k-image FID generation path must write tens of thousands of
// PNGs; single-threaded PIL encoding costs minutes of host time and would
// dominate the <10-min sampling budget.  This writer encodes RGB8 images in
// a thread pool (zlib deflate, fast setting) and writes
// <prefix><start_index + i>.png for each image in the batch.
//
// Build: g++ -O2 -shared -fPIC -pthread png_writer.cc -lz -o libpngwriter.so
// (attentiondm_tpu_torch/native/__init__.py builds it at first use).
//
// C ABI:
//   int write_png_batch(const unsigned char* data,  // N*H*W*3, row-major
//                       int n, int h, int w,
//                       const char* prefix,          // e.g. "/out/dir/"
//                       long start_index,
//                       int num_threads);            // <=0 -> hw threads
//   returns 0 on success, else the number of failed images.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

void put_u32_be(std::vector<unsigned char>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

void append_chunk(std::vector<unsigned char>& out, const char type[4],
                  const unsigned char* data, size_t len) {
  put_u32_be(out, static_cast<uint32_t>(len));
  size_t crc_start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + crc_start, static_cast<uInt>(len + 4));
  put_u32_be(out, crc);
}

// Encode one H x W RGB8 image to an in-memory PNG.
bool encode_png(const unsigned char* rgb, int h, int w,
                std::vector<unsigned char>& out) {
  out.clear();
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);

  unsigned char ihdr[13];
  uint32_t wbe = static_cast<uint32_t>(w), hbe = static_cast<uint32_t>(h);
  ihdr[0] = (wbe >> 24) & 0xff; ihdr[1] = (wbe >> 16) & 0xff;
  ihdr[2] = (wbe >> 8) & 0xff;  ihdr[3] = wbe & 0xff;
  ihdr[4] = (hbe >> 24) & 0xff; ihdr[5] = (hbe >> 16) & 0xff;
  ihdr[6] = (hbe >> 8) & 0xff;  ihdr[7] = hbe & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: truecolor RGB
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  append_chunk(out, "IHDR", ihdr, 13);

  // raw scanlines with filter byte 0
  const size_t stride = static_cast<size_t>(w) * 3;
  std::vector<unsigned char> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;
    std::memcpy(&raw[y * (stride + 1) + 1], rgb + y * stride, stride);
  }

  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<unsigned char> comp(bound);
  // level 1: fast; PNG size matters less than encode throughput here
  if (compress2(comp.data(), &bound, raw.data(),
                static_cast<uLong>(raw.size()), 1) != Z_OK) {
    return false;
  }
  append_chunk(out, "IDAT", comp.data(), bound);
  append_chunk(out, "IEND", nullptr, 0);
  return true;
}

bool write_file(const std::string& path, const std::vector<unsigned char>& buf) {
  const std::string tmp = path + ".tmp";
  std::FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) return false;
  size_t n = std::fwrite(buf.data(), 1, buf.size(), f);
  bool ok = std::fclose(f) == 0 && n == buf.size();
  return ok && std::rename(tmp.c_str(), path.c_str()) == 0;
}

}  // namespace

extern "C" int write_png_batch(const unsigned char* data, int n, int h, int w,
                               const char* prefix, long start_index,
                               int num_threads) {
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  if (num_threads > n) num_threads = n > 0 ? n : 1;

  std::atomic<int> next(0), failed(0);
  const size_t img_bytes = static_cast<size_t>(h) * w * 3;
  std::string pre(prefix);

  auto worker = [&]() {
    std::vector<unsigned char> buf;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (!encode_png(data + i * img_bytes, h, w, buf) ||
          !write_file(pre + std::to_string(start_index + i) + ".png", buf)) {
        failed.fetch_add(1);
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failed.load();
}
