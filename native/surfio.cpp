// Native IO runtime for the SURF/SLAM framework.
//
// The reference implements its host runtime in C++ (image IO through
// OpenCV, main.cpp:173-182; pitched staging buffers, main.cpp:212-226).
// This build keeps the compute path in JAX/XLA and implements
// the host-side IO runtime natively here: fast PGM/PPM codecs and a
// threaded prefetching sequence loader that decodes frames ahead of the
// accelerator (the host->device pipeline the demo/SLAM loops drive).
//
// Exposed as a plain C ABI consumed via ctypes (cuda_surf_tpu/io/native.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, channels = 0;
  std::vector<uint8_t> data;
};

// ---------------------------------------------------------------------
// PGM / PPM codec (binary P5/P6 and ascii P2/P3, 8-bit)
// ---------------------------------------------------------------------

bool skip_ws(const std::vector<uint8_t>& buf, size_t& pos) {
  while (pos < buf.size()) {
    if (isspace(buf[pos])) {
      pos++;
    } else if (buf[pos] == '#') {
      while (pos < buf.size() && buf[pos] != '\n') pos++;
    } else {
      return true;
    }
  }
  return false;
}

bool parse_int(const std::vector<uint8_t>& buf, size_t& pos, long* out) {
  if (!skip_ws(buf, pos)) return false;
  char* end = nullptr;
  const char* start = reinterpret_cast<const char*>(buf.data()) + pos;
  long v = strtol(start, &end, 10);
  if (end == start) return false;
  pos += static_cast<size_t>(end - start);
  *out = v;
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) {
    fclose(f);
    return false;
  }
  out->resize(static_cast<size_t>(n));
  size_t got = fread(out->data(), 1, out->size(), f);
  fclose(f);
  return got == out->size();
}

bool decode_pnm(const std::vector<uint8_t>& buf, Image* img) {
  if (buf.size() < 2 || buf[0] != 'P') return false;
  char kind = static_cast<char>(buf[1]);
  int channels = (kind == '6' || kind == '3') ? 3 : 1;
  bool ascii = (kind == '2' || kind == '3');
  if (kind != '2' && kind != '3' && kind != '5' && kind != '6') return false;
  size_t pos = 2;
  long w, h, maxval;
  if (!parse_int(buf, pos, &w) || !parse_int(buf, pos, &h) ||
      !parse_int(buf, pos, &maxval))
    return false;
  if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 65535) return false;
  // Reject implausible dimensions before allocating: a corrupt header
  // must not drive a multi-GB resize (std::bad_alloc across the C ABI).
  if (w > (1 << 16) || h > (1 << 16) ||
      static_cast<long long>(w) * h > (1LL << 28))
    return false;
  size_t count = static_cast<size_t>(w) * h * channels;
  img->w = static_cast<int>(w);
  img->h = static_cast<int>(h);
  img->channels = channels;
  img->data.resize(count);
  if (ascii) {
    for (size_t i = 0; i < count; i++) {
      long v;
      if (!parse_int(buf, pos, &v)) return false;
      img->data[i] = static_cast<uint8_t>(maxval > 255 ? v * 255 / maxval : v);
    }
    return true;
  }
  pos++;  // single whitespace after maxval
  if (maxval > 255) {
    if (pos + count * 2 > buf.size()) return false;
    for (size_t i = 0; i < count; i++) {
      unsigned v = (buf[pos + 2 * i] << 8) | buf[pos + 2 * i + 1];
      img->data[i] = static_cast<uint8_t>(v * 255 / maxval);
    }
    return true;
  }
  if (pos + count > buf.size()) return false;
  memcpy(img->data.data(), buf.data() + pos, count);
  return true;
}

void to_gray(Image* img) {
  if (img->channels == 1) return;
  std::vector<uint8_t> gray(static_cast<size_t>(img->w) * img->h);
  const uint8_t* p = img->data.data();
  for (size_t i = 0; i < gray.size(); i++) {
    // BT.601, matching the framework's Python loader
    gray[i] = static_cast<uint8_t>(
        (299 * p[3 * i] + 587 * p[3 * i + 1] + 114 * p[3 * i + 2] + 500) /
        1000);
  }
  img->data = std::move(gray);
  img->channels = 1;
}

// ---------------------------------------------------------------------
// Prefetching sequence loader
// ---------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  size_t next_decode = 0;   // next frame the worker will decode
  size_t next_read = 0;     // next frame the consumer will take
  size_t depth;
  std::vector<Image> ring;  // slot = frame % depth
  std::vector<int> ready;   // 0 empty, 1 ready, -1 decode error
  std::mutex mu;
  std::condition_variable cv_producer, cv_consumer;
  std::atomic<bool> stop{false};
  std::thread worker;
};

void loader_worker(Loader* L) {
  while (true) {
    size_t frame;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_producer.wait(lk, [&] {
        return L->stop || (L->next_decode < L->paths.size() &&
                           L->next_decode < L->next_read + L->depth);
      });
      if (L->stop || L->next_decode >= L->paths.size()) return;
      frame = L->next_decode++;
    }
    std::vector<uint8_t> buf;
    Image img;
    bool ok = read_file(L->paths[frame].c_str(), &buf) &&
              decode_pnm(buf, &img);
    if (ok) to_gray(&img);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      size_t slot = frame % L->depth;
      L->ring[slot] = std::move(img);
      L->ready[slot] = ok ? 1 : -1;
    }
    L->cv_consumer.notify_all();
  }
}

}  // namespace

extern "C" {

// Decode a PGM/PPM to grayscale. Two-phase: pass data=nullptr to query
// (w, h); then pass a buffer of `cap` bytes. Returns 0 on success, -1 on
// decode error, -3 if the decoded frame does not fit `cap` (e.g. the
// file changed between the size query and the fill — never overruns the
// caller's allocation).
int surfio_read_gray(const char* path, int* w, int* h, uint8_t* data,
                     long cap) {
  std::vector<uint8_t> buf;
  Image img;
  if (!read_file(path, &buf) || !decode_pnm(buf, &img)) return -1;
  to_gray(&img);
  *w = img.w;
  *h = img.h;
  if (data) {
    if (cap < 0 || static_cast<size_t>(cap) < img.data.size()) return -3;
    memcpy(data, img.data.data(), img.data.size());
  }
  return 0;
}

int surfio_write_pgm(const char* path, int w, int h, const uint8_t* data) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P5\n%d %d\n255\n", w, h);
  size_t n = static_cast<size_t>(w) * h;
  bool ok = fwrite(data, 1, n, f) == n;
  fclose(f);
  return ok ? 0 : -1;
}

int surfio_write_ppm(const char* path, int w, int h, const uint8_t* data) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P6\n%d %d\n255\n", w, h);
  size_t n = static_cast<size_t>(w) * h * 3;
  bool ok = fwrite(data, 1, n, f) == n;
  fclose(f);
  return ok ? 0 : -1;
}

// Open a prefetching loader over `count` NUL-separated paths.  `depth`
// frames are decoded ahead on a background thread.
void* surfio_loader_open(const char* paths, int count, int depth) {
  Loader* L = new Loader();
  const char* p = paths;
  for (int i = 0; i < count; i++) {
    L->paths.emplace_back(p);
    p += L->paths.back().size() + 1;
  }
  L->depth = depth < 1 ? 1 : static_cast<size_t>(depth);
  L->ring.resize(L->depth);
  L->ready.assign(L->depth, 0);
  L->worker = std::thread(loader_worker, L);
  return L;
}

// Blocking: fetch the next frame.  Two-phase like surfio_read_gray.
// Returns 0 ok, -1 decode error, -2 end of sequence, -3 buffer too
// small (frame NOT consumed — re-query and retry).
int surfio_loader_next(void* handle, int* w, int* h, uint8_t* data,
                       long cap) {
  Loader* L = static_cast<Loader*>(handle);
  if (L->next_read >= L->paths.size()) return -2;
  size_t frame = L->next_read;
  size_t slot = frame % L->depth;
  int state;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_producer.notify_all();
    L->cv_consumer.wait(lk, [&] { return L->ready[slot] != 0; });
    state = L->ready[slot];
    Image& img = L->ring[slot];
    *w = img.w;
    *h = img.h;
    if (state == 1 && data) {
      if (cap < 0 || static_cast<size_t>(cap) < img.data.size()) return -3;
      memcpy(data, img.data.data(), img.data.size());
    }
    if (data || state != 1) {  // consume the slot
      L->ready[slot] = 0;
      L->next_read++;
      L->cv_producer.notify_all();
    }
  }
  return state == 1 ? 0 : -1;
}

void surfio_loader_close(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_producer.notify_all();
  L->worker.join();
  delete L;
}

}  // extern "C"
