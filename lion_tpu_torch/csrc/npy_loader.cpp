// Native parallel .npy point-cloud reader (the port's copy of the JAX
// package's csrc/npy_loader.cpp).
//
// The reference feeds ShapeNet15k through torch DataLoader worker processes
// (datasets/pointflow_datasets.py + data.num_workers=12); this library reads
// the split's clouds with a pool of threads instead: it parses each .npy
// header, reads the fp32/fp64 payload and fills a caller-provided
// contiguous buffer, with no Python in the read loop. It is host code, built
// with g++ (lion_tpu_torch/data/native.py), not one of the CUDA kernels.
//
// Exposed C ABI (ctypes-friendly):
//   int npy_load_batch(const char** paths, int n_files, float* out,
//                      long long n_points, int dims, int n_threads);
//     Loads n_files .npy files of shape (>=n_points, dims) into
//     out[n_files * n_points * dims] (truncating each cloud to n_points).
//     Returns 0 on success, else the (1-based) index of the failing file.
//
//   int npy_probe(const char* path, long long* shape_out /*[2]*/);
//     Parses one header; writes (rows, cols); returns 0 on success.
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  long long rows = 0;
  long long cols = 0;
  size_t data_offset = 0;
  int word_size = 0;  // 4 (f4) or 8 (f8)
  bool fortran = false;
};

bool parse_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  // descr
  size_t dpos = header.find("'descr'");
  if (dpos == std::string::npos) return false;
  size_t q1 = header.find('\'', dpos + 7);
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4" || descr == "|f4" || descr == "=f4") {
    info->word_size = 4;
  } else if (descr == "<f8" || descr == "|f8" || descr == "=f8") {
    info->word_size = 8;
  } else {
    return false;  // only float32/float64 payloads
  }
  // fortran_order
  size_t fpos = header.find("'fortran_order'");
  if (fpos != std::string::npos) {
    info->fortran = header.find("True", fpos) != std::string::npos &&
                    header.find("True", fpos) < header.find(',', fpos);
  }
  if (info->fortran) return false;  // C-order only (numpy default)
  // shape
  size_t spos = header.find("'shape'");
  if (spos == std::string::npos) return false;
  size_t p1 = header.find('(', spos);
  size_t p2 = header.find(')', p1);
  std::string shape = header.substr(p1 + 1, p2 - p1 - 1);
  long long rows = 0, cols = 1;
  if (sscanf(shape.c_str(), "%lld , %lld", &rows, &cols) < 1) {
    if (sscanf(shape.c_str(), "%lld", &rows) < 1) return false;
  }
  info->rows = rows;
  info->cols = cols;
  return true;
}

// load one cloud into out[n_points * dims], truncating rows
bool load_one(const char* path, float* out, long long n_points, int dims) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  NpyInfo info;
  if (!parse_header(f, &info) || info.rows < n_points || info.cols != dims) {
    fclose(f);
    return false;
  }
  if (fseek(f, (long)info.data_offset, SEEK_SET) != 0) {
    fclose(f);
    return false;
  }
  size_t count = (size_t)n_points * dims;
  bool ok = true;
  if (info.word_size == 4) {
    ok = fread(out, 4, count, f) == count;
  } else {
    std::vector<double> tmp(count);
    ok = fread(tmp.data(), 8, count, f) == count;
    if (ok) {
      for (size_t i = 0; i < count; ++i) out[i] = (float)tmp[i];
    }
  }
  fclose(f);
  return ok;
}

}  // namespace

extern "C" {

int npy_probe(const char* path, long long* shape_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  NpyInfo info;
  bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok) return 2;
  shape_out[0] = info.rows;
  shape_out[1] = info.cols;
  return 0;
}

int npy_load_batch(const char** paths, int n_files, float* out,
                   long long n_points, int dims, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > n_files) n_threads = n_files > 0 ? n_files : 1;

  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  size_t stride = (size_t)n_points * dims;

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_files || failed.load() != 0) break;
      if (!load_one(paths[i], out + (size_t)i * stride, n_points, dims)) {
        failed.store(i + 1);
        break;
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load();
}

}  // extern "C"
