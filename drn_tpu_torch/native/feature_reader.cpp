// Native feature reader (own copy of drn_tpu/native/feature_reader.cpp):
// mmap a .npy file (float32/float16, C order, 2-D) and linearly resample its
// rows onto a fixed temporal grid in one pass.
//
// The host side of the data path reads thousands of (T_raw, 4096) C3D
// feature files per epoch. Header parse + mmap + fused resample in C++
// skips NumPy's allocation of the raw array: only num_clips * F floats are
// written. A plain C ABI, loaded with ctypes (drn_tpu_torch/native/
// __init__.py). This is a host reader, not a device kernel.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Npy {
  const uint8_t* base = nullptr;   // mmap base
  size_t file_len = 0;
  const uint8_t* data = nullptr;   // payload
  int64_t rows = 0, cols = 0;
  int itemsize = 0;                // 4 = f4, 2 = f2
  int fd = -1;
  bool ok = false;
};

// Minimal .npy v1/v2 header parser for "<f4"/"<f2", fortran_order=False,
// exactly 2-D.
Npy open_npy(const char* path) {
  Npy n;
  n.fd = ::open(path, O_RDONLY);
  if (n.fd < 0) return n;
  struct stat st;
  if (fstat(n.fd, &st) != 0 || st.st_size < 16) return n;
  n.file_len = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, n.file_len, PROT_READ, MAP_PRIVATE, n.fd, 0);
  if (m == MAP_FAILED) return n;
  n.base = static_cast<const uint8_t*>(m);
  if (memcmp(n.base, "\x93NUMPY", 6) != 0) return n;
  const int major = n.base[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = n.base[8] | (n.base[9] << 8);
    hoff = 10;
  } else {
    hlen = n.base[8] | (n.base[9] << 8) |
           (static_cast<size_t>(n.base[10]) << 16) |
           (static_cast<size_t>(n.base[11]) << 24);
    hoff = 12;
  }
  if (hoff + hlen > n.file_len) return n;
  std::string h(reinterpret_cast<const char*>(n.base + hoff), hlen);
  if (h.find("fortran_order': True") != std::string::npos) return n;
  if (h.find("'<f4'") != std::string::npos) n.itemsize = 4;
  else if (h.find("'<f2'") != std::string::npos) n.itemsize = 2;
  else return n;
  const size_t sp = h.find("'shape':");
  if (sp == std::string::npos) return n;
  const size_t lp = h.find('(', sp);
  if (lp == std::string::npos) return n;
  const size_t rp = h.find(')', lp);
  if (rp == std::string::npos) return n;
  // Exactly two dimensions: the scan below would read the first two of
  // "(2, 3, 4)" and take a 3-D array for a 2-D one.
  int ndim = 0;
  bool in_num = false;
  for (size_t i = lp + 1; i < rp; ++i) {
    const bool digit = isdigit(static_cast<unsigned char>(h[i])) != 0;
    if (digit && !in_num) ++ndim;
    in_num = digit;
  }
  if (ndim != 2) return n;
  if (sscanf(h.c_str() + lp, "(%ld, %ld)", &n.rows, &n.cols) != 2 &&
      sscanf(h.c_str() + lp, "(%ld,%ld)", &n.rows, &n.cols) != 2)
    return n;
  if (n.rows <= 0 || n.cols <= 0) return n;
  const size_t need = hoff + hlen +
      static_cast<size_t>(n.rows) * n.cols * n.itemsize;
  if (need > n.file_len) return n;
  n.data = n.base + hoff + hlen;
  n.ok = true;
  return n;
}

void close_npy(Npy& n) {
  if (n.base) munmap(const_cast<uint8_t*>(n.base), n.file_len);
  if (n.fd >= 0) ::close(n.fd);
}

inline float load_elem(const uint8_t* row, int64_t c, int itemsize) {
  if (itemsize == 4) {
    float v;
    memcpy(&v, row + c * 4, 4);
    return v;
  }
  // IEEE half → float (no F16C dependency).
  uint16_t h;
  memcpy(&h, row + c * 2, 2);
  const uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(man & 0x400)) { man <<= 1; --exp; }
      man &= 0x3FF;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float v;
  memcpy(&v, &bits, 4);
  return v;
}

}  // namespace

extern "C" {

// Returns 0 on success. out must hold num_clips * cols floats; *cols_out is
// set to the feature dimension, *rows_out to the raw temporal length.
int fr_read_resample(const char* path, int64_t num_clips, float* out,
                     int64_t* cols_out, int64_t* rows_out,
                     int64_t max_cols) {
  Npy n = open_npy(path);
  if (!n.ok) { close_npy(n); return 1; }
  if (n.cols > max_cols) { close_npy(n); return 2; }
  *cols_out = n.cols;
  *rows_out = n.rows;
  const int64_t T = n.rows, F = n.cols, C = num_clips;
  const size_t rstride = static_cast<size_t>(F) * n.itemsize;

  if (T == C) {
    for (int64_t t = 0; t < T; ++t) {
      const uint8_t* row = n.data + t * rstride;
      float* o = out + t * F;
      if (n.itemsize == 4) {
        memcpy(o, row, F * 4);
      } else {
        for (int64_t c = 0; c < F; ++c) o[c] = load_elem(row, c, 2);
      }
    }
    close_npy(n);
    return 0;
  }

  for (int64_t i = 0; i < C; ++i) {
    // src = i * (T-1) / (C-1)  (linspace endpoints), matching
    // drn_tpu_torch.data.features.resample_features.
    double src = (C > 1) ? static_cast<double>(i) * (T - 1) / (C - 1) : 0.0;
    if (T == 1) src = 0.0;
    int64_t lo = static_cast<int64_t>(src);
    if (lo > T - 1) lo = T - 1;
    int64_t hi = lo + 1 < T ? lo + 1 : T - 1;
    const float w = static_cast<float>(src - lo);
    const uint8_t* rlo = n.data + lo * rstride;
    const uint8_t* rhi = n.data + hi * rstride;
    float* o = out + i * F;
    if (n.itemsize == 4) {
      const float* a = reinterpret_cast<const float*>(rlo);
      const float* b = reinterpret_cast<const float*>(rhi);
      const float w1 = 1.0f - w;
      for (int64_t c = 0; c < F; ++c) o[c] = a[c] * w1 + b[c] * w;
    } else {
      const float w1 = 1.0f - w;
      for (int64_t c = 0; c < F; ++c)
        o[c] = load_elem(rlo, c, 2) * w1 + load_elem(rhi, c, 2) * w;
    }
  }
  close_npy(n);
  return 0;
}

// Probe: returns rows or -1.
int64_t fr_num_rows(const char* path) {
  Npy n = open_npy(path);
  const int64_t r = n.ok ? n.rows : -1;
  close_npy(n);
  return r;
}

}  // extern "C"
