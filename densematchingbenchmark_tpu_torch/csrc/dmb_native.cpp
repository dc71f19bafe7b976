// The data pipeline's host library: PFM rows, the PNG row filters and the
// crop-and-normalise of an image, on buffers that Python hands over.
//
// Counterpart of densematchingbenchmark_tpu/native/dmb_native.cpp:29-162,
// without libpng: Python reads the file, walks the PNG chunks and inflates
// the image data with zlib (densematchingbenchmark_tpu_torch/native); this
// library undoes the row filters and converts to float32 in one pass. Every
// output is an array that numpy allocated; nothing is allocated across the
// boundary. Plain C interface, no header outside the C++ standard library:
//
//     g++ -O3 -shared -fPIC -std=c++17 -o libdmb_native.so dmb_native.cpp
//
// (ops/cuda/_build.py builds it at first use).

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// The Paeth predictor of PNG's filter type 4: left a, up b, up-left c.
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  const int bc = pb <= pc ? b : c;
  return (pa <= pb && pa <= pc) ? a : bc;
}

// Undo one row's filter in place: row[i] += predictor, with prior the
// reconstructed row above (zeros above the first) and bpp the byte offset
// of the pixel to the left. kBpp > 0 fixes bpp at compile time, so that
// Paeth's loop runs a pixel at a time (its channels' chains overlap).
template <size_t kBpp>
void unfilter_row_bpp(int filter, uint8_t* row, const uint8_t* prior,
                      size_t stride, size_t bpp_arg) {
  const size_t bpp = kBpp ? kBpp : bpp_arg;
  switch (filter) {
    case 1:  // Sub
      for (size_t i = bpp; i < stride; ++i) row[i] += row[i - bpp];
      break;
    case 2:  // Up
      for (size_t i = 0; i < stride; ++i) row[i] += prior[i];
      break;
    case 3:  // Average
      for (size_t i = 0; i < bpp; ++i) row[i] += prior[i] >> 1;
      for (size_t i = bpp; i < stride; ++i)
        row[i] += (row[i - bpp] + prior[i]) >> 1;
      break;
    case 4:  // Paeth
      for (size_t i = 0; i < bpp; ++i) row[i] += prior[i];
      for (size_t i = bpp; i < stride; i += bpp)
        for (size_t k = 0; k < bpp; ++k)
          row[i + k] += paeth(row[i + k - bpp], prior[i + k],
                              prior[i + k - bpp]);
      break;
    default:  // None
      break;
  }
}

void unfilter_row(int filter, uint8_t* row, const uint8_t* prior,
                  size_t stride, size_t bpp) {
  switch (bpp) {
    case 1: return unfilter_row_bpp<1>(filter, row, prior, stride, bpp);
    case 2: return unfilter_row_bpp<2>(filter, row, prior, stride, bpp);
    case 3: return unfilter_row_bpp<3>(filter, row, prior, stride, bpp);
    case 4: return unfilter_row_bpp<4>(filter, row, prior, stride, bpp);
    case 6: return unfilter_row_bpp<6>(filter, row, prior, stride, bpp);
    case 8: return unfilter_row_bpp<8>(filter, row, prior, stride, bpp);
    default: return unfilter_row_bpp<0>(filter, row, prior, stride, bpp);
  }
}

template <int kDepth>
inline unsigned sample(const uint8_t* row, size_t i) {
  if (kDepth == 16) return (unsigned(row[2 * i]) << 8) | row[2 * i + 1];
  return row[i];
}

// One reconstructed row -> float32: an image row of [w, 3] (gray repeated,
// alpha dropped) or a disparity row of [w, channels] / 256.
template <int kDepth>
void convert_row(const uint8_t* row, int w, int channels, int disparity,
                 float* out) {
  if (disparity) {
    const size_t n = size_t(w) * channels;
    for (size_t i = 0; i < n; ++i)
      out[i] = float(sample<kDepth>(row, i)) / 256.0f;
    return;
  }
  for (int x = 0; x < w; ++x) {
    const size_t px = size_t(x) * channels;
    for (int k = 0; k < 3; ++k)
      out[3 * size_t(x) + k] =
          float(sample<kDepth>(row, channels >= 3 ? px + k : px));
  }
}

}  // namespace

extern "C" {

// PFM data as stored (rows bottom-up, byte order from the sign of the
// scale: little_endian when it is negative) -> float32 [h, w, c] top-down.
// src holds h * w * c four-byte samples. Returns 0.
int dmb_pfm_rows(const uint8_t* src, int h, int w, int c, int little_endian,
                 float* dst) {
  uint16_t probe = 1;
  const bool swap = (little_endian != 0) !=
                    (*reinterpret_cast<uint8_t*>(&probe) == 1);
  const size_t row = size_t(w) * c;
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + size_t(h - 1 - y) * row * 4;
    float* d = dst + size_t(y) * row;
    std::memcpy(d, s, row * 4);
    if (swap) {
      for (size_t i = 0; i < row; ++i) {
        uint32_t v;
        std::memcpy(&v, d + i, 4);
        v = __builtin_bswap32(v);
        std::memcpy(d + i, &v, 4);
      }
    }
  }
  return 0;
}

// The inflated IDAT stream of a non-interlaced PNG (h rows, each a filter
// byte and w * channels * depth / 8 bytes; depth 8 or 16, channels 1-4) ->
// float32 out: [h, w, 3] for an image (disparity 0), [h, w, channels] / 256
// for a disparity (disparity 1). Any mix of the five row filters. Returns
// 0, or the largest filter byte when one is above 4 (nothing written).
int dmb_png_decode(const uint8_t* stream, int h, int w, int channels,
                   int depth, int disparity, float* out) {
  const size_t bpp = size_t(channels) * depth / 8;
  const size_t stride = size_t(w) * bpp;
  int worst = 0;
  for (int y = 0; y < h; ++y) {
    const int f = stream[size_t(y) * (stride + 1)];
    if (f > worst) worst = f;
  }
  if (worst > 4) return worst;
  std::vector<uint8_t> rows(2 * stride, 0);
  uint8_t* prior = rows.data();
  uint8_t* cur = rows.data() + stride;
  const size_t out_row = size_t(w) * (disparity ? channels : 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = stream + size_t(y) * (stride + 1);
    std::memcpy(cur, line + 1, stride);
    unfilter_row(line[0], cur, prior, stride, bpp);
    float* dst = out + size_t(y) * out_row;
    if (depth == 16)
      convert_row<16>(cur, w, channels, disparity, dst);
    else
      convert_row<8>(cur, w, channels, disparity, dst);
    uint8_t* t = prior;
    prior = cur;
    cur = t;
  }
  return 0;
}

// dst[th, tw, c] = (src[y1:y1+th, x1:x1+tw, :] - mean[c]) / std[c]
void dmb_normalize_crop(const float* src, int src_h, int src_w, int c,
                        int y1, int x1, int th, int tw, const float* mean,
                        const float* stdev, float* dst) {
  (void)src_h;
  for (int y = 0; y < th; ++y) {
    const float* srow = src + (size_t(y1 + y) * src_w + x1) * c;
    float* drow = dst + size_t(y) * tw * c;
    for (int x = 0; x < tw; ++x)
      for (int k = 0; k < c; ++k)
        drow[x * c + k] = (srow[x * c + k] - mean[k]) / stdev[k];
  }
}

}  // extern "C"
