// Native PNG + Targa codecs for the image-I/O runtime.
//
// The reference bundles imageLib (middlebury/flow-code/imageLib/, ~2.3 kLoC)
// whose ImageIOpng.cpp reads/writes 8-bit gray/RGB/RGBA PNGs via libpng and
// whose ImageIO.cpp handles Targa types 1/2/3/9/10/11.  This file is the
// framework's native equivalent with the same practical scope: 8-bit
// gray/RGB/RGBA PNG (non-interlaced) implemented directly on zlib (inflate /
// deflate + the five PNG row filters), and Targa types 2/3/10/11 (raw + RLE,
// top-down or bottom-up).  Original implementation; only the file formats are
// shared with the reference.
//
// Error contract matches flowio_native.cpp: 0 on success, negative code
// otherwise; no exceptions cross the C ABI.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

enum ErrorCode : int {
  kOk = 0,
  kOpenFailed = -1,
  kBadMagic = -2,
  kBadDims = -3,
  kShortRead = -4,
  kLongFile = -5,
  kWriteFailed = -6,
  kBadArg = -7,
  kUnsupported = -8,
  kCorrupt = -9,
  kZlibError = -10,
  kNoMem = -11,
};

// Keep the no-exceptions error contract even under allocation failure:
// std::bad_alloc from the std::vector buffers must not escape the C ABI.
template <typename Fn>
int guarded(Fn&& fn) {
  try {
    return fn();
  } catch (const std::bad_alloc&) {
    return kNoMem;
  } catch (...) {
    return kCorrupt;
  }
}

struct File {
  std::FILE* f;
  explicit File(const char* path, const char* mode) : f(std::fopen(path, mode)) {}
  ~File() {
    if (f) std::fclose(f);
  }
};

constexpr int kMaxDim = 99999;

// ---- PNG --------------------------------------------------------------------

constexpr unsigned char kPngSig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};

std::uint32_t be32(const unsigned char* p) {
  return (std::uint32_t(p[0]) << 24) | (std::uint32_t(p[1]) << 16) |
         (std::uint32_t(p[2]) << 8) | std::uint32_t(p[3]);
}

void put_be32(unsigned char* p, std::uint32_t v) {
  p[0] = v >> 24;
  p[1] = v >> 16;
  p[2] = v >> 8;
  p[3] = v;
}

struct PngInfo {
  int w = 0, h = 0, channels = 0;
  std::vector<unsigned char> idat;  // concatenated zlib stream
};

int channels_for_color_type(int ct) {
  switch (ct) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // RGBA
    default: return 0;  // 3 = palette: unsupported
  }
}

// Parse signature + chunks.  With want_data, collects the IDAT stream and
// verifies the needed chunks' CRCs; otherwise stops after IHDR.  Chunks that
// are not needed (ancillary, or anything past IHDR in dims-only mode) are
// fseek'd past without buffering, and total IDAT accumulation is capped by
// the decoded size's zlib expansion bound, so a hostile header cannot force
// gigabyte allocations before validation.
int png_parse(std::FILE* f, PngInfo* info, bool want_data) {
  unsigned char sig[8];
  if (std::fread(sig, 1, 8, f) != 8) return kShortRead;
  if (std::memcmp(sig, kPngSig, 8) != 0) return kBadMagic;
  bool saw_ihdr = false, saw_iend = false;
  std::uint64_t idat_cap = 0;
  while (!saw_iend) {
    unsigned char hdr[8];
    if (std::fread(hdr, 1, 8, f) != 8) return kShortRead;
    const std::uint32_t len = be32(hdr);
    if (len > (1u << 30)) return kCorrupt;
    const bool is_ihdr = std::memcmp(hdr + 4, "IHDR", 4) == 0;
    const bool is_idat = std::memcmp(hdr + 4, "IDAT", 4) == 0;
    const bool is_iend = std::memcmp(hdr + 4, "IEND", 4) == 0;
    const bool need = is_ihdr || (want_data && is_idat);
    std::vector<unsigned char> data;
    if (need) {
      data.resize(len);
      if (len && std::fread(data.data(), 1, len, f) != len) return kShortRead;
      unsigned char crcb[4];
      if (std::fread(crcb, 1, 4, f) != 4) return kShortRead;
      uLong crc = crc32(0L, hdr + 4, 4);
      if (len) crc = crc32(crc, data.data(), len);
      if (crc != be32(crcb)) return kCorrupt;
    } else {
      // skip payload + CRC without buffering (ancillary chunks etc.)
      if (std::fseek(f, static_cast<long>(len) + 4, SEEK_CUR) != 0)
        return kShortRead;
    }
    if (is_ihdr) {
      if (len != 13) return kCorrupt;
      info->w = static_cast<int>(be32(&data[0]));
      info->h = static_cast<int>(be32(&data[4]));
      const int depth = data[8], color = data[9];
      const int compression = data[10], filter = data[11], interlace = data[12];
      if (info->w < 1 || info->w > kMaxDim || info->h < 1 || info->h > kMaxDim)
        return kBadDims;
      if (compression != 0 || filter != 0) return kCorrupt;
      if (depth != 8 || interlace != 0) return kUnsupported;  // no 16-bit/Adam7
      info->channels = channels_for_color_type(color);
      if (info->channels == 0) return kUnsupported;  // palette
      // compressed stream cannot usefully exceed the decoded size plus the
      // zlib worst-case expansion margin
      const std::uint64_t decoded =
          static_cast<std::uint64_t>(info->h) *
          (static_cast<std::uint64_t>(info->w) * info->channels + 1);
      idat_cap = decoded + decoded / 8 + (1u << 16);
      saw_ihdr = true;
      if (!want_data) return kOk;
    } else if (is_idat) {
      if (!saw_ihdr) return kCorrupt;
      if (static_cast<std::uint64_t>(info->idat.size()) + len > idat_cap)
        return kLongFile;
      info->idat.insert(info->idat.end(), data.begin(), data.end());
    } else if (is_iend) {
      saw_iend = true;
    }
  }
  if (!saw_ihdr || (want_data && info->idat.empty())) return kCorrupt;
  return kOk;
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Reverse the per-row PNG filters in place on the raw (filter byte + row) data.
int png_unfilter(std::vector<unsigned char>& raw, int w, int h, int bpp,
                 unsigned char* out) {
  const size_t stride = static_cast<size_t>(w) * bpp;
  if (raw.size() != static_cast<size_t>(h) * (stride + 1)) return kCorrupt;
  std::vector<unsigned char> prev(stride, 0);
  for (int y = 0; y < h; ++y) {
    const unsigned char* src = raw.data() + static_cast<size_t>(y) * (stride + 1);
    const int ft = src[0];
    unsigned char* row = out + static_cast<size_t>(y) * stride;
    std::memcpy(row, src + 1, stride);
    switch (ft) {
      case 0:
        break;
      case 1:  // Sub
        for (size_t i = bpp; i < stride; ++i) row[i] += row[i - bpp];
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i) row[i] += prev[i];
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= static_cast<size_t>(bpp) ? row[i - bpp] : 0;
          row[i] += static_cast<unsigned char>((a + prev[i]) >> 1);
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= static_cast<size_t>(bpp) ? row[i - bpp] : 0;
          const int c = i >= static_cast<size_t>(bpp) ? prev[i - bpp] : 0;
          row[i] += static_cast<unsigned char>(paeth(a, prev[i], c));
        }
        break;
      default:
        return kCorrupt;
    }
    std::memcpy(prev.data(), row, stride);
  }
  return kOk;
}

int zlib_inflate_all(const std::vector<unsigned char>& in,
                     std::vector<unsigned char>& out) {
  uLongf dst_len = out.size();
  const int rc = uncompress(out.data(), &dst_len, in.data(), in.size());
  if (rc != Z_OK || dst_len != out.size()) return kZlibError;
  return kOk;
}

int write_chunk(std::FILE* f, const char type[4], const unsigned char* data,
                std::uint32_t len) {
  unsigned char hdr[8];
  put_be32(hdr, len);
  std::memcpy(hdr + 4, type, 4);
  uLong crc = crc32(0L, hdr + 4, 4);
  if (len) crc = crc32(crc, data, len);
  unsigned char crcb[4];
  put_be32(crcb, static_cast<std::uint32_t>(crc));
  if (std::fwrite(hdr, 1, 8, f) != 8) return kWriteFailed;
  if (len && std::fwrite(data, 1, len, f) != len) return kWriteFailed;
  if (std::fwrite(crcb, 1, 4, f) != 4) return kWriteFailed;
  return kOk;
}

// ---- Targa ------------------------------------------------------------------

struct TgaInfo {
  int w = 0, h = 0, channels = 0;
  int img_type = 0, id_len = 0;
  bool top_down = false;
};

int tga_parse_header(std::FILE* f, TgaInfo* t) {
  unsigned char h[18];
  if (std::fread(h, 1, 18, f) != 18) return kShortRead;
  t->id_len = h[0];
  const int cmap_type = h[1];
  t->img_type = h[2];
  t->w = h[12] | (h[13] << 8);
  t->h = h[14] | (h[15] << 8);
  const int bpp = h[16];
  const int descr = h[17];
  t->top_down = (descr & 0x20) != 0;
  if ((descr & 0xC0) != 0) return kUnsupported;  // legacy 2/4-way interleave
  if (cmap_type != 0) return kUnsupported;  // no palettes
  if (t->w < 1 || t->w > kMaxDim || t->h < 1 || t->h > kMaxDim) return kBadDims;
  switch (t->img_type) {
    case 2:
    case 10:  // truecolor (raw / RLE), BGR or BGRA
      if (bpp == 24) t->channels = 3;
      else if (bpp == 32) t->channels = 4;
      else return kUnsupported;
      break;
    case 3:
    case 11:  // grayscale (raw / RLE)
      if (bpp != 8) return kUnsupported;
      t->channels = 1;
      break;
    default:
      return kUnsupported;
  }
  return kOk;
}

// Decode the pixel stream (raw or RLE) into file order: npix pixels of
// `channels` bytes each, still BGR(A) for truecolor.
int tga_decode_pixels(std::FILE* f, const TgaInfo& t,
                      std::vector<unsigned char>& buf) {
  const size_t npix = static_cast<size_t>(t.w) * t.h;
  const int ch = t.channels;
  buf.resize(npix * ch);
  if (t.img_type == 2 || t.img_type == 3) {
    if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) return kShortRead;
    return kOk;
  }
  // RLE packets
  size_t got = 0;
  unsigned char px[4];
  while (got < npix) {
    const int hdr = std::fgetc(f);
    if (hdr == EOF) return kShortRead;
    const size_t count = static_cast<size_t>(hdr & 0x7f) + 1;
    if (got + count > npix) return kCorrupt;
    if (hdr & 0x80) {  // run packet: one pixel repeated
      if (std::fread(px, 1, ch, f) != static_cast<size_t>(ch)) return kShortRead;
      for (size_t i = 0; i < count; ++i)
        std::memcpy(buf.data() + (got + i) * ch, px, ch);
    } else {  // raw packet
      if (std::fread(buf.data() + got * ch, 1, count * ch, f) != count * ch)
        return kShortRead;
    }
    got += count;
  }
  return kOk;
}

void bgr_swap(unsigned char* row, int w, int ch) {
  if (ch < 3) return;
  for (int x = 0; x < w; ++x) {
    unsigned char* p = row + static_cast<size_t>(x) * ch;
    const unsigned char tmp = p[0];
    p[0] = p[2];
    p[2] = tmp;
  }
}

}  // namespace

extern "C" {

// ---- PNG API ----------------------------------------------------------------

int bbme_png_dims(const char* path, int* w, int* h, int* channels) {
  return guarded([&]() -> int {
    File fp(path, "rb");
    if (!fp.f) return kOpenFailed;
    PngInfo info;
    if (int rc = png_parse(fp.f, &info, /*want_data=*/false)) return rc;
    *w = info.w;
    *h = info.h;
    *channels = info.channels;
    return kOk;
  });
}

// out must hold w*h*channels bytes (row-major, RGB(A)/gray interleaved).
int bbme_png_read(const char* path, unsigned char* out, int w, int h,
                  int channels) {
  return guarded([&]() -> int {
    File fp(path, "rb");
    if (!fp.f) return kOpenFailed;
    PngInfo info;
    if (int rc = png_parse(fp.f, &info, /*want_data=*/true)) return rc;
    if (info.w != w || info.h != h || info.channels != channels)
      return kBadDims;
    const size_t stride = static_cast<size_t>(w) * channels;
    std::vector<unsigned char> raw(static_cast<size_t>(h) * (stride + 1));
    if (int rc = zlib_inflate_all(info.idat, raw)) return rc;
    return png_unfilter(raw, w, h, channels, out);
  });
}

static int png_write_impl(const char* path, const unsigned char* data, int w,
                          int h, int channels);

// data: w*h*channels bytes, channels in {1,2,3,4} -> gray/gray+A/RGB/RGBA.
int bbme_png_write(const char* path, const unsigned char* data, int w, int h,
                   int channels) {
  return guarded([&]() -> int { return png_write_impl(path, data, w, h, channels); });
}

static int png_write_impl(const char* path, const unsigned char* data, int w,
                          int h, int channels) {
  static const int kColorType[5] = {-1, 0, 4, 2, 6};
  if (w < 1 || w > kMaxDim || h < 1 || h > kMaxDim || channels < 1 ||
      channels > 4)
    return kBadArg;
  const size_t stride = static_cast<size_t>(w) * channels;
  std::vector<unsigned char> raw(static_cast<size_t>(h) * (stride + 1));
  for (int y = 0; y < h; ++y) {
    unsigned char* dst = raw.data() + static_cast<size_t>(y) * (stride + 1);
    dst[0] = 0;  // filter: None
    std::memcpy(dst + 1, data + static_cast<size_t>(y) * stride, stride);
  }
  uLongf zcap = compressBound(raw.size());
  std::vector<unsigned char> zbuf(zcap);
  if (compress2(zbuf.data(), &zcap, raw.data(), raw.size(),
                Z_DEFAULT_COMPRESSION) != Z_OK)
    return kZlibError;

  File fp(path, "wb");
  if (!fp.f) return kOpenFailed;
  if (std::fwrite(kPngSig, 1, 8, fp.f) != 8) return kWriteFailed;
  unsigned char ihdr[13];
  put_be32(ihdr, static_cast<std::uint32_t>(w));
  put_be32(ihdr + 4, static_cast<std::uint32_t>(h));
  ihdr[8] = 8;  // bit depth
  ihdr[9] = static_cast<unsigned char>(kColorType[channels]);
  ihdr[10] = ihdr[11] = ihdr[12] = 0;  // compression/filter/interlace
  if (int rc = write_chunk(fp.f, "IHDR", ihdr, 13)) return rc;
  // split the zlib stream into <= 1 GiB IDAT chunks: a single chunk's length
  // field is uint32 (< 2^31 per spec), which huge images could overflow
  const uLongf kChunkMax = 1u << 30;
  for (uLongf off = 0; off < zcap; off += kChunkMax) {
    const uLongf n = zcap - off < kChunkMax ? zcap - off : kChunkMax;
    if (int rc = write_chunk(fp.f, "IDAT", zbuf.data() + off,
                             static_cast<std::uint32_t>(n)))
      return rc;
  }
  return write_chunk(fp.f, "IEND", nullptr, 0);
}

// ---- Targa API ---------------------------------------------------------------

int bbme_tga_dims(const char* path, int* w, int* h, int* channels) {
  return guarded([&]() -> int {
    File fp(path, "rb");
    if (!fp.f) return kOpenFailed;
    TgaInfo t;
    if (int rc = tga_parse_header(fp.f, &t)) return rc;
    *w = t.w;
    *h = t.h;
    *channels = t.channels;
    return kOk;
  });
}

// out must hold w*h*channels bytes; truecolor is returned as RGB(A) and rows
// are top-down regardless of the file's origin bit.
int bbme_tga_read(const char* path, unsigned char* out, int w, int h,
                  int channels) {
  return guarded([&]() -> int {
    File fp(path, "rb");
    if (!fp.f) return kOpenFailed;
    TgaInfo t;
    if (int rc = tga_parse_header(fp.f, &t)) return rc;
    if (t.w != w || t.h != h || t.channels != channels) return kBadDims;
    if (t.id_len && std::fseek(fp.f, t.id_len, SEEK_CUR) != 0)
      return kShortRead;
    std::vector<unsigned char> buf;
    if (int rc = tga_decode_pixels(fp.f, t, buf)) return rc;
    const size_t stride = static_cast<size_t>(w) * channels;
    for (int y = 0; y < h; ++y) {
      const int src_y = t.top_down ? y : h - 1 - y;
      unsigned char* dst = out + static_cast<size_t>(y) * stride;
      std::memcpy(dst, buf.data() + static_cast<size_t>(src_y) * stride,
                  stride);
      bgr_swap(dst, w, channels);
    }
    return kOk;
  });
}

// data: top-down RGB(A) or gray; rle selects run-length packets (types 10/11)
// vs raw (types 2/3).  Written with the top-down origin bit set.
static int tga_write_impl(const char* path, const unsigned char* data, int w,
                          int h, int channels, int rle);

int bbme_tga_write(const char* path, const unsigned char* data, int w, int h,
                   int channels, int rle) {
  return guarded(
      [&] { return tga_write_impl(path, data, w, h, channels, rle); });
}

static int tga_write_impl(const char* path, const unsigned char* data, int w,
                          int h, int channels, int rle) {
  if (w < 1 || w > kMaxDim || h < 1 || h > kMaxDim ||
      (channels != 1 && channels != 3 && channels != 4))
    return kBadArg;
  File fp(path, "wb");
  if (!fp.f) return kOpenFailed;
  unsigned char hdr[18] = {0};
  hdr[2] = static_cast<unsigned char>(channels == 1 ? (rle ? 11 : 3)
                                                    : (rle ? 10 : 2));
  hdr[12] = w & 0xff;
  hdr[13] = (w >> 8) & 0xff;
  hdr[14] = h & 0xff;
  hdr[15] = (h >> 8) & 0xff;
  hdr[16] = static_cast<unsigned char>(channels * 8);
  hdr[17] = 0x20 | (channels == 4 ? 8 : 0);  // top-down; 8 alpha bits for RGBA
  if (std::fwrite(hdr, 1, 18, fp.f) != 18) return kWriteFailed;

  const size_t stride = static_cast<size_t>(w) * channels;
  std::vector<unsigned char> row(stride);
  for (int y = 0; y < h; ++y) {
    std::memcpy(row.data(), data + static_cast<size_t>(y) * stride, stride);
    bgr_swap(row.data(), w, channels);  // file stores BGR(A)
    if (!rle) {
      if (std::fwrite(row.data(), 1, stride, fp.f) != stride)
        return kWriteFailed;
      continue;
    }
    // RLE packets never cross row boundaries (de-facto Targa convention).
    int x = 0;
    while (x < w) {
      const unsigned char* px = row.data() + static_cast<size_t>(x) * channels;
      int run = 1;
      while (x + run < w && run < 128 &&
             std::memcmp(px, px + static_cast<size_t>(run) * channels,
                         channels) == 0)
        ++run;
      if (run >= 2) {
        const unsigned char pkt = static_cast<unsigned char>(0x80 | (run - 1));
        if (std::fputc(pkt, fp.f) == EOF ||
            std::fwrite(px, 1, channels, fp.f) != static_cast<size_t>(channels))
          return kWriteFailed;
        x += run;
      } else {
        // literal packet: extend until the next >=2 run or 128 pixels
        int lit = 1;
        while (x + lit < w && lit < 128) {
          const unsigned char* q =
              row.data() + static_cast<size_t>(x + lit) * channels;
          if (x + lit + 1 < w &&
              std::memcmp(q, q + channels, channels) == 0)
            break;
          ++lit;
        }
        const unsigned char pkt = static_cast<unsigned char>(lit - 1);
        if (std::fputc(pkt, fp.f) == EOF ||
            std::fwrite(px, 1, static_cast<size_t>(lit) * channels, fp.f) !=
                static_cast<size_t>(lit) * channels)
          return kWriteFailed;
        x += lit;
      }
    }
  }
  return kOk;
}

}  // extern "C"
