// Native multi-threaded image-stack loader.
//
// The port's copy of remotesensingproject_tpu/native/loader.cpp, with the
// same C ABI: the host-side counterpart of the reference's I/O substrate
// (OpenCV imread driven by rslf::read_imgs_from_folder,
// src/rslf_io.cpp:46-96).  Decodes a folder of frames into one dense
// float32 [S, H, W, C] buffer using a thread pool, so host-side ingest
// keeps up with the device.  Built with g++ at first use by loader.py.
//
// Formats: classic TIFF (uncompressed or LZW; u8/u16/f32, 1 or 3
// samples — covers the bundled Skysat data), PNG via libpng (gray8/16,
// rgb8; a palette is expanded to RGB), JPEG via libjpeg (gray/RGB — the
// Mansion RGB sequences are .jpg), and PGM/PPM (binary).  Values are
// returned RAW (e.g. u8 stays 0..255) with a dtype code so the Python
// side preserves the reference's normalization semantics (u8 -> /255,
// float -> /max).
//
// C API (ctypes):
//   int rslf_read_stack(const char* folder, const char** names, int count,
//                       const char* ext, void* out /*float32*/,
//                       int dims[4] /*H,W,C,dtype*/, int probe_only);
// dtype codes: 0=u8, 1=u16, 2=f32.  Returns 0 on success.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <png.h>

#include <csetjmp>
#include <cstdio>  // jpeglib.h needs FILE
#include <jpeglib.h>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  int dtype = 2;  // 0=u8 1=u16 2=f32
  std::vector<float> data;  // h*w*c
  bool ok = false;
};

// ---------------------------------------------------------------- file IO
std::vector<uint8_t> read_file(const std::string& path) {
  std::vector<uint8_t> buf;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return buf;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf.resize(n);
  if (fread(buf.data(), 1, n, f) != static_cast<size_t>(n)) buf.clear();
  fclose(f);
  return buf;
}

// ------------------------------------------------------------------ TIFF
uint16_t rd16(const uint8_t* p, bool be) {
  return be ? (p[0] << 8) | p[1] : (p[1] << 8) | p[0];
}
uint32_t rd32(const uint8_t* p, bool be) {
  return be ? (uint32_t(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3]
            : (uint32_t(p[3]) << 24) | (p[2] << 16) | (p[1] << 8) | p[0];
}

// TIFF LZW decompressor (TIFF6 spec variant: codes grow at 511/1023/2047,
// early change).
bool lzw_decode(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  struct Entry { int prev; uint8_t ch; int len; };
  std::vector<Entry> table(4096);
  auto reset = [&]() {
    for (int i = 0; i < 256; i++) table[i] = {-1, uint8_t(i), 1};
  };
  reset();
  int next_code = 258, bits = 9;
  uint32_t acc = 0;
  int nbits = 0;
  size_t pos = 0;
  int prev_code = -1;
  std::vector<uint8_t> scratch;
  auto emit = [&](int code) {
    scratch.clear();
    int c = code;
    while (c >= 0) {
      scratch.push_back(table[c].ch);
      c = table[c].prev;
    }
    for (size_t i = scratch.size(); i-- > 0;) out.push_back(scratch[i]);
  };
  auto first_char = [&](int code) {
    int c = code;
    while (table[c].prev >= 0) c = table[c].prev;
    return table[c].ch;
  };
  while (pos < n || nbits >= bits) {
    while (nbits < bits && pos < n) {
      acc = (acc << 8) | src[pos++];
      nbits += 8;
    }
    if (nbits < bits) break;
    int code = (acc >> (nbits - bits)) & ((1 << bits) - 1);
    nbits -= bits;
    if (code == 256) {  // clear
      reset();
      next_code = 258;
      bits = 9;
      prev_code = -1;
      continue;
    }
    if (code == 257) break;  // EOI
    if (prev_code < 0) {
      emit(code);
      prev_code = code;
      continue;
    }
    if (code < next_code) {
      emit(code);
      table[next_code] = {prev_code, first_char(code),
                          table[prev_code].len + 1};
    } else if (code == next_code) {
      table[next_code] = {prev_code, first_char(prev_code),
                          table[prev_code].len + 1};
      emit(code);
    } else {
      return false;
    }
    next_code++;
    // TIFF "early change": width grows at 511/1023/2047 (TIFF6 LZW).
    if (next_code == 511) bits = 10;
    else if (next_code == 1023) bits = 11;
    else if (next_code == 2047) bits = 12;
    prev_code = code;
  }
  return true;
}

Image decode_tiff(const std::vector<uint8_t>& buf) {
  Image img;
  if (buf.size() < 8) return img;
  bool be;
  if (buf[0] == 'I' && buf[1] == 'I') be = false;
  else if (buf[0] == 'M' && buf[1] == 'M') be = true;
  else return img;
  if (rd16(&buf[2], be) != 42) return img;
  uint32_t ifd = rd32(&buf[4], be);
  if (ifd + 2 > buf.size()) return img;
  uint16_t nent = rd16(&buf[ifd], be);

  uint32_t width = 0, height = 0, comp = 1, spp = 1, sfmt = 1;
  std::vector<uint32_t> bits, strip_offs, strip_counts, rows_per_strip;
  auto read_values = [&](const uint8_t* e, std::vector<uint32_t>& vals) {
    uint16_t type = rd16(e + 2, be);
    uint32_t cnt = rd32(e + 4, be);
    int sz = (type == 3) ? 2 : (type == 4 ? 4 : (type == 1 ? 1 : 0));
    if (!sz) return;
    const uint8_t* p;
    if (sz * cnt <= 4) p = e + 8;
    else {
      uint32_t off = rd32(e + 8, be);
      if (off + sz * cnt > buf.size()) return;
      p = &buf[off];
    }
    for (uint32_t i = 0; i < cnt; i++) {
      vals.push_back(sz == 2 ? rd16(p + 2 * i, be)
                             : sz == 4 ? rd32(p + 4 * i, be)
                                       : p[i]);
    }
  };
  for (int i = 0; i < nent; i++) {
    const uint8_t* e = &buf[ifd + 2 + 12 * i];
    uint16_t tag = rd16(e, be);
    std::vector<uint32_t> vals;
    switch (tag) {
      case 256: read_values(e, vals); if (!vals.empty()) width = vals[0]; break;
      case 257: read_values(e, vals); if (!vals.empty()) height = vals[0]; break;
      case 258: read_values(e, bits); break;
      case 259: read_values(e, vals); if (!vals.empty()) comp = vals[0]; break;
      case 273: read_values(e, strip_offs); break;
      case 277: read_values(e, vals); if (!vals.empty()) spp = vals[0]; break;
      case 278: read_values(e, rows_per_strip); break;
      case 279: read_values(e, strip_counts); break;
      case 339: read_values(e, vals); if (!vals.empty()) sfmt = vals[0]; break;
      default: break;
    }
  }
  if (!width || !height || strip_offs.empty()) return img;
  if (comp != 1 && comp != 5) return img;
  uint32_t bps = bits.empty() ? 8 : bits[0];
  if (!(bps == 8 || bps == 16 || bps == 32)) return img;
  if (bps == 32 && sfmt != 3) return img;  // only float32
  if (spp != 1 && spp != 3) return img;

  size_t bytes_per_px = (bps / 8) * spp;
  size_t total = size_t(width) * height * bytes_per_px;
  std::vector<uint8_t> raw;
  raw.reserve(total);
  for (size_t si = 0; si < strip_offs.size(); si++) {
    uint32_t off = strip_offs[si];
    uint32_t cnt = si < strip_counts.size() ? strip_counts[si] : 0;
    if (off + cnt > buf.size()) return img;
    if (comp == 1) {
      raw.insert(raw.end(), &buf[off], &buf[off + cnt]);
    } else {
      if (!lzw_decode(&buf[off], cnt, raw)) return img;
    }
  }
  if (raw.size() < total) return img;

  img.h = height;
  img.w = width;
  img.c = spp;
  img.dtype = bps == 8 ? 0 : (bps == 16 ? 1 : 2);
  img.data.resize(size_t(height) * width * spp);
  const uint8_t* p = raw.data();
  size_t npx = size_t(height) * width * spp;
  if (bps == 8) {
    for (size_t i = 0; i < npx; i++) img.data[i] = p[i];
  } else if (bps == 16) {
    for (size_t i = 0; i < npx; i++) img.data[i] = rd16(p + 2 * i, be);
  } else {
    for (size_t i = 0; i < npx; i++) {
      uint32_t v = rd32(p + 4 * i, be);
      float f;
      memcpy(&f, &v, 4);
      img.data[i] = f;
    }
  }
  img.ok = true;
  return img;
}

// ------------------------------------------------------------------- PNG
Image decode_png(const std::vector<uint8_t>& buf) {
  Image img;
  if (png_sig_cmp(buf.data(), 0, 8)) return img;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return img;
  }
  struct Reader {
    const uint8_t* p;
    size_t n, pos;
  } rd{buf.data(), buf.size(), 0};
  png_set_read_fn(png, &rd, [](png_structp p, png_bytep out,
                               png_size_t len) {
    auto* r = static_cast<Reader*>(png_get_io_ptr(p));
    if (r->pos + len > r->n) png_error(p, "eof");
    memcpy(out, r->p + r->pos, len);
    r->pos += len;
  });
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color, nullptr, nullptr,
               nullptr);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // want little-endian u16
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> data(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 i = 0; i < h; i++) rows[i] = &data[i * rowbytes];
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);

  img.h = h;
  img.w = w;
  img.c = channels;
  img.dtype = bit_depth == 16 ? 1 : 0;
  img.data.resize(size_t(h) * w * channels);
  if (bit_depth == 16) {
    const uint16_t* p16 = reinterpret_cast<const uint16_t*>(data.data());
    for (size_t i = 0; i < img.data.size(); i++) img.data[i] = p16[i];
  } else {
    for (size_t i = 0; i < img.data.size(); i++) img.data[i] = data[i];
  }
  img.ok = true;
  return img;
}

// ------------------------------------------------------------------ JPEG
// Baseline/progressive JPEG via libjpeg (the Mansion RGB sequences are
// .jpg — cv::imread in the reference wraps the same library;
// tests/test_build_row_epi_mansion_resized.cpp:24).
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

Image decode_jpeg(const std::vector<uint8_t>& buf) {
  Image img;
  // the row buffer is declared BEFORE setjmp so a libjpeg error_exit
  // longjmp never jumps over a live non-trivially-destructible local
  // (that would be UB and leak the buffer on every corrupt frame) —
  // both vectors live in this frame and are destroyed on return
  std::vector<uint8_t> row;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    img.ok = false;
    return img;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf.data(), buf.size());
  jpeg_read_header(&cinfo, TRUE);
  // grayscale stays 1-ch; everything else (YCbCr, CMYK...) -> RGB,
  // matching cv::imread's channel semantics (the Python side flips
  // nothing: the repo is RGB-ordered throughout)
  cinfo.out_color_space =
      cinfo.jpeg_color_space == JCS_GRAYSCALE ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  int c = cinfo.output_components;
  img.h = h;
  img.w = w;
  img.c = c;
  img.dtype = 0;  // JPEG is 8-bit
  img.data.resize(size_t(h) * w * c);
  row.resize(size_t(w) * c);
  JSAMPROW rp = row.data();
  for (int y = 0; y < h; y++) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = &img.data[size_t(y) * w * c];
    for (size_t i = 0; i < row.size(); i++) dst[i] = row[i];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  img.ok = true;
  return img;
}

// ------------------------------------------------------------------- PNM
Image decode_pnm(const std::vector<uint8_t>& buf) {
  Image img;
  if (buf.size() < 2 || buf[0] != 'P') return img;
  int kind = buf[1] - '0';
  if (kind != 5 && kind != 6) return img;
  size_t pos = 2;
  auto next_int = [&]() -> long {
    while (pos < buf.size()) {
      if (isspace(buf[pos])) { pos++; continue; }
      if (buf[pos] == '#') { while (pos < buf.size() && buf[pos] != '\n') pos++; continue; }
      break;
    }
    long v = 0;
    while (pos < buf.size() && isdigit(buf[pos])) v = v * 10 + (buf[pos++] - '0');
    return v;
  };
  long w = next_int(), h = next_int(), maxv = next_int();
  pos++;  // single whitespace
  int c = kind == 5 ? 1 : 3;
  int bytes = maxv > 255 ? 2 : 1;
  size_t need = size_t(w) * h * c * bytes;
  if (pos + need > buf.size()) return img;
  img.h = h; img.w = w; img.c = c;
  img.dtype = bytes == 2 ? 1 : 0;
  img.data.resize(size_t(w) * h * c);
  const uint8_t* p = &buf[pos];
  if (bytes == 1) {
    for (size_t i = 0; i < img.data.size(); i++) img.data[i] = p[i];
  } else {
    for (size_t i = 0; i < img.data.size(); i++)
      img.data[i] = (p[2 * i] << 8) | p[2 * i + 1];  // PNM is big-endian
  }
  img.ok = true;
  return img;
}

Image decode_any(const std::string& path) {
  std::vector<uint8_t> buf = read_file(path);
  if (buf.size() < 8) return Image{};
  if ((buf[0] == 'I' && buf[1] == 'I') || (buf[0] == 'M' && buf[1] == 'M'))
    return decode_tiff(buf);
  if (buf[0] == 0x89 && buf[1] == 'P') return decode_png(buf);
  if (buf[0] == 0xFF && buf[1] == 0xD8) return decode_jpeg(buf);
  if (buf[0] == 'P') return decode_pnm(buf);
  return Image{};
}

}  // namespace

extern "C" int rslf_read_stack(const char* folder, const char** names,
                               int count, const char* ext, void* out,
                               int* dims, int probe_only) {
  if (count <= 0) return 1;
  std::string base(folder);
  if (!base.empty() && base.back() != '/') base += '/';
  std::string e(ext);
  if (!e.empty() && e[0] == '.') e = e.substr(1);

  Image first = decode_any(base + names[0] + "." + e);
  if (!first.ok) return 2;
  dims[0] = first.h;
  dims[1] = first.w;
  dims[2] = first.c;
  dims[3] = first.dtype;
  if (probe_only) return 0;

  float* dst = static_cast<float*>(out);
  size_t frame_px = size_t(first.h) * first.w * first.c;
  memcpy(dst, first.data.data(), frame_px * sizeof(float));

  std::atomic<int> next(1), failed(0);
  int nthreads = std::min<int>(std::thread::hardware_concurrency(),
                               std::max(1, count - 1));
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; t++) {
    pool.emplace_back([&]() {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= count) return;
        Image im = decode_any(base + names[i] + "." + e);
        if (!im.ok || im.h != dims[0] || im.w != dims[1] ||
            im.c != dims[2]) {
          failed.store(1);
          return;
        }
        memcpy(dst + frame_px * i, im.data.data(),
               frame_px * sizeof(float));
      }
    });
  }
  for (auto& th : pool) th.join();
  return failed.load() ? 3 : 0;
}
