// tiffio.cpp — native GeoTIFF reader for the floodplanet_code_tpu_torch data layer.
//
// The reference pipeline reads rasters through the tifffile/rasterio C
// libraries (st_water_seg/datasets/floodplanet.py:309-318) and re-reads the
// *entire scene per tile* (floodplanet.py:605-609, its biggest inefficiency).
// This reader is the TPU build's native replacement: strip/tile-aware
// *windowed* decode so each crop touches only the bytes it needs, exposed to
// Python via ctypes (floodplanet_code_tpu_torch/geo/tiff.py).
//
// Supported: classic TIFF (magic 42) and BigTIFF (magic 43, 64-bit
// offsets/LONG8 arrays), either byte order (II/MM), striped or tiled
// layout, PlanarConfig
// 1 (interleaved) and 2 (band-sequential), SamplesPerPixel >= 1,
// BitsPerSample 8/16/32/64, SampleFormat uint/int/float, Compression none
// (1), LZW (5), Deflate (8 / 32946), PackBits (32773), horizontal Predictor
// (2). Output is always band-sequential (CHW) in the file's native dtype.
//
// Build: g++ -O3 -shared -fPIC tiffio.cpp -o libtiffio.so -lz

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <zlib.h>

#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <thread>

namespace {

thread_local std::string g_error;

void set_error(const std::string &msg) { g_error = msg; }

struct TiffTag {
  uint16_t tag = 0;
  uint16_t type = 0;
  uint64_t count = 0;
  std::vector<uint64_t> values;   // integral values
  std::vector<double> dvalues;    // rational/double values
  std::vector<uint8_t> raw;       // raw bytes (for ASCII/UNDEFINED passthrough)
};

size_t type_size(uint16_t type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;   // BYTE, ASCII, SBYTE, UNDEF
    case 3: case 8: return 2;                   // SHORT, SSHORT
    case 4: case 9: case 11: return 4;          // LONG, SLONG, FLOAT
    case 5: case 10: case 12: return 8;         // RATIONAL, SRATIONAL, DOUBLE
    case 16: case 17: case 18: return 8;        // LONG8, SLONG8, IFD8 (BigTIFF)
    default: return 0;
  }
}

struct Reader {
  int fd = -1;  // pread-based access => handle is safe to share across threads
  bool big_endian = false;
  bool bigtiff = false;  // magic 43: 8-byte offsets, 20-byte IFD entries

  // Image geometry.
  uint32_t width = 0, height = 0;
  uint32_t samples = 1;
  uint32_t bits = 8;
  uint32_t sample_format = 1;  // 1 uint, 2 int, 3 float
  uint32_t compression = 1;
  uint32_t planar = 1;
  uint32_t predictor = 1;
  // Strips.
  uint32_t rows_per_strip = 0;
  std::vector<uint64_t> strip_offsets, strip_counts;
  // Tiles.
  uint32_t tile_width = 0, tile_height = 0;
  std::vector<uint64_t> tile_offsets, tile_counts;

  std::vector<TiffTag> all_tags;  // kept for geo-tag passthrough

  ~Reader() {
    if (fd >= 0) close(fd);
  }

  uint16_t rd16(const uint8_t *p) const {
    return big_endian ? (uint16_t)((p[0] << 8) | p[1])
                      : (uint16_t)((p[1] << 8) | p[0]);
  }
  uint32_t rd32(const uint8_t *p) const {
    return big_endian
               ? ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                     ((uint32_t)p[2] << 8) | p[3]
               : ((uint32_t)p[3] << 24) | ((uint32_t)p[2] << 16) |
                     ((uint32_t)p[1] << 8) | p[0];
  }
  uint64_t rd64(const uint8_t *p) const {
    return big_endian ? ((uint64_t)rd32(p) << 32) | rd32(p + 4)
                      : ((uint64_t)rd32(p + 4) << 32) | rd32(p);
  }

  size_t dtype_bytes() const { return bits / 8; }

  bool read_at(uint64_t off, void *dst, size_t n) {
    uint8_t *p = (uint8_t *)dst;
    size_t done = 0;
    while (done < n) {
      ssize_t got = pread(fd, p + done, n - done, (off_t)(off + done));
      if (got <= 0) return false;
      done += (size_t)got;
    }
    return true;
  }

  bool parse_tag_values(TiffTag &t, const uint8_t *entry) {
    size_t esz = type_size(t.type);
    if (esz == 0) return true;  // unknown type: skip values, keep header
    // Guard against corrupt tag counts BEFORE multiplying: BigTIFF counts
    // are u64, so esz * count could wrap (e.g. count=2^61, esz=8 -> 0)
    // and bypass a post-multiplication size check entirely.
    const size_t kMaxTagBytes = size_t(64) << 20;  // 64 MB
    if (t.count > kMaxTagBytes / esz) return false;
    size_t total = esz * (size_t)t.count;
    std::vector<uint8_t> buf(total);
    // Classic entries carry a 4-byte value/offset field at +8; BigTIFF
    // entries an 8-byte one at +12 (count is 8 bytes).
    const size_t value_at = bigtiff ? 12 : 8;
    const size_t inline_max = bigtiff ? 8 : 4;
    if (total <= inline_max) {
      memcpy(buf.data(), entry + value_at, total);
    } else {
      uint64_t off = bigtiff ? rd64(entry + value_at) : rd32(entry + value_at);
      if (!read_at(off, buf.data(), total)) return false;
    }
    t.raw = buf;
    for (uint64_t i = 0; i < t.count; ++i) {
      const uint8_t *p = buf.data() + i * esz;
      switch (t.type) {
        case 1: case 2: case 7: t.values.push_back(p[0]); break;
        case 6: t.values.push_back((uint64_t)(int64_t)(int8_t)p[0]); break;
        case 3: t.values.push_back(rd16(p)); break;
        case 8: t.values.push_back((uint64_t)(int64_t)(int16_t)rd16(p)); break;
        case 4: t.values.push_back(rd32(p)); break;
        case 9: t.values.push_back((uint64_t)(int64_t)(int32_t)rd32(p)); break;
        case 11: {
          uint32_t v = rd32(p);
          float f;
          memcpy(&f, &v, 4);
          t.dvalues.push_back(f);
          break;
        }
        case 5: case 10: {
          uint32_t num = rd32(p), den = rd32(p + 4);
          t.dvalues.push_back(den ? (double)num / den : 0.0);
          break;
        }
        case 12: {
          uint64_t v = ((uint64_t)rd32(p + (big_endian ? 0 : 4)) << 32) |
                       rd32(p + (big_endian ? 4 : 0));
          double d;
          memcpy(&d, &v, 8);
          t.dvalues.push_back(d);
          break;
        }
        case 16: case 18: t.values.push_back(rd64(p)); break;
        case 17: t.values.push_back((uint64_t)(int64_t)rd64(p)); break;
      }
    }
    return true;
  }

  bool open(const char *path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) {
      set_error(std::string("cannot open file: ") + path);
      return false;
    }
    uint8_t hdr[8];
    if (!read_at(0, hdr, 8)) {
      set_error("truncated TIFF header");
      return false;
    }
    if (hdr[0] == 'I' && hdr[1] == 'I') big_endian = false;
    else if (hdr[0] == 'M' && hdr[1] == 'M') big_endian = true;
    else {
      set_error("not a TIFF file (bad byte order mark)");
      return false;
    }
    uint16_t magic = rd16(hdr + 2);
    if (magic != 42 && magic != 43) {
      set_error("not a TIFF file (bad magic)");
      return false;
    }
    uint64_t ifd_off;
    if (magic == 43) {
      // BigTIFF: u16 offset-size (must be 8), u16 pad (0), u64 IFD offset.
      bigtiff = true;
      uint8_t hdr2[16];
      if (!read_at(0, hdr2, 16)) {
        set_error("truncated BigTIFF header");
        return false;
      }
      if (rd16(hdr2 + 4) != 8 || rd16(hdr2 + 6) != 0) {
        set_error("malformed BigTIFF header (offset size != 8)");
        return false;
      }
      ifd_off = rd64(hdr2 + 8);
    } else {
      ifd_off = rd32(hdr + 4);
    }

    // IFD: classic = u16 count + 12-byte entries; BigTIFF = u64 count +
    // 20-byte entries.
    const size_t entry_size = bigtiff ? 20 : 12;
    uint64_t n_entries;
    if (bigtiff) {
      uint8_t cntb[8];
      if (!read_at(ifd_off, cntb, 8)) {
        set_error("cannot read IFD");
        return false;
      }
      n_entries = rd64(cntb);
    } else {
      uint8_t cntb[2];
      if (!read_at(ifd_off, cntb, 2)) {
        set_error("cannot read IFD");
        return false;
      }
      n_entries = rd16(cntb);
    }
    if (n_entries > 65536) {
      set_error("implausible IFD entry count");
      return false;
    }
    std::vector<uint8_t> entries(entry_size * (size_t)n_entries);
    if (!read_at(ifd_off + (bigtiff ? 8 : 2), entries.data(),
                 entries.size())) {
      set_error("cannot read IFD entries");
      return false;
    }

    for (uint64_t i = 0; i < n_entries; ++i) {
      const uint8_t *e = entries.data() + entry_size * (size_t)i;
      TiffTag t;
      t.tag = rd16(e);
      t.type = rd16(e + 2);
      t.count = bigtiff ? rd64(e + 4) : rd32(e + 4);
      if (!parse_tag_values(t, e)) {
        set_error("cannot read tag values");
        return false;
      }
      const auto &v = t.values;
      // Malformed zero-count tags must not abort the process (.at(0) would
      // throw through the extern "C" boundary); treat them as absent.
      uint32_t v0 = v.empty() ? 0 : (uint32_t)v[0];
      switch (t.tag) {
        case 256: width = v0; break;
        case 257: height = v0; break;
        case 258: if (!v.empty()) bits = v0; break;
        case 259: if (!v.empty()) compression = v0; break;
        case 273: strip_offsets = v; break;
        case 277: if (!v.empty()) samples = v0; break;
        case 278: if (!v.empty()) rows_per_strip = v0; break;
        case 279: strip_counts = v; break;
        case 284: if (!v.empty()) planar = v0; break;
        case 317: if (!v.empty()) predictor = v0; break;
        case 322: tile_width = v0; break;
        case 323: tile_height = v0; break;
        case 324: tile_offsets = v; break;
        case 325: tile_counts = v; break;
        case 339: if (!v.empty()) sample_format = v0; break;
      }
      all_tags.push_back(std::move(t));
    }
    if (width == 0 || height == 0) {
      set_error("missing image dimensions");
      return false;
    }
    if (bits != 8 && bits != 16 && bits != 32 && bits != 64) {
      set_error("unsupported BitsPerSample: " + std::to_string(bits));
      return false;
    }
    if (strip_offsets.empty() && tile_offsets.empty()) {
      set_error("no strip or tile offsets");
      return false;
    }
    if (rows_per_strip == 0) rows_per_strip = height;
    return true;
  }

  // ---- codecs -------------------------------------------------------------

  static bool packbits_decode(const uint8_t *src, size_t n, uint8_t *dst,
                              size_t dst_n) {
    size_t si = 0, di = 0;
    while (si < n && di < dst_n) {
      int8_t c = (int8_t)src[si++];
      if (c >= 0) {
        size_t run = (size_t)c + 1;
        if (si + run > n || di + run > dst_n) return false;
        memcpy(dst + di, src + si, run);
        si += run;
        di += run;
      } else if (c != -128) {
        size_t run = (size_t)(-c) + 1;
        if (si >= n || di + run > dst_n) return false;
        memset(dst + di, src[si++], run);
        di += run;
      }
    }
    return di == dst_n;
  }

  static bool zlib_decode(const uint8_t *src, size_t n, uint8_t *dst,
                          size_t dst_n) {
    uLongf out_len = dst_n;
    int rc = uncompress(dst, &out_len, src, n);
    return rc == Z_OK && out_len == dst_n;
  }

  // TIFF-variant LZW: MSB-first codes, ClearCode 256, EOI 257, early change.
  static bool lzw_decode(const uint8_t *src, size_t n, uint8_t *dst,
                         size_t dst_n) {
    struct Entry {
      int32_t prev;   // previous entry index or -1
      uint8_t byte;   // last byte
      uint32_t len;   // chain length
    };
    std::vector<Entry> table;
    table.reserve(4096);
    auto reset_table = [&]() {
      table.clear();
      for (int i = 0; i < 256; ++i) table.push_back({-1, (uint8_t)i, 1});
      table.push_back({-1, 0, 0});  // 256 clear
      table.push_back({-1, 0, 0});  // 257 EOI
    };
    reset_table();

    size_t di = 0;
    uint32_t bitpos = 0;
    uint32_t code_width = 9;
    int32_t prev_code = -1;
    std::vector<uint8_t> chain;

    auto emit = [&](int32_t code) -> bool {
      chain.clear();
      int32_t c = code;
      while (c >= 0) {
        chain.push_back(table[c].byte);
        c = table[c].prev;
      }
      size_t len = chain.size();
      if (di + len > dst_n) return false;
      for (size_t i = 0; i < len; ++i) dst[di + i] = chain[len - 1 - i];
      di += len;
      return true;
    };
    auto first_byte = [&](int32_t code) -> uint8_t {
      int32_t c = code;
      while (table[c].prev >= 0) c = table[c].prev;
      return table[c].byte;
    };

    while (true) {
      if ((bitpos + code_width) > n * 8) break;
      uint32_t byte_idx = bitpos >> 3;
      uint32_t avail = (uint32_t)(n - byte_idx);
      uint32_t word = 0;
      for (uint32_t i = 0; i < 4 && i < avail; ++i)
        word = (word << 8) | src[byte_idx + i];
      for (uint32_t i = avail; i < 4; ++i) word <<= 8;
      uint32_t shift = 32 - (bitpos & 7) - code_width;
      uint32_t code = (word >> shift) & ((1u << code_width) - 1);
      bitpos += code_width;

      if (code == 257) break;  // EOI
      if (code == 256) {       // Clear
        reset_table();
        code_width = 9;
        prev_code = -1;
        continue;
      }
      if (prev_code < 0) {
        if (code >= table.size()) return false;
        if (!emit((int32_t)code)) return false;
        prev_code = (int32_t)code;
      } else {
        if (code < table.size()) {
          if (!emit((int32_t)code)) return false;
          table.push_back({prev_code, first_byte((int32_t)code),
                           table[prev_code].len + 1});
        } else if (code == table.size()) {
          uint8_t fb = first_byte(prev_code);
          table.push_back({prev_code, fb, table[prev_code].len + 1});
          if (!emit((int32_t)(table.size() - 1))) return false;
        } else {
          return false;
        }
        prev_code = (int32_t)code;
      }
      // "Early change": widen one code before the table is actually full.
      if (table.size() + 1 >= (1ull << code_width) && code_width < 12)
        ++code_width;
      if (di >= dst_n) break;
    }
    return di == dst_n;
  }

  // Decode one strip/tile payload into `dst` (expected decoded size).
  bool decode_chunk(uint64_t offset, uint64_t count, uint8_t *dst,
                    size_t decoded) {
    if (compression == 1) {
      size_t n = count < decoded ? (size_t)count : decoded;
      if (!read_at(offset, dst, n)) return false;
      if (n < decoded) memset(dst + n, 0, decoded - n);
      return true;
    }
    std::vector<uint8_t> comp(count);
    if (!read_at(offset, comp.data(), count)) return false;
    switch (compression) {
      case 5: return lzw_decode(comp.data(), comp.size(), dst, decoded);
      case 8:
      case 32946: return zlib_decode(comp.data(), comp.size(), dst, decoded);
      case 32773: return packbits_decode(comp.data(), comp.size(), dst, decoded);
      default:
        set_error("unsupported compression: " + std::to_string(compression));
        return false;
    }
  }

  // Undo horizontal differencing over one row. `total` is the number of
  // values in the row; `stride` is the per-pixel sample stride (1 for
  // planar, SamplesPerPixel for contiguous).
  void undo_predictor(uint8_t *row, size_t total, size_t stride) {
    size_t esz = dtype_bytes();
    if (esz == 1) {
      for (size_t i = stride; i < total; ++i)
        row[i] = (uint8_t)(row[i] + row[i - stride]);
    } else if (esz == 2) {
      uint16_t *r = (uint16_t *)row;
      for (size_t i = stride; i < total; ++i)
        r[i] = (uint16_t)(r[i] + r[i - stride]);
    } else if (esz == 4) {
      uint32_t *r = (uint32_t *)row;
      for (size_t i = stride; i < total; ++i)
        r[i] = r[i] + r[i - stride];
    }
  }

  void byteswap(uint8_t *buf, size_t n_elems) {
    size_t esz = dtype_bytes();
    if (!big_endian || esz == 1) return;
    for (size_t i = 0; i < n_elems; ++i) {
      uint8_t *p = buf + i * esz;
      for (size_t a = 0, b = esz - 1; a < b; ++a, --b) {
        uint8_t t = p[a];
        p[a] = p[b];
        p[b] = t;
      }
    }
  }

  // ---- windowed read ------------------------------------------------------
  // dst: band-sequential [samples, ny, nx] in native dtype.
  bool read_window(int64_t y0, int64_t x0, int64_t ny, int64_t nx,
                   uint8_t *dst) {
    if (y0 < 0 || x0 < 0 || ny <= 0 || nx <= 0 || y0 + ny > height ||
        x0 + nx > width) {
      set_error("window out of bounds");
      return false;
    }
    size_t esz = dtype_bytes();
    if (!tile_offsets.empty()) return read_window_tiled(y0, x0, ny, nx, dst);

    // Striped layout.
    uint32_t strips_per_plane = (height + rows_per_strip - 1) / rows_per_strip;
    uint32_t planes = (planar == 2) ? samples : 1;
    uint32_t row_values = (planar == 2) ? width : width * samples;
    std::vector<uint8_t> strip_buf((size_t)rows_per_strip * row_values * esz);

    uint32_t s_begin = (uint32_t)(y0 / rows_per_strip);
    uint32_t s_end = (uint32_t)((y0 + ny - 1) / rows_per_strip);

    for (uint32_t plane = 0; plane < planes; ++plane) {
      for (uint32_t s = s_begin; s <= s_end; ++s) {
        uint64_t strip_idx = (uint64_t)plane * strips_per_plane + s;
        if (strip_idx >= strip_offsets.size()) {
          set_error("strip index out of range");
          return false;
        }
        uint32_t strip_row0 = s * rows_per_strip;
        uint32_t strip_rows = rows_per_strip;
        if (strip_row0 + strip_rows > height) strip_rows = height - strip_row0;
        size_t decoded = (size_t)strip_rows * row_values * esz;
        if (!decode_chunk(strip_offsets[strip_idx],
                          strip_idx < strip_counts.size()
                              ? strip_counts[strip_idx]
                              : decoded,
                          strip_buf.data(), decoded))
          return false;
        byteswap(strip_buf.data(), (size_t)strip_rows * row_values);
        if (predictor == 2) {
          size_t stride = (planar == 2) ? 1 : samples;
          for (uint32_t r = 0; r < strip_rows; ++r)
            undo_predictor(strip_buf.data() + (size_t)r * row_values * esz,
                           row_values, stride);
        }
        // Copy the window part of each row.
        int64_t r_lo = y0 > strip_row0 ? y0 - strip_row0 : 0;
        int64_t r_hi = (y0 + ny) < (strip_row0 + strip_rows)
                           ? (y0 + ny - strip_row0)
                           : strip_rows;
        for (int64_t r = r_lo; r < r_hi; ++r) {
          int64_t out_row = strip_row0 + r - y0;
          const uint8_t *src_row =
              strip_buf.data() + (size_t)r * row_values * esz;
          if (planar == 2) {
            uint8_t *out = dst + ((size_t)plane * ny * nx + out_row * nx) * esz;
            memcpy(out, src_row + (size_t)x0 * esz, (size_t)nx * esz);
          } else {
            // De-interleave contiguous samples into CHW planes.
            for (uint32_t smp = 0; smp < samples; ++smp) {
              uint8_t *out =
                  dst + ((size_t)smp * ny * nx + out_row * nx) * esz;
              const uint8_t *in = src_row + ((size_t)x0 * samples + smp) * esz;
              if (esz == 1) {
                for (int64_t x = 0; x < nx; ++x) out[x] = in[x * samples];
              } else if (esz == 2) {
                uint16_t *o16 = (uint16_t *)out;
                const uint16_t *i16 = (const uint16_t *)in;
                for (int64_t x = 0; x < nx; ++x) o16[x] = i16[x * samples];
              } else if (esz == 4) {
                uint32_t *o32 = (uint32_t *)out;
                const uint32_t *i32 = (const uint32_t *)in;
                for (int64_t x = 0; x < nx; ++x) o32[x] = i32[x * samples];
              } else {
                for (int64_t x = 0; x < nx; ++x)
                  memcpy(out + x * esz, in + (size_t)x * samples * esz, esz);
              }
            }
          }
        }
      }
    }
    return true;
  }

  bool read_window_tiled(int64_t y0, int64_t x0, int64_t ny, int64_t nx,
                         uint8_t *dst) {
    size_t esz = dtype_bytes();
    uint32_t tiles_x = (width + tile_width - 1) / tile_width;
    uint32_t tiles_y = (height + tile_height - 1) / tile_height;
    uint32_t planes = (planar == 2) ? samples : 1;
    uint32_t tile_values =
        (planar == 2) ? tile_width : tile_width * samples;
    std::vector<uint8_t> tile_buf((size_t)tile_height * tile_values * esz);

    uint32_t ty0 = (uint32_t)(y0 / tile_height);
    uint32_t ty1 = (uint32_t)((y0 + ny - 1) / tile_height);
    uint32_t tx0 = (uint32_t)(x0 / tile_width);
    uint32_t tx1 = (uint32_t)((x0 + nx - 1) / tile_width);

    for (uint32_t plane = 0; plane < planes; ++plane) {
      for (uint32_t ty = ty0; ty <= ty1; ++ty) {
        for (uint32_t tx = tx0; tx <= tx1; ++tx) {
          uint64_t tidx =
              ((uint64_t)plane * tiles_y + ty) * tiles_x + tx;
          if (tidx >= tile_offsets.size()) {
            set_error("tile index out of range");
            return false;
          }
          size_t decoded = (size_t)tile_height * tile_values * esz;
          if (!decode_chunk(tile_offsets[tidx],
                            tidx < tile_counts.size() ? tile_counts[tidx]
                                                      : decoded,
                            tile_buf.data(), decoded))
            return false;
          byteswap(tile_buf.data(), (size_t)tile_height * tile_values);
          if (predictor == 2) {
            size_t stride = (planar == 2) ? 1 : samples;
            for (uint32_t r = 0; r < tile_height; ++r)
              undo_predictor(tile_buf.data() + (size_t)r * tile_values * esz,
                             tile_values, stride);
          }
          int64_t img_y0 = (int64_t)ty * tile_height;
          int64_t img_x0 = (int64_t)tx * tile_width;
          int64_t r_lo = y0 > img_y0 ? y0 - img_y0 : 0;
          int64_t r_hi = (y0 + ny) < (img_y0 + tile_height)
                             ? (y0 + ny - img_y0)
                             : tile_height;
          int64_t c_lo = x0 > img_x0 ? x0 - img_x0 : 0;
          int64_t c_hi = (x0 + nx) < (img_x0 + tile_width)
                             ? (x0 + nx - img_x0)
                             : tile_width;
          if ((int64_t)(img_y0 + tile_height) > (int64_t)height)
            r_hi = r_hi < (int64_t)(height - img_y0) ? r_hi
                                                     : (int64_t)(height - img_y0);
          if ((int64_t)(img_x0 + tile_width) > (int64_t)width)
            c_hi = c_hi < (int64_t)(width - img_x0) ? c_hi
                                                    : (int64_t)(width - img_x0);
          for (int64_t r = r_lo; r < r_hi; ++r) {
            int64_t out_row = img_y0 + r - y0;
            const uint8_t *src_row =
                tile_buf.data() + (size_t)r * tile_values * esz;
            if (planar == 2) {
              uint8_t *out =
                  dst + ((size_t)plane * ny * nx + out_row * nx +
                         (img_x0 + c_lo - x0)) *
                            esz;
              memcpy(out, src_row + (size_t)c_lo * esz,
                     (size_t)(c_hi - c_lo) * esz);
            } else {
              for (uint32_t smp = 0; smp < samples; ++smp) {
                uint8_t *out = dst + ((size_t)smp * ny * nx + out_row * nx +
                                      (img_x0 + c_lo - x0)) *
                                         esz;
                const uint8_t *in =
                    src_row + ((size_t)c_lo * samples + smp) * esz;
                for (int64_t x = 0; x < (c_hi - c_lo); ++x)
                  memcpy(out + x * esz, in + (size_t)x * samples * esz, esz);
              }
            }
          }
        }
      }
    }
    return true;
  }
};

}  // namespace

extern "C" {

const char *tiffio_error() { return g_error.c_str(); }

void *tiffio_open(const char *path) {
  // No exception may escape the extern "C"/ctypes boundary: corrupt files
  // must surface as error returns, never process aborts.
  try {
    Reader *r = new Reader();
    if (!r->open(path)) {
      delete r;
      return nullptr;
    }
    return r;
  } catch (const std::exception &e) {
    set_error(std::string("tiffio_open failed: ") + e.what());
    return nullptr;
  } catch (...) {
    set_error("tiffio_open failed: unknown error");
    return nullptr;
  }
}

void tiffio_close(void *handle) { delete (Reader *)handle; }

// info: [width, height, samples, bits, sample_format, planar, compression,
//        tile_width, tile_height, rows_per_strip]
int tiffio_info(void *handle, int64_t *info) {
  Reader *r = (Reader *)handle;
  info[0] = r->width;
  info[1] = r->height;
  info[2] = r->samples;
  info[3] = r->bits;
  info[4] = r->sample_format;
  info[5] = r->planar;
  info[6] = r->compression;
  info[7] = r->tile_width;
  info[8] = r->tile_height;
  info[9] = r->rows_per_strip;
  return 0;
}

int tiffio_read_window(void *handle, int64_t y0, int64_t x0, int64_t ny,
                       int64_t nx, void *dst) {
  try {
    Reader *r = (Reader *)handle;
    return r->read_window(y0, x0, ny, nx, (uint8_t *)dst) ? 0 : -1;
  } catch (const std::exception &e) {
    set_error(std::string("tiffio_read_window failed: ") + e.what());
    return -1;
  } catch (...) {
    set_error("tiffio_read_window failed: unknown error");
    return -1;
  }
}

// Serialize the geo-referencing tags (ModelPixelScale 33550, ModelTiepoint
// 33922, ModelTransformation 34264, GeoKeyDirectory 34735, GeoDoubleParams
// 34736, GeoAsciiParams 34737, GDALMetadata 42112, GDALNoData 42113) into a
// flat buffer: repeated [tag u16 | type u16 | count u32 | raw bytes...],
// little-endian with values already byte-swapped to host order where typed.
// Returns the number of bytes written (or needed, if dst is null).
int64_t tiffio_geo_tags(void *handle, uint8_t *dst, int64_t capacity) {
  Reader *r = (Reader *)handle;
  static const uint16_t kGeoTags[] = {33550, 33922, 34264, 34735,
                                      34736, 34737, 42112, 42113};
  int64_t written = 0;
  for (const TiffTag &t : r->all_tags) {
    bool keep = false;
    for (uint16_t g : kGeoTags)
      if (t.tag == g) keep = true;
    if (!keep) continue;
    int64_t need = 8 + (int64_t)t.raw.size();
    if (dst && written + need <= capacity) {
      uint8_t *p = dst + written;
      p[0] = t.tag & 0xff;
      p[1] = t.tag >> 8;
      p[2] = t.type & 0xff;
      p[3] = t.type >> 8;
      uint32_t c = (uint32_t)t.count;
      memcpy(p + 4, &c, 4);
      memcpy(p + 8, t.raw.data(), t.raw.size());
      // Normalize stored values to little-endian for the Python writer.
      if (r->big_endian) {
        size_t esz = type_size(t.type);
        // RATIONALs are pairs of u32.
        size_t swap_sz = (t.type == 5 || t.type == 10) ? 4 : esz;
        if (swap_sz > 1) {
          uint8_t *q = p + 8;
          for (size_t i = 0; i + swap_sz <= t.raw.size(); i += swap_sz) {
            for (size_t a = 0, b = swap_sz - 1; a < b; ++a, --b) {
              uint8_t tmp = q[i + a];
              q[i + a] = q[i + b];
              q[i + b] = tmp;
            }
          }
        }
      }
    }
    written += need;
  }
  return written;
}

// Batch windowed read with an internal thread pool. For each i < n, reads
// window (y0,x0,h,w) = windows[4*i..] from handles[i] into dsts[i]
// (band-sequential CHW, native dtype). Handles may repeat (same scene);
// the pread-based reader is safe to share across threads. Returns 0 if all
// reads succeeded, else the count of failures.
extern "C" int64_t tiffio_read_windows_batch(void **handles,
                                             const int64_t *windows,
                                             int64_t n, void **dsts,
                                             int64_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = 4;
  if (n_threads > n) n_threads = n;
  std::atomic<int64_t> next(0), failures(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      Reader *r = (Reader *)handles[i];
      const int64_t *w = windows + 4 * i;
      bool ok = false;
      try {
        ok = r->read_window(w[0], w[1], w[2], w[3], (uint8_t *)dsts[i]);
      } catch (...) {
        ok = false;  // never let an exception escape a pool thread
      }
      if (!ok) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto &t : pool) t.join();
  return failures.load();
}

}  // extern "C"
