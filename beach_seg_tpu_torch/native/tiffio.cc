// GeoTIFF codec — the framework's native raster I/O engine.
//
// TPU-native replacement for the reference's GDAL/rasterio data plane
// (ref src/util/geo_util.py — rasterio.open/read/write paths).
// The Python geo layer (beach_seg_tpu_torch/geo/tiff.py) binds this via ctypes.
//
// Scope (everything the beach_seg pipeline touches):
//   read : classic TIFF, striped or tiled, chunky or planar, 1..16 samples,
//          u8/u16/i16/u32/i32/f32/f64, compression none/LZW/Deflate(+zlib),
//          horizontal-differencing predictor (2); GeoTIFF georeferencing
//          (ModelPixelScale+Tiepoint or ModelTransformation), EPSG code from
//          the GeoKey directory, GDAL_NODATA.
//   write: striped chunky TIFF, same dtypes, none/LZW/Deflate with optional
//          predictor, GeoTIFF tags + EPSG GeoKeys + GDAL_NODATA.
//
// Deliberately NOT a libtiff wrapper: a ~900-line self-contained codec keeps
// the framework dependency-free and lets the host I/O path be profiled and
// tuned as one unit.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

// ---------------------------------------------------------------- dtypes

enum Dtype { DT_U8 = 0, DT_U16 = 1, DT_I16 = 2, DT_U32 = 3, DT_I32 = 4, DT_F32 = 5, DT_F64 = 6 };

int dtype_size(int dt) {
  switch (dt) {
    case DT_U8: return 1;
    case DT_U16: case DT_I16: return 2;
    case DT_U32: case DT_I32: case DT_F32: return 4;
    case DT_F64: return 8;
  }
  return 0;
}

// ------------------------------------------------------------- raw file

struct Buf {
  std::vector<uint8_t> data;
  bool big_endian = false;

  uint16_t u16(size_t off) const {
    if (off + 2 > data.size()) return 0;
    return big_endian ? (data[off] << 8) | data[off + 1]
                      : data[off] | (data[off + 1] << 8);
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > data.size()) return 0;
    if (big_endian)
      return ((uint32_t)data[off] << 24) | ((uint32_t)data[off + 1] << 16) |
             ((uint32_t)data[off + 2] << 8) | data[off + 3];
    return (uint32_t)data[off] | ((uint32_t)data[off + 1] << 8) |
           ((uint32_t)data[off + 2] << 16) | ((uint32_t)data[off + 3] << 24);
  }
  double f64(size_t off) const {
    uint64_t v = 0;
    if (off + 8 > data.size()) return 0;
    for (int i = 0; i < 8; i++) {
      int b = big_endian ? data[off + i] : data[off + 7 - i];
      v = (v << 8) | (uint64_t)b;
    }
    double d;
    memcpy(&d, &v, 8);
    return d;
  }
};

// --------------------------------------------------------------- LZW

// TIFF-variant LZW: MSB-first bit packing, codes 9→12 bits, Clear=256,
// EOI=257, "early change" (code width bumps one entry early).
class LzwDecoder {
 public:
  bool decode(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
    static const int kClear = 256, kEoi = 257;
    size_t bitpos = 0;
    int width = 9;
    std::vector<std::pair<int, uint8_t>> table;  // (prefix, last byte)
    table.reserve(4096);
    auto reset = [&]() {
      table.clear();
      for (int i = 0; i < 258; i++) table.push_back({-1, (uint8_t)i});
      width = 9;
    };
    auto emit = [&](int code, uint8_t* first) {
      // walk the chain; codes form a tree, depth bounded by table size
      size_t start = out.size();
      int c = code;
      while (c >= 0) {
        if ((size_t)c >= table.size()) return false;
        out.push_back(table[c].second);
        c = table[c].first;
      }
      // reverse the emitted chunk
      for (size_t i = start, j = out.size() - 1; i < j; i++, j--)
        std::swap(out[i], out[j]);
      *first = out[start];
      return true;
    };
    auto next = [&]() -> int {
      if ((bitpos + width) > n * 8) return kEoi;
      uint32_t v = 0;
      for (int i = 0; i < width; i++) {
        size_t bp = bitpos + i;
        v = (v << 1) | ((src[bp >> 3] >> (7 - (bp & 7))) & 1);
      }
      bitpos += width;
      return (int)v;
    };

    reset();
    int prev = -1;
    while (true) {
      int code = next();
      if (code == kEoi) break;
      if (code == kClear) {
        reset();
        prev = -1;
        continue;
      }
      uint8_t first = 0;
      if (prev < 0) {
        if (!emit(code, &first)) return false;
      } else {
        if ((size_t)code < table.size()) {
          if (!emit(code, &first)) return false;
          table.push_back({prev, first});
        } else if ((size_t)code == table.size()) {
          // KwKwK case
          uint8_t pf = 0;
          size_t start = out.size();
          if (!emit(prev, &pf)) return false;
          out.push_back(pf);
          first = out[start];
          table.push_back({prev, first});
        } else {
          return false;
        }
      }
      prev = code;
      // early change: grow width when the NEXT code would overflow
      if (table.size() + 1 >= (size_t)(1 << width) && width < 12) width++;
    }
    return true;
  }
};

class LzwEncoder {
 public:
  void encode(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
    static const int kClear = 256, kEoi = 257;
    // hash table: (prefix code, byte) → code
    std::vector<int32_t> hash;
    int next_code = 258, width = 9;
    uint32_t acc = 0;
    int accbits = 0;
    auto put = [&](int code) {
      acc = (acc << width) | (uint32_t)code;
      accbits += width;
      while (accbits >= 8) {
        out.push_back((uint8_t)(acc >> (accbits - 8)));
        accbits -= 8;
      }
    };
    auto reset = [&]() {
      hash.assign(1 << 20, -1);  // 4096 codes × 256 bytes
      next_code = 258;
      width = 9;
    };

    put(kClear);
    reset();
    int prefix = -1;
    for (size_t i = 0; i < n; i++) {
      uint8_t ch = src[i];
      if (prefix < 0) {
        prefix = ch;
        continue;
      }
      int key = (prefix << 8) | ch;
      if (hash[key] >= 0) {
        prefix = hash[key];
        continue;
      }
      put(prefix);
      hash[key] = next_code++;
      // early change on encode: bump width when next_code+1 hits the limit
      if (next_code + 1 > (1 << width) && width < 12) width++;
      if (next_code >= 4094) {
        put(kClear);
        reset();
      }
      prefix = ch;
    }
    if (prefix >= 0) put(prefix);
    put(kEoi);
    if (accbits > 0) out.push_back((uint8_t)(acc << (8 - accbits)));
  }
};

// ------------------------------------------------------------ predictor

void undo_predictor2(uint8_t* p, int rows, int cols, int samples, int dt) {
  int sz = dtype_size(dt);
  for (int r = 0; r < rows; r++) {
    uint8_t* row = p + (size_t)r * cols * samples * sz;
    if (dt == DT_U8) {
      for (int i = samples; i < cols * samples; i++) row[i] = (uint8_t)(row[i] + row[i - samples]);
    } else if (sz == 2) {
      uint16_t* r16 = (uint16_t*)row;
      for (int i = samples; i < cols * samples; i++) r16[i] = (uint16_t)(r16[i] + r16[i - samples]);
    } else if (sz == 4 && (dt == DT_U32 || dt == DT_I32)) {
      uint32_t* r32 = (uint32_t*)row;
      for (int i = samples; i < cols * samples; i++) r32[i] += r32[i - samples];
    }
    // float predictor (3) unsupported — caller rejects
  }
}

void apply_predictor2(uint8_t* p, int rows, int cols, int samples, int dt) {
  int sz = dtype_size(dt);
  for (int r = 0; r < rows; r++) {
    uint8_t* row = p + (size_t)r * cols * samples * sz;
    if (dt == DT_U8) {
      for (int i = cols * samples - 1; i >= samples; i--) row[i] = (uint8_t)(row[i] - row[i - samples]);
    } else if (sz == 2) {
      uint16_t* r16 = (uint16_t*)row;
      for (int i = cols * samples - 1; i >= samples; i--) r16[i] = (uint16_t)(r16[i] - r16[i - samples]);
    } else if (sz == 4 && (dt == DT_U32 || dt == DT_I32)) {
      uint32_t* r32 = (uint32_t*)row;
      for (int i = cols * samples - 1; i >= samples; i--) r32[i] -= r32[i - samples];
    }
  }
}

// ----------------------------------------------------------- IFD model

struct IfdEntry {
  uint16_t tag = 0, type = 0;
  uint32_t count = 0;
  std::vector<double> vals;      // numeric values
  std::string ascii;             // ascii values
};

struct Tiff {
  Buf buf;
  int width = 0, height = 0, samples = 1, dtype = DT_U8;
  int compression = 1, predictor = 1, planar = 1;
  int tile_w = 0, tile_h = 0, rows_per_strip = 0;
  std::vector<uint64_t> chunk_off, chunk_cnt;
  double transform[6] = {1, 0, 0, 0, -1, 0};  // a,b,c,d,e,f: x=a*col+b*row+c
  int epsg = 0;
  double nodata = 0;
  int has_nodata = 0;
  std::string error;
};

int type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;   // BYTE/ASCII/SBYTE/UNDEF
    case 3: case 8: return 2;                   // SHORT/SSHORT
    case 4: case 9: case 11: return 4;          // LONG/SLONG/FLOAT
    case 5: case 10: case 12: return 8;         // RATIONAL/SRATIONAL/DOUBLE
  }
  return 0;
}

double read_val(const Buf& b, uint16_t type, size_t off) {
  switch (type) {
    case 1: case 2: case 7: return b.data[off];
    case 6: return (int8_t)b.data[off];
    case 3: return b.u16(off);
    case 8: return (int16_t)b.u16(off);
    case 4: return b.u32(off);
    case 9: return (int32_t)b.u32(off);
    case 5: { double n = b.u32(off), d = b.u32(off + 4); return d ? n / d : 0; }
    case 10: { double n = (int32_t)b.u32(off), d = (int32_t)b.u32(off + 4); return d ? n / d : 0; }
    case 11: { uint32_t v = b.u32(off); float f; memcpy(&f, &v, 4); return f; }
    case 12: return b.f64(off);
  }
  return 0;
}

bool parse_ifd(Tiff& t, std::vector<IfdEntry>& entries) {
  Buf& b = t.buf;
  if (b.data.size() < 8) { t.error = "truncated header"; return false; }
  if (b.data[0] == 'I' && b.data[1] == 'I') b.big_endian = false;
  else if (b.data[0] == 'M' && b.data[1] == 'M') b.big_endian = true;
  else { t.error = "not a TIFF"; return false; }
  uint16_t magic = b.u16(2);
  if (magic == 43) { t.error = "BigTIFF unsupported"; return false; }
  if (magic != 42) { t.error = "bad magic"; return false; }
  uint32_t ifd = b.u32(4);
  if (ifd + 2 > b.data.size()) { t.error = "bad IFD offset"; return false; }
  uint16_t n = b.u16(ifd);
  for (int i = 0; i < n; i++) {
    size_t e = ifd + 2 + (size_t)i * 12;
    IfdEntry ent;
    ent.tag = b.u16(e);
    ent.type = b.u16(e + 2);
    ent.count = b.u32(e + 4);
    int sz = type_size(ent.type);
    if (!sz) continue;
    size_t total = (size_t)sz * ent.count;
    size_t off = total <= 4 ? e + 8 : b.u32(e + 8);
    if (off + total > b.data.size()) continue;
    if (ent.type == 2) {
      ent.ascii.assign((const char*)&b.data[off], ent.count);
    } else {
      ent.vals.reserve(ent.count);
      for (uint32_t k = 0; k < ent.count; k++)
        ent.vals.push_back(read_val(b, ent.type, off + (size_t)k * sz));
    }
    entries.push_back(std::move(ent));
  }
  return true;
}

const IfdEntry* find(const std::vector<IfdEntry>& es, uint16_t tag) {
  for (auto& e : es)
    if (e.tag == tag) return &e;
  return nullptr;
}

bool interpret(Tiff& t, const std::vector<IfdEntry>& es) {
  auto geti = [&](uint16_t tag, int dflt) {
    const IfdEntry* e = find(es, tag);
    return e && !e->vals.empty() ? (int)e->vals[0] : dflt;
  };
  t.width = geti(256, 0);
  t.height = geti(257, 0);
  t.samples = geti(277, 1);
  t.compression = geti(259, 1);
  t.predictor = geti(317, 1);
  t.planar = geti(284, 1);
  int bits = geti(258, 8);
  int fmt = geti(339, 1);  // 1 uint, 2 int, 3 float
  if (bits == 8 && fmt == 1) t.dtype = DT_U8;
  else if (bits == 16 && fmt == 1) t.dtype = DT_U16;
  else if (bits == 16 && fmt == 2) t.dtype = DT_I16;
  else if (bits == 32 && fmt == 1) t.dtype = DT_U32;
  else if (bits == 32 && fmt == 2) t.dtype = DT_I32;
  else if (bits == 32 && fmt == 3) t.dtype = DT_F32;
  else if (bits == 64 && fmt == 3) t.dtype = DT_F64;
  else { t.error = "unsupported bits/format"; return false; }
  if (t.compression != 1 && t.compression != 5 && t.compression != 8 && t.compression != 32946) {
    t.error = "unsupported compression " + std::to_string(t.compression);
    return false;
  }
  if (t.predictor == 3) { t.error = "float predictor unsupported"; return false; }

  const IfdEntry* tw = find(es, 322);
  if (tw) {
    t.tile_w = (int)tw->vals[0];
    t.tile_h = geti(323, 0);
    const IfdEntry* to = find(es, 324);
    const IfdEntry* tc = find(es, 325);
    if (!to || !tc) { t.error = "tiled without offsets"; return false; }
    for (double v : to->vals) t.chunk_off.push_back((uint64_t)v);
    for (double v : tc->vals) t.chunk_cnt.push_back((uint64_t)v);
  } else {
    t.rows_per_strip = geti(278, t.height);
    if (t.rows_per_strip <= 0 || t.rows_per_strip > t.height) t.rows_per_strip = t.height;
    const IfdEntry* so = find(es, 273);
    const IfdEntry* sc = find(es, 279);
    if (!so) { t.error = "no strip offsets"; return false; }
    for (double v : so->vals) t.chunk_off.push_back((uint64_t)v);
    if (sc)
      for (double v : sc->vals) t.chunk_cnt.push_back((uint64_t)v);
    else if (t.compression == 1)
      for (size_t i = 0; i < t.chunk_off.size(); i++)
        t.chunk_cnt.push_back((uint64_t)t.rows_per_strip * t.width * t.samples * dtype_size(t.dtype));
  }

  // georeferencing
  const IfdEntry* scale = find(es, 33550);
  const IfdEntry* tie = find(es, 33922);
  const IfdEntry* mt = find(es, 34264);
  if (scale && tie && scale->vals.size() >= 2 && tie->vals.size() >= 6) {
    double sx = scale->vals[0], sy = scale->vals[1];
    double i = tie->vals[0], j = tie->vals[1], x = tie->vals[3], y = tie->vals[4];
    t.transform[0] = sx; t.transform[1] = 0; t.transform[2] = x - i * sx;
    t.transform[3] = 0; t.transform[4] = -sy; t.transform[5] = y + j * sy;
  } else if (mt && mt->vals.size() >= 16) {
    t.transform[0] = mt->vals[0]; t.transform[1] = mt->vals[1]; t.transform[2] = mt->vals[3];
    t.transform[3] = mt->vals[4]; t.transform[4] = mt->vals[5]; t.transform[5] = mt->vals[7];
  }
  const IfdEntry* gk = find(es, 34735);
  if (gk && gk->vals.size() >= 4) {
    size_t nk = (size_t)gk->vals[3];
    for (size_t k = 0; k < nk && 4 + 4 * k + 3 < gk->vals.size(); k++) {
      int key = (int)gk->vals[4 + 4 * k];
      int loc = (int)gk->vals[4 + 4 * k + 1];
      int val = (int)gk->vals[4 + 4 * k + 3];
      if ((key == 3072 || key == 2048) && loc == 0) t.epsg = val;
    }
  }
  const IfdEntry* nd = find(es, 42113);
  if (nd && !nd->ascii.empty()) {
    t.nodata = atof(nd->ascii.c_str());
    t.has_nodata = 1;
  }
  return t.width > 0 && t.height > 0;
}

bool decompress_chunk(const Tiff& t, size_t idx, size_t raw_size, std::vector<uint8_t>& out) {
  if (idx >= t.chunk_off.size()) return false;
  uint64_t off = t.chunk_off[idx];
  uint64_t cnt = idx < t.chunk_cnt.size() ? t.chunk_cnt[idx] : 0;
  if (off + cnt > t.buf.data.size()) return false;
  const uint8_t* src = &t.buf.data[off];
  out.clear();
  if (t.compression == 1) {
    out.assign(src, src + cnt);
  } else if (t.compression == 5) {
    out.reserve(raw_size);
    LzwDecoder dec;
    if (!dec.decode(src, cnt, out)) return false;
  } else {  // deflate
    out.resize(raw_size);
    uLongf dlen = raw_size;
    if (uncompress(out.data(), &dlen, src, cnt) != Z_OK) return false;
    out.resize(dlen);
  }
  if (out.size() < raw_size) out.resize(raw_size, 0);
  return true;
}

// byte-swap decoded chunk in place for big-endian files
void swap_chunk(const Tiff& t, std::vector<uint8_t>& chunk) {
  if (!t.buf.big_endian) return;
  int sz = dtype_size(t.dtype);
  if (sz == 1) return;
  for (size_t i = 0; i + sz <= chunk.size(); i += sz)
    for (int a = 0, b = sz - 1; a < b; a++, b--) std::swap(chunk[i + a], chunk[i + b]);
}

}  // namespace

// ================================================================ C API

extern "C" {

struct BstInfo {
  int32_t width, height, channels, dtype;
  double transform[6];
  int32_t epsg;
  double nodata;
  int32_t has_nodata;
};

void* bst_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Tiff* t = new Tiff();
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  t->buf.data.resize(n);
  if (fread(t->buf.data.data(), 1, n, f) != (size_t)n) { fclose(f); delete t; return nullptr; }
  fclose(f);
  std::vector<IfdEntry> es;
  if (!parse_ifd(*t, es) || !interpret(*t, es)) {
    fprintf(stderr, "bst_open(%s): %s\n", path, t->error.c_str());
    delete t;
    return nullptr;
  }
  return t;
}

int bst_info(void* h, BstInfo* out) {
  Tiff* t = (Tiff*)h;
  out->width = t->width;
  out->height = t->height;
  out->channels = t->samples;
  out->dtype = t->dtype;
  memcpy(out->transform, t->transform, sizeof(t->transform));
  out->epsg = t->epsg;
  out->nodata = t->nodata;
  out->has_nodata = t->has_nodata;
  return 0;
}

// Read the full image into dst as interleaved (H, W, C), native endian.
int bst_read(void* h, void* dst_v) {
  Tiff* t = (Tiff*)h;
  uint8_t* dst = (uint8_t*)dst_v;
  int sz = dtype_size(t->dtype);
  size_t pix = (size_t)t->samples * sz;
  size_t row_bytes = (size_t)t->width * pix;
  int planes = t->planar == 2 ? t->samples : 1;
  int samples_per_chunk = t->planar == 2 ? 1 : t->samples;

  std::vector<uint8_t> chunk;
  if (t->tile_w > 0) {
    int tx = (t->width + t->tile_w - 1) / t->tile_w;
    int ty = (t->height + t->tile_h - 1) / t->tile_h;
    size_t raw = (size_t)t->tile_w * t->tile_h * samples_per_chunk * sz;
    for (int p = 0; p < planes; p++)
      for (int j = 0; j < ty; j++)
        for (int i = 0; i < tx; i++) {
          size_t idx = (size_t)p * tx * ty + (size_t)j * tx + i;
          if (!decompress_chunk(*t, idx, raw, chunk)) return -1;
          if (t->predictor == 2) undo_predictor2(chunk.data(), t->tile_h, t->tile_w, samples_per_chunk, t->dtype);
          swap_chunk(*t, chunk);
          int rows = std::min(t->tile_h, t->height - j * t->tile_h);
          int cols = std::min(t->tile_w, t->width - i * t->tile_w);
          for (int r = 0; r < rows; r++) {
            const uint8_t* src_row = chunk.data() + (size_t)r * t->tile_w * samples_per_chunk * sz;
            uint8_t* d = dst + (size_t)(j * t->tile_h + r) * row_bytes + (size_t)i * t->tile_w * pix;
            if (planes == 1) {
              memcpy(d, src_row, (size_t)cols * pix);
            } else {
              for (int c = 0; c < cols; c++)
                memcpy(d + (size_t)c * pix + (size_t)p * sz, src_row + (size_t)c * sz, sz);
            }
          }
        }
  } else {
    // strips decode independently — fan out over hardware threads
    int nstrips = (t->height + t->rows_per_strip - 1) / t->rows_per_strip;
    int total = planes * nstrips;
    int nthreads = (int)std::min<size_t>(std::thread::hardware_concurrency(), 16);
    if (nthreads < 1 || total < 4 || t->compression == 1 /*raw memcpy is cheap*/)
      nthreads = 1;
    std::atomic<int> next(0);
    std::atomic<bool> failed(false);
    auto worker = [&]() {
      std::vector<uint8_t> local;
      while (true) {
        int job = next.fetch_add(1);
        if (job >= total || failed.load()) return;
        int p = job / nstrips;
        int s = job % nstrips;
        int rows = std::min(t->rows_per_strip, t->height - s * t->rows_per_strip);
        size_t raw = (size_t)rows * t->width * samples_per_chunk * sz;
        if (!decompress_chunk(*t, (size_t)job, raw, local)) {
          failed.store(true);
          return;
        }
        if (t->predictor == 2) undo_predictor2(local.data(), rows, t->width, samples_per_chunk, t->dtype);
        swap_chunk(*t, local);
        if (planes == 1) {
          memcpy(dst + (size_t)s * t->rows_per_strip * row_bytes, local.data(), raw);
        } else {
          for (int r = 0; r < rows; r++)
            for (int c = 0; c < t->width; c++)
              memcpy(dst + (size_t)(s * t->rows_per_strip + r) * row_bytes + (size_t)c * pix + (size_t)p * sz,
                     local.data() + ((size_t)r * t->width + c) * sz, sz);
        }
      }
    };
    if (nthreads == 1) {
      worker();
    } else {
      std::vector<std::thread> threads;
      for (int i = 0; i < nthreads; i++) threads.emplace_back(worker);
      for (auto& th : threads) th.join();
    }
    if (failed.load()) return -1;
  }
  return 0;
}

// Windowed read: decode only the strips/tiles covering
// [y0, y0+win_h) × [x0, x0+win_w); dst is (win_h, win_w, C) interleaved.
// The window must lie inside the image.
int bst_read_window(void* hv, int x0, int y0, int win_w, int win_h, void* dst_v) {
  Tiff* t = (Tiff*)hv;
  if (x0 < 0 || y0 < 0 || x0 + win_w > t->width || y0 + win_h > t->height) return -2;
  uint8_t* dst = (uint8_t*)dst_v;
  int sz = dtype_size(t->dtype);
  size_t pix = (size_t)t->samples * sz;
  size_t out_row_bytes = (size_t)win_w * pix;
  int planes = t->planar == 2 ? t->samples : 1;
  int spc = t->planar == 2 ? 1 : t->samples;

  std::vector<uint8_t> chunk;
  if (t->tile_w > 0) {
    int tx = (t->width + t->tile_w - 1) / t->tile_w;
    int ty = (t->height + t->tile_h - 1) / t->tile_h;
    size_t raw = (size_t)t->tile_w * t->tile_h * spc * sz;
    int j0 = y0 / t->tile_h, j1 = (y0 + win_h - 1) / t->tile_h;
    int i0 = x0 / t->tile_w, i1 = (x0 + win_w - 1) / t->tile_w;
    for (int p = 0; p < planes; p++)
      for (int j = j0; j <= j1; j++)
        for (int i = i0; i <= i1; i++) {
          size_t idx = (size_t)p * tx * ty + (size_t)j * tx + i;
          if (!decompress_chunk(*t, idx, raw, chunk)) return -1;
          if (t->predictor == 2) undo_predictor2(chunk.data(), t->tile_h, t->tile_w, spc, t->dtype);
          swap_chunk(*t, chunk);
          int ry0 = std::max(y0, j * t->tile_h), ry1 = std::min(y0 + win_h, (j + 1) * t->tile_h);
          int cx0 = std::max(x0, i * t->tile_w), cx1 = std::min(x0 + win_w, (i + 1) * t->tile_w);
          for (int r = ry0; r < ry1; r++) {
            const uint8_t* src_row =
                chunk.data() + ((size_t)(r - j * t->tile_h) * t->tile_w + (cx0 - i * t->tile_w)) * spc * sz;
            uint8_t* d = dst + (size_t)(r - y0) * out_row_bytes + (size_t)(cx0 - x0) * pix;
            if (planes == 1) {
              memcpy(d, src_row, (size_t)(cx1 - cx0) * pix);
            } else {
              for (int c = 0; c < cx1 - cx0; c++)
                memcpy(d + (size_t)c * pix + (size_t)p * sz, src_row + (size_t)c * sz, sz);
            }
          }
        }
  } else {
    int nstrips = (t->height + t->rows_per_strip - 1) / t->rows_per_strip;
    int s0 = y0 / t->rows_per_strip, s1 = (y0 + win_h - 1) / t->rows_per_strip;
    for (int p = 0; p < planes; p++)
      for (int s = s0; s <= s1; s++) {
        int rows = std::min(t->rows_per_strip, t->height - s * t->rows_per_strip);
        size_t raw = (size_t)rows * t->width * spc * sz;
        if (!decompress_chunk(*t, (size_t)p * nstrips + s, raw, chunk)) return -1;
        if (t->predictor == 2) undo_predictor2(chunk.data(), rows, t->width, spc, t->dtype);
        swap_chunk(*t, chunk);
        int ry0 = std::max(y0, s * t->rows_per_strip);
        int ry1 = std::min(y0 + win_h, s * t->rows_per_strip + rows);
        for (int r = ry0; r < ry1; r++) {
          const uint8_t* src_row =
              chunk.data() + ((size_t)(r - s * t->rows_per_strip) * t->width + x0) * spc * sz;
          uint8_t* d = dst + (size_t)(r - y0) * out_row_bytes;
          if (planes == 1) {
            memcpy(d, src_row, out_row_bytes);
          } else {
            for (int c = 0; c < win_w; c++)
              memcpy(d + (size_t)c * pix + (size_t)p * sz, src_row + (size_t)c * sz, sz);
          }
        }
      }
  }
  return 0;
}

void bst_close(void* h) { delete (Tiff*)h; }

const char* bst_last_error(void* h) { return ((Tiff*)h)->error.c_str(); }

// ------------------------------------------------------------------ write

namespace {

struct Writer {
  std::vector<uint8_t> out;
  void u16(uint16_t v) { out.push_back(v & 0xff); out.push_back(v >> 8); }
  void u32(uint32_t v) { for (int i = 0; i < 4; i++) out.push_back((v >> (8 * i)) & 0xff); }
  void f64v(double d) { uint64_t v; memcpy(&v, &d, 8); for (int i = 0; i < 8; i++) out.push_back((v >> (8 * i)) & 0xff); }
  void raw(const void* p, size_t n) { out.insert(out.end(), (const uint8_t*)p, (const uint8_t*)p + n); }
};

struct WTag {
  uint16_t tag, type;
  uint32_t count;
  std::vector<uint8_t> payload;  // little-endian encoded values
  uint32_t inline_val = 0;
  bool use_inline = false;
};

}  // namespace

// data: interleaved (h, w, c), native-endian, dtype per Dtype enum.
// compression: 0 none, 1 lzw, 2 deflate. transform: a,b,c,d,e,f or null.
// nodata: pointer or null. Returns 0 on success.
int bst_write(const char* path, const void* data_v, int w, int h, int c, int dtype,
              const double* transform, int epsg, int compression, const double* nodata) {
  const uint8_t* data = (const uint8_t*)data_v;
  int sz = dtype_size(dtype);
  if (!sz || w <= 0 || h <= 0 || c <= 0) return -1;
  size_t row_bytes = (size_t)w * c * sz;

  // strips of ~64 rows
  int rps = std::max(1, (int)(65536 / std::max(row_bytes, (size_t)1)));
  if (rps > h) rps = h;
  int nstrips = (h + rps - 1) / rps;

  bool use_pred = (compression != 0) && (dtype != DT_F32 && dtype != DT_F64);
  std::vector<std::vector<uint8_t>> strips(nstrips);
  std::vector<uint8_t> work;
  for (int s = 0; s < nstrips; s++) {
    int rows = std::min(rps, h - s * rps);
    size_t raw = (size_t)rows * row_bytes;
    const uint8_t* src = data + (size_t)s * rps * row_bytes;
    if (compression == 0) {
      strips[s].assign(src, src + raw);
      continue;
    }
    work.assign(src, src + raw);
    if (use_pred) apply_predictor2(work.data(), rows, w, c, dtype);
    if (compression == 1) {
      LzwEncoder enc;
      strips[s].clear();
      enc.encode(work.data(), work.size(), strips[s]);
    } else {
      uLongf bound = compressBound(work.size());
      strips[s].resize(bound);
      if (compress2(strips[s].data(), &bound, work.data(), work.size(), 6) != Z_OK) return -2;
      strips[s].resize(bound);
    }
  }

  std::vector<WTag> tags;
  auto add_short = [&](uint16_t tag, std::vector<uint16_t> vals) {
    WTag t{tag, 3, (uint32_t)vals.size(), {}, 0, false};
    if (vals.size() <= 2) {
      t.use_inline = true;
      t.inline_val = vals[0] | (vals.size() > 1 ? ((uint32_t)vals[1] << 16) : 0);
    } else {
      for (uint16_t v : vals) { t.payload.push_back(v & 0xff); t.payload.push_back(v >> 8); }
    }
    tags.push_back(std::move(t));
  };
  auto add_long = [&](uint16_t tag, std::vector<uint32_t> vals) {
    WTag t{tag, 4, (uint32_t)vals.size(), {}, 0, false};
    if (vals.size() == 1) { t.use_inline = true; t.inline_val = vals[0]; }
    else for (uint32_t v : vals) for (int i = 0; i < 4; i++) t.payload.push_back((v >> (8 * i)) & 0xff);
    tags.push_back(std::move(t));
  };
  auto add_double = [&](uint16_t tag, std::vector<double> vals) {
    WTag t{tag, 12, (uint32_t)vals.size(), {}, 0, false};
    for (double d : vals) {
      uint64_t v; memcpy(&v, &d, 8);
      for (int i = 0; i < 8; i++) t.payload.push_back((v >> (8 * i)) & 0xff);
    }
    tags.push_back(std::move(t));
  };
  auto add_ascii = [&](uint16_t tag, const std::string& s) {
    WTag t{tag, 2, (uint32_t)s.size() + 1, {}, 0, false};
    t.payload.assign(s.begin(), s.end());
    t.payload.push_back(0);
    if (t.payload.size() <= 4) {
      t.use_inline = true;
      t.inline_val = 0;
      for (size_t i = 0; i < t.payload.size(); i++) t.inline_val |= (uint32_t)t.payload[i] << (8 * i);
      t.payload.clear();
    }
    tags.push_back(std::move(t));
  };

  int fmt = (dtype == DT_F32 || dtype == DT_F64) ? 3 : (dtype == DT_I16 || dtype == DT_I32) ? 2 : 1;
  int bits = sz * 8;
  add_long(256, {(uint32_t)w});
  add_long(257, {(uint32_t)h});
  add_short(258, std::vector<uint16_t>((size_t)c, (uint16_t)bits));
  add_short(259, {(uint16_t)(compression == 0 ? 1 : compression == 1 ? 5 : 8)});
  add_short(262, {(uint16_t)(c >= 3 ? 2 : 1)});  // RGB or MinIsBlack
  add_long(277, {(uint32_t)c});  // placeholder fixed below (SamplesPerPixel is SHORT)
  tags.pop_back();
  add_short(277, {(uint16_t)c});
  add_long(278, {(uint32_t)rps});
  add_short(284, {1});
  add_short(339, std::vector<uint16_t>((size_t)c, (uint16_t)fmt));
  if (c > 3) add_short(338, std::vector<uint16_t>((size_t)(c - 3), 0));  // ExtraSamples unspecified
  if (compression != 0 && use_pred) add_short(317, {2});
  if (transform) {
    // GDAL-style geotransform → PixelScale + Tiepoint (axis-aligned only)
    if (transform[1] == 0 && transform[3] == 0) {
      add_double(33550, {transform[0], -transform[4], 0.0});
      add_double(33922, {0, 0, 0, transform[2], transform[5], 0});
    } else {
      add_double(34264, {transform[0], transform[1], 0, transform[2],
                         transform[3], transform[4], 0, transform[5],
                         0, 0, 0, 0, 0, 0, 0, 1});
    }
  }
  if (epsg > 0) {
    // GeoKeyDirectory: version 1.1.0, 3 keys
    add_short(34735, {1, 1, 0, 3,
                      1024, 0, 1, 1,      // GTModelType = projected
                      1025, 0, 1, 1,      // RasterPixelIsArea
                      3072, 0, 1, (uint16_t)epsg});
  }
  if (nodata) {
    char bufn[64];
    double nd = *nodata;
    if (nd == (long long)nd) snprintf(bufn, sizeof bufn, "%lld", (long long)nd);
    else snprintf(bufn, sizeof bufn, "%.17g", nd);
    add_ascii(42113, bufn);
  }

  // strip offsets/counts appended after layout is known
  add_long(273, std::vector<uint32_t>((size_t)nstrips, 0));
  add_long(279, std::vector<uint32_t>((size_t)nstrips, 0));

  // sort tags ascending (required)
  for (size_t i = 0; i < tags.size(); i++)
    for (size_t j = i + 1; j < tags.size(); j++)
      if (tags[j].tag < tags[i].tag) std::swap(tags[i], tags[j]);

  Writer wr;
  wr.raw("II", 2);
  wr.u16(42);
  wr.u32(8);  // IFD right after header
  size_t ifd_at = wr.out.size();
  wr.u16((uint16_t)tags.size());
  size_t entries_at = wr.out.size();
  for (size_t i = 0; i < tags.size(); i++) { wr.u16(0); wr.u16(0); wr.u32(0); wr.u32(0); }
  wr.u32(0);  // next IFD

  // payloads
  std::vector<uint32_t> payload_off(tags.size(), 0);
  for (size_t i = 0; i < tags.size(); i++) {
    if (!tags[i].use_inline && !tags[i].payload.empty()) {
      if (wr.out.size() & 1) wr.out.push_back(0);
      payload_off[i] = (uint32_t)wr.out.size();
      wr.raw(tags[i].payload.data(), tags[i].payload.size());
    }
  }

  // strip data
  std::vector<uint32_t> soff(nstrips), scnt(nstrips);
  for (int s = 0; s < nstrips; s++) {
    if (wr.out.size() & 1) wr.out.push_back(0);
    soff[s] = (uint32_t)wr.out.size();
    scnt[s] = (uint32_t)strips[s].size();
    wr.raw(strips[s].data(), strips[s].size());
  }

  // patch strip tables into their payloads
  for (size_t i = 0; i < tags.size(); i++) {
    if (tags[i].tag == 273 || tags[i].tag == 279) {
      const std::vector<uint32_t>& v = tags[i].tag == 273 ? soff : scnt;
      if (tags[i].use_inline || nstrips == 1) {
        tags[i].use_inline = true;
        tags[i].inline_val = v[0];
      } else {
        for (int s = 0; s < nstrips; s++)
          for (int b = 0; b < 4; b++)
            wr.out[payload_off[i] + (size_t)s * 4 + b] = (v[s] >> (8 * b)) & 0xff;
      }
    }
  }

  // write IFD entries
  (void)ifd_at;
  for (size_t i = 0; i < tags.size(); i++) {
    size_t e = entries_at + i * 12;
    auto put16 = [&](size_t off, uint16_t v) { wr.out[off] = v & 0xff; wr.out[off + 1] = v >> 8; };
    auto put32 = [&](size_t off, uint32_t v) { for (int b = 0; b < 4; b++) wr.out[off + b] = (v >> (8 * b)) & 0xff; };
    put16(e, tags[i].tag);
    put16(e + 2, tags[i].type);
    put32(e + 4, tags[i].count);
    put32(e + 8, tags[i].use_inline ? tags[i].inline_val : payload_off[i]);
  }

  FILE* f = fopen(path, "wb");
  if (!f) return -3;
  size_t n = fwrite(wr.out.data(), 1, wr.out.size(), f);
  fclose(f);
  return n == wr.out.size() ? 0 : -4;
}

}  // extern "C"
