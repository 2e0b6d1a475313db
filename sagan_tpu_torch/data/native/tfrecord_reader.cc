// Native TFRecord image-example reader.
//
// The performance-critical half of the data pipeline: record framing,
// crc32c verification, and tf.train.Example protobuf parsing in C++,
// streaming batches of decoded (uint8 image, int64 label) pairs into
// caller-provided buffers.  The pure-Python codec in ../tfrecord.py is
// the semantic oracle (tests compare the two); this reader exists because
// per-record Python protobuf walking caps a host input pipeline at a few
// thousand records/sec while TPU training wants hundreds of thousands.
//
// TFRecord framing: u64le length | u32le masked_crc(length) | payload |
// u32le masked_crc(payload), masked_crc = rotr15(crc32c(x)) + 0xa282ead8.
//
// C ABI (ctypes):
//   void*   sagan_reader_open(const char* path, int verify)
//   int64   sagan_reader_next(void* r, uint8_t* imgs, int64_t* labels,
//                             int64_t max_records, int64_t img_bytes)
//             -> #records filled (0 = EOF, -1 = error)
//   void    sagan_reader_close(void* r)
//   const char* sagan_reader_error(void* r)
//   uint32  sagan_crc32c(const uint8_t* data, int64_t len)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

// ---------------------------------------------------------------------
// crc32c (Castagnoli), slice-by-8
// ---------------------------------------------------------------------

uint32_t g_tables[8][256];
bool g_tables_ready = false;

void init_tables() {
  if (g_tables_ready) return;
  const uint32_t poly = 0x82f63b78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int k = 0; k < 8; ++k) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    g_tables[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = g_tables[0][i];
    for (int t = 1; t < 8; ++t) {
      crc = g_tables[0][crc & 0xff] ^ (crc >> 8);
      g_tables[t][i] = crc;
    }
  }
  g_tables_ready = true;
}

uint32_t crc32c(const uint8_t* p, int64_t n) {
  init_tables();
  uint32_t crc = 0xffffffffu;
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, p, 8);
    word ^= crc;
    crc = g_tables[7][word & 0xff] ^ g_tables[6][(word >> 8) & 0xff] ^
          g_tables[5][(word >> 16) & 0xff] ^ g_tables[4][(word >> 24) & 0xff] ^
          g_tables[3][(word >> 32) & 0xff] ^ g_tables[2][(word >> 40) & 0xff] ^
          g_tables[1][(word >> 48) & 0xff] ^ g_tables[0][(word >> 56) & 0xff];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = g_tables[0][(crc ^ *p++) & 0xff] ^ (crc >> 8);
  return crc ^ 0xffffffffu;
}

uint32_t masked_crc(const uint8_t* p, int64_t n) {
  uint32_t c = crc32c(p, n);
  return ((c >> 15) | (c << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------
// minimal protobuf wire walk for tf.train.Example
// ---------------------------------------------------------------------

struct Slice {
  const uint8_t* p;
  int64_t n;
};

bool read_varint(Slice* s, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (s->n > 0) {
    uint8_t b = *s->p;
    s->p++;
    s->n--;
    result |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// Walk one message level; for each field call back with (field, wire,
// value-slice-or-varint).  Returns false on malformed input.
template <typename F>
bool walk(Slice s, F&& f) {
  while (s.n > 0) {
    uint64_t key;
    if (!read_varint(&s, &key)) return false;
    uint32_t field = (uint32_t)(key >> 3);
    uint32_t wire = (uint32_t)(key & 7);
    if (wire == 0) {
      uint64_t v;
      if (!read_varint(&s, &v)) return false;
      if (!f(field, wire, Slice{nullptr, 0}, v)) return false;
    } else if (wire == 2) {
      uint64_t len;
      if (!read_varint(&s, &len) || (int64_t)len > s.n) return false;
      if (!f(field, wire, Slice{s.p, (int64_t)len}, 0)) return false;
      s.p += len;
      s.n -= len;
    } else if (wire == 5) {
      if (s.n < 4) return false;
      if (!f(field, wire, Slice{s.p, 4}, 0)) return false;
      s.p += 4;
      s.n -= 4;
    } else if (wire == 1) {
      if (s.n < 8) return false;
      if (!f(field, wire, Slice{s.p, 8}, 0)) return false;
      s.p += 8;
      s.n -= 8;
    } else {
      return false;
    }
  }
  return true;
}

// Extract image_raw bytes + first label int64 from a serialized Example.
bool parse_example(Slice rec, Slice* image_out, int64_t* label_out) {
  image_out->p = nullptr;
  image_out->n = 0;
  *label_out = 0;
  return walk(rec, [&](uint32_t f1, uint32_t w1, Slice v1, uint64_t) {
    if (f1 != 1 || w1 != 2) return true;  // Example.features
    return walk(v1, [&](uint32_t f2, uint32_t w2, Slice v2, uint64_t) {
      if (f2 != 1 || w2 != 2) return true;  // Features.feature map entry
      Slice name{nullptr, 0}, feat{nullptr, 0};
      if (!walk(v2, [&](uint32_t f3, uint32_t w3, Slice v3, uint64_t) {
            if (f3 == 1 && w3 == 2) name = v3;
            if (f3 == 2 && w3 == 2) feat = v3;
            return true;
          }))
        return false;
      if (!name.p || !feat.p) return true;
      bool is_image = (name.n == 9 && !memcmp(name.p, "image_raw", 9));
      bool is_label = (name.n == 5 && !memcmp(name.p, "label", 5));
      if (!is_image && !is_label) return true;
      return walk(feat, [&](uint32_t f4, uint32_t w4, Slice v4, uint64_t) {
        if (is_image && f4 == 1 && w4 == 2) {  // bytes_list
          walk(v4, [&](uint32_t f5, uint32_t w5, Slice v5, uint64_t) {
            if (f5 == 1 && w5 == 2) *image_out = v5;
            return true;
          });
        }
        if (is_label && f4 == 3 && w4 == 2) {  // int64_list
          walk(v4, [&](uint32_t f5, uint32_t w5, Slice v5, uint64_t vi) {
            if (f5 != 1) return true;
            if (w5 == 0) {  // unpacked varint
              *label_out = (int64_t)vi;
            } else if (w5 == 2 && v5.n > 0) {  // packed
              Slice tmp = v5;
              uint64_t x;
              if (read_varint(&tmp, &x)) *label_out = (int64_t)x;
            }
            return true;
          });
        }
        return true;
      });
    });
  });
}

// ---------------------------------------------------------------------
// streaming reader
// ---------------------------------------------------------------------

struct Reader {
  FILE* f = nullptr;
  bool verify = false;
  std::string err;
  std::string buf;  // payload scratch
};

}  // namespace

extern "C" {

void* sagan_reader_open(const char* path, int verify) {
  Reader* r = new Reader();
  r->f = fopen(path, "rb");
  r->verify = verify != 0;
  if (!r->f) {
    delete r;
    return nullptr;
  }
  return r;
}

const char* sagan_reader_error(void* h) {
  return h ? static_cast<Reader*>(h)->err.c_str() : "open failed";
}

void sagan_reader_close(void* h) {
  if (!h) return;
  Reader* r = static_cast<Reader*>(h);
  if (r->f) fclose(r->f);
  delete r;
}

// Fill up to max_records decoded examples. imgs must hold
// max_records*img_bytes; labels max_records entries.
int64_t sagan_reader_next(void* h, uint8_t* imgs, int64_t* labels,
                          int64_t max_records, int64_t img_bytes) {
  Reader* r = static_cast<Reader*>(h);
  int64_t filled = 0;
  while (filled < max_records) {
    uint8_t header[8];
    size_t got = fread(header, 1, 8, r->f);
    if (got == 0) break;  // EOF
    if (got < 8) {
      r->err = "truncated length header";
      return -1;
    }
    uint64_t len;
    memcpy(&len, header, 8);
    uint8_t crcbuf[4];
    if (fread(crcbuf, 1, 4, r->f) != 4) {
      r->err = "truncated length crc";
      return -1;
    }
    if (r->verify) {
      uint32_t expect;
      memcpy(&expect, crcbuf, 4);
      if (masked_crc(header, 8) != expect) {
        r->err = "corrupt length crc";
        return -1;
      }
    }
    r->buf.resize(len);
    if (len && fread(&r->buf[0], 1, len, r->f) != len) {
      r->err = "truncated record";
      return -1;
    }
    if (fread(crcbuf, 1, 4, r->f) != 4) {
      r->err = "truncated data crc";
      return -1;
    }
    if (r->verify) {
      uint32_t expect;
      memcpy(&expect, crcbuf, 4);
      if (masked_crc((const uint8_t*)r->buf.data(), (int64_t)len) != expect) {
        r->err = "corrupt data crc";
        return -1;
      }
    }
    Slice image;
    int64_t label;
    if (!parse_example(Slice{(const uint8_t*)r->buf.data(), (int64_t)len},
                       &image, &label)) {
      r->err = "malformed Example protobuf";
      return -1;
    }
    if (image.n != img_bytes) {
      r->err = "image_raw size mismatch (got " +
               std::to_string(image.n) + ", want " +
               std::to_string(img_bytes) + ")";
      return -1;
    }
    memcpy(imgs + filled * img_bytes, image.p, img_bytes);
    labels[filled] = label;
    ++filled;
  }
  return filled;
}

uint32_t sagan_crc32c(const uint8_t* data, int64_t len) {
  return crc32c(data, len);
}

}  // extern "C"
