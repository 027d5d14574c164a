// The sequential parts of the port's BMP and TIFF codecs
// (multiyolov5_tpu_torch/data/bmp.py, data/tiff.py): TIFF's LZW (libtiff's
// decoder and, byte for byte, its encoder) and PackBits, and BMP's RLE8 and
// RLE4 as OpenCV's and Pillow's decoders read them.  Everything else (row
// unpacking, palettes, the predictor, unfiltering) is numpy's.
//
// Built with g++ on the host at first use and bound through ctypes; a plain C
// interface, no Python or PyTorch headers.  Every entry point returns 0 on
// success, or non-zero with a message written into `err`.

#include <cstdint>
#include <cstring>
#include <string>

namespace {

struct Error {
  std::string msg;
};

void put_err(const std::string& msg, char* err, int errlen) {
  if (errlen <= 0) return;
  std::strncpy(err, msg.c_str(), errlen - 1);
  err[errlen - 1] = 0;
}

// ---------------------------------------------------------------- LZW

constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kMaxCode = (1 << kBitsMax) - 1;  // libtiff CODE_MAX

// libtiff tif_lzw.c LZWDecode: MSB-first codes, the code width growing one
// code early (at 511, 1023, 2047), Clear resetting the table.  Stops at EOI
// or once `cap` bytes are out; fewer bytes than `cap` is an error there too.
int64_t lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint16_t length[4096];
  if (n >= 2 && src[0] == 0 && (src[1] & 1))
    throw Error{"old-style (LSB-first) LZW is not supported"};
  for (int i = 0; i < 256; ++i) {
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int64_t pos = 0, out = 0;  // pos in bits
  int nbits = kBitsMin, next = kFirst, old = -1;
  auto read = [&]() -> int {
    if (pos + nbits > n * 8) return kEoi;  // libtiff treats a stream that ends as EOI
    int64_t byte = pos >> 3;
    uint32_t w = (uint32_t)src[byte] << 16;
    if (byte + 1 < n) w |= (uint32_t)src[byte + 1] << 8;
    if (byte + 2 < n) w |= src[byte + 2];
    int c = (int)((w >> (24 - nbits - (pos & 7))) & ((1u << nbits) - 1));
    pos += nbits;
    return c;
  };
  auto emit = [&](int code) {  // a code's string, cut where the chunk is full
    int len = length[code];
    int keep = out + len > cap ? (int)(cap - out) : len;
    int c = code;
    for (int i = len - 1; i >= 0; --i, c = prefix[c])
      if (i < keep) dst[out + i] = suffix[c];
    out += keep;
  };
  while (out < cap) {
    int code = read();
    if (code == kEoi) break;
    if (code == kClear) {
      nbits = kBitsMin;
      next = kFirst;
      code = read();
      if (code == kEoi) break;
      if (code > 255) throw Error{"corrupt LZW stream (a string code right after Clear)"};
      emit(code);
      old = code;
      continue;
    }
    if (old < 0) {
      if (code > 255) throw Error{"corrupt LZW stream (no Clear before the first string code)"};
      emit(code);
      old = code;
      continue;
    }
    if (code > next || next > kMaxCode) throw Error{"corrupt LZW stream (a code past the table)"};
    int firstc = code < next ? first[code] : first[old];
    prefix[next] = (uint16_t)old;
    suffix[next] = (uint8_t)firstc;
    first[next] = first[old];
    length[next] = (uint16_t)(length[old] + 1);
    ++next;
    emit(code);
    if (next >= (1 << nbits) - 1 && nbits < kBitsMax) ++nbits;
    old = code;
  }
  return out;
}

// libtiff tif_lzw.c LZWPreEncode + LZWEncode + LZWPostEncode over one strip:
// its table is cleared when full (at 4094 entries) and, past every 10000 input
// bytes, whenever the compression ratio (input bits * 256 / output bits) has
// not improved since the last check, so the codes (and bytes) are libtiff's.
int64_t lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  constexpr int kHSize = 9001, kHShift = 13 - 8, kCheckGap = 10000;
  static thread_local int32_t hash[kHSize];
  static thread_local uint16_t codes[kHSize];
  int64_t op = 0;
  uint32_t nextdata = 0;
  int nextbits = 0, nbits = kBitsMin, maxcode = (1 << kBitsMin) - 1, free_ent = kFirst;
  int64_t incount = 0, outcount = 0, checkpoint = kCheckGap, ratio = 0;
  auto put = [&](int c) {
    if (op + 4 > cap) throw Error{"LZW output buffer too small"};
    nextdata = (nextdata << nbits) | (uint32_t)c;
    nextbits += nbits;
    dst[op++] = (uint8_t)(nextdata >> (nextbits - 8));
    nextbits -= 8;
    if (nextbits >= 8) {
      dst[op++] = (uint8_t)(nextdata >> (nextbits - 8));
      nextbits -= 8;
    }
    outcount += nbits;
  };
  auto clear_hash = [&]() { std::memset(hash, 0xff, sizeof(hash)); };
  auto reset = [&]() {
    clear_hash();
    ratio = 0;
    incount = 0;
    outcount = 0;
    free_ent = kFirst;
    put(kClear);
    nbits = kBitsMin;
    maxcode = (1 << kBitsMin) - 1;
  };
  clear_hash();
  int ent = -1;
  int64_t i = 0;
  if (n > 0) {
    put(kClear);
    ent = src[i++];
    ++incount;
  }
  while (i < n) {
    int c = src[i++];
    ++incount;
    int32_t fcode = ((int32_t)c << kBitsMax) + ent;
    int h = (c << kHShift) ^ ent;
    if (hash[h] == fcode) {
      ent = codes[h];
      continue;
    }
    bool hit = false;
    if (hash[h] >= 0) {
      int disp = kHSize - h;
      if (h == 0) disp = 1;
      do {
        if ((h -= disp) < 0) h += kHSize;
        if (hash[h] == fcode) {
          ent = codes[h];
          hit = true;
          break;
        }
      } while (hash[h] >= 0);
    }
    if (hit) continue;
    put(ent);
    ent = c;
    codes[h] = (uint16_t)free_ent++;
    hash[h] = fcode;
    if (free_ent == kMaxCode - 1) {
      reset();
    } else if (free_ent > maxcode) {
      ++nbits;
      maxcode = (1 << nbits) - 1;
    } else if (incount >= checkpoint) {
      checkpoint = incount + kCheckGap;
      int64_t rat;
      if (incount > 0x007fffff) {
        rat = outcount >> 8;
        rat = rat == 0 ? 0x7fffffff : incount / rat;
      } else {
        rat = (incount << 8) / outcount;
      }
      if (rat <= ratio)
        reset();
      else
        ratio = rat;
    }
  }
  if (ent >= 0) {
    put(ent);
    ++free_ent;
    if (free_ent == kMaxCode - 1) {
      outcount = 0;
      put(kClear);
      nbits = kBitsMin;
    } else if (free_ent > maxcode) {
      ++nbits;
    }
  }
  put(kEoi);
  if (nextbits > 0) {
    if (op >= cap) throw Error{"LZW output buffer too small"};
    dst[op++] = (uint8_t)((nextdata << (8 - nextbits)) & 0xff);
  }
  return op;
}

// ---------------------------------------------------------------- PackBits

// libtiff tif_packbits.c PackBitsDecode: a header byte n, then n + 1 literal
// bytes (n >= 0) or one byte repeated 1 - n times (n < 0; -128 is a no-op).
// Output past `cap` is dropped; fewer bytes than `cap` is an error.
int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t i = 0, out = 0;
  while (i < n && out < cap) {
    int h = (int8_t)src[i++];
    if (h == -128) continue;
    if (h < 0) {
      if (i >= n) break;
      int64_t run = 1 - h;
      if (run > cap - out) run = cap - out;
      std::memset(dst + out, src[i++], (size_t)run);
      out += run;
    } else {
      int64_t run = h + 1;
      if (run > n - i) throw Error{"truncated PackBits data"};
      int64_t keep = run < cap - out ? run : cap - out;
      std::memcpy(dst + out, src + i, (size_t)keep);
      i += run;
      out += keep;
    }
  }
  return out;
}

// ---------------------------------------------------------------- BMP RLE

// OpenCV's BmpDecoder (grfmt_bmp.cpp) on RLE8 / RLE4 data: palette indices
// of `h` rows of `w` in the file's row order; a run or literal past its row's
// end, or data that ends before the image does, fails (cv2.imread gives
// None).  Skipped pixels (end of line, delta, end of bitmap) take index 0,
// which cv2 paints with palette entry 0.  RLE8: a run that ends a row moves to
// the next one (an end-of-line right after it is then a no-op), delta moves
// dx + dy * w pixels on, end-of-bitmap fills the rest of the image.  RLE4: a
// run stays on its row, delta moves dx pixels on (dy is read and ignored),
// end-of-bitmap acts as an end-of-line, and decoding stops at the last row.
struct Cursor {
  const uint8_t* d;
  int64_t n, pos;
  int byte() {
    if (pos >= n) throw Error{"RLE data ends before the image does"};
    return d[pos++];
  }
};

void rle_cv2(Cursor& in, int w, int h, bool rle4, uint8_t* out) {
  int64_t x = 0, y = 0;
  // FillUniColor: `count` pixels of index 0 from (x, y), wrapping to the next
  // rows; returns with y == h once past the last row
  auto fill = [&](int64_t count) {
    do {
      int64_t end = x + count < w ? x + count : w;
      count -= end - x;
      if (y < h) std::memset(out + y * w + x, 0, (size_t)(end - x));
      x = end;
      if (x >= w) {
        x = 0;
        if (++y >= h) break;
      }
    } while (count > 0);
  };
  bool line_end_flag = false;
  for (;;) {
    int len = in.byte();
    int code = in.byte();
    if (len != 0) {  // encoded run
      if (x + len > w) throw Error{"RLE run past the end of its row"};
      if (!rle4) {
        int64_t prev_y = y;
        std::memset(out + y * w + x, code, (size_t)len);
        x += len;
        if (x >= w) {
          x = 0;
          ++y;
        }
        line_end_flag = y != prev_y;
        if (y >= h) break;
      } else {
        for (int i = 0; i < len; ++i) out[y * w + x + i] = (uint8_t)(i & 1 ? code & 15 : code >> 4);
        x += len;
      }
    } else if (code > 2) {  // literal run
      if (x + code > w) throw Error{"RLE literal past the end of its row"};
      int sz = rle4 ? (((code + 1) >> 1) + 1) & ~1 : (code + 1) & ~1;
      uint8_t buf[256];
      for (int i = 0; i < sz; ++i) buf[i] = (uint8_t)in.byte();
      for (int i = 0; i < code; ++i)
        out[y * w + x + i] = rle4 ? (uint8_t)(i & 1 ? buf[i >> 1] & 15 : buf[i >> 1] >> 4) : buf[i];
      x += code;
      if (!rle4) line_end_flag = false;
    } else if (!rle4) {  // end of line, end of bitmap, delta
      int64_t xs = w - x, ys = h - y;
      if (code || !line_end_flag || xs < w) {
        if (code == 2) {
          xs = in.byte();
          ys = in.byte();
        }
        if (code != 0) xs += ys * w;
        if (y >= h) break;
        fill(xs);
        if (y >= h) break;
      }
      line_end_flag = false;
      if (y >= h) break;
    } else {
      int64_t xs = w - x;
      if (code == 2) {
        xs = in.byte();
        in.byte();
      }
      fill(xs);
      if (y >= h) break;
    }
  }
}

// Pillow's BmpRleDecoder (BmpImagePlugin.py) on the same data: indices in the
// file's row order, the stream read two bytes at a time until w * h indices
// are out or the stream ends.  A run is clipped to its row; a literal is not
// (RLE4 literals give count // 2 bytes' pixels); end of line pads the row with
// index 0; delta reads its two bytes twice over and pads dx + dy * w indices
// with the second pair; literals are padded to an even *file* offset
// (`file_pos` is the data's offset in the file).  Returns the indices out
// (the caller raises where that is fewer than w * h, as Pillow does).
int64_t rle_pil(Cursor& in, int64_t file_pos, int w, int h, bool rle4, uint8_t* out) {
  const int64_t total = (int64_t)w * h;
  int64_t len = 0, x = 0;
  auto push = [&](int v) {
    if (len < total) out[len] = (uint8_t)v;
    ++len;
  };
  auto avail = [&]() { return in.n - in.pos; };
  while (len < total) {
    if (avail() < 2) break;
    int num = in.d[in.pos++];
    int byte = in.d[in.pos++];
    if (num) {
      if (x + num > w) num = (int)(w - x > 0 ? w - x : 0);
      for (int i = 0; i < num; ++i) push(rle4 ? (i % 2 == 0 ? byte >> 4 : byte & 15) : byte);
      x += num;
    } else if (byte == 0) {
      while (len % w != 0) push(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (avail() < 2) break;
      in.pos += 2;
      if (avail() < 2) throw Error{"RLE delta cut short (Pillow reads its two bytes twice)"};
      int right = in.d[in.pos++], up = in.d[in.pos++];
      for (int64_t i = 0; i < right + (int64_t)up * w; ++i) push(0);
      x = len % w;
    } else {
      int64_t count = rle4 ? byte / 2 : byte;
      int64_t got = count < avail() ? count : avail();
      for (int64_t i = 0; i < got; ++i) {
        int v = in.d[in.pos++];
        if (rle4) {
          push(v >> 4);
          push(v & 15);
        } else {
          push(v);
        }
      }
      if (got < count) break;
      x += byte;
      if ((file_pos + in.pos) % 2 != 0) ++in.pos;
    }
  }
  return len < total ? len : total;
}

}  // namespace

extern "C" {

// TIFF LZW / PackBits of one strip or tile into `dst` (`cap` bytes, the
// chunk's size); *written is what came out.
int mkc_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int64_t* written,
                   char* err, int errlen) {
  try {
    *written = lzw_decode(src, n, dst, cap);
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

int mkc_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int64_t* written,
                   char* err, int errlen) {
  try {
    *written = lzw_encode(src, n, dst, cap);
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

int mkc_packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                        int64_t* written, char* err, int errlen) {
  try {
    *written = packbits_decode(src, n, dst, cap);
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

// BMP RLE8 (rle4 = 0) or RLE4 data starting at `offset` of the file's `n`
// bytes, as OpenCV (pil = 0) or Pillow (pil = 1) decodes it, into `out`
// (w * h indices, zeroed by the caller).  *written: indices Pillow produced
// (w * h for OpenCV).
int mkc_bmp_rle(const uint8_t* data, int64_t n, int64_t offset, int w, int h, int rle4, int pil,
                uint8_t* out, int64_t* written, char* err, int errlen) {
  try {
    if (w <= 0 || h <= 0 || offset < 0 || offset > n) throw Error{"bad RLE geometry"};
    Cursor in{data + offset, n - offset, 0};
    if (pil) {
      *written = rle_pil(in, offset, w, h, rle4 != 0, out);
    } else {
      rle_cv2(in, w, h, rle4 != 0, out);
      *written = (int64_t)w * h;
    }
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

}  // extern "C"
