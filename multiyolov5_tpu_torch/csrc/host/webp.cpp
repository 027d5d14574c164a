// The sequential parts of the port's WebP codec (multiyolov5_tpu_torch/data/webp.py):
// the VP8L (lossless) decoder, the VP8 (lossy keyframe, RFC 6386) decoder with
// libwebp's output stage, the ALPH plane decoder, and a VP8L encoder.  The RIFF
// container, animation and orientation are numpy's.
//
// Every decode equals libwebp's (the library OpenCV and Pillow both read WebP
// with) to the last value: the VP8 tables are RFC 6386's, the reconstruction,
// loop filters, fancy upsampler and YUV -> RGB follow libwebp's
// src/dec/frame_dec.c, src/dsp/dec.c, src/dsp/upsampling.c and src/dsp/yuv.h.
//
// Built with g++ on the host at first use and bound through ctypes; a plain C
// interface, no Python or PyTorch headers.  Every entry point returns 0 on
// success, or non-zero with a message written into `err`.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

void put_err(const std::string& msg, char* err, int errlen) {
  if (errlen <= 0) return;
  std::strncpy(err, msg.c_str(), errlen - 1);
  err[errlen - 1] = 0;
}

// ================================================================ VP8L

constexpr int kLiteral = 256, kLengthCodes = 24, kDistanceCodes = 40;
constexpr int kMaxCacheBits = 11, kMaxCodeLength = 15, kFastBits = 10;
const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
// the 120 (x, y) offsets of the lossless format's distance map: y in the high
// nibble, 8 - x in the low one
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

int div_round_up(int n, int bits) { return (n + (1 << bits) - 1) >> bits; }

// LSB-first bits.  Reading past the data is an error, as libwebp's
// VP8LIsEndOfStream makes it: past the last byte, or for data shorter than
// 8 bytes past the 64 bits libwebp's reader holds.
struct LBits {
  const uint8_t* p;
  int64_t n, next = 0, consumed = 0;
  uint64_t val = 0;
  int cnt = 0;
  LBits(const uint8_t* p_, int64_t n_) : p(p_), n(n_) {}
  void fill() {
    while (cnt <= 56) {
      uint64_t b = next < n ? p[next] : 0;
      ++next;
      val |= b << cnt;
      cnt += 8;
    }
  }
  uint32_t peek(int k) {
    if (cnt < k) fill();
    return (uint32_t)(val & ((1ull << k) - 1));
  }
  void skip(int k) {
    val >>= k;
    cnt -= k;
    consumed += k;
    if (consumed > std::max<int64_t>(n, 8) * 8) throw Error{"VP8L data ends early"};
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
};

// A canonical prefix code: a table of the first kFastBits bits, and the
// canonical (first code, count) per length for longer codes.
struct Huffman {
  int single = -1;  // the one symbol of a code of one symbol (read with no bits)
  std::vector<uint32_t> fast;  // symbol | length << 16; length 0: a longer code
  int first_code[kMaxCodeLength + 2] = {0}, first_index[kMaxCodeLength + 2] = {0},
      count[kMaxCodeLength + 2] = {0};
  std::vector<uint16_t> sorted;

  // libwebp's BuildHuffmanTable: one symbol, or a complete code.
  void build(const std::vector<int>& lengths) {
    int nonzero = 0, last = 0;
    for (int l = 0; l <= kMaxCodeLength + 1; ++l) count[l] = 0;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) {
        if (lengths[s] > kMaxCodeLength) throw Error{"corrupt VP8L prefix code"};
        ++nonzero;
        last = (int)s;
        ++count[lengths[s]];
      }
    if (nonzero == 0) throw Error{"corrupt VP8L prefix code (no symbols)"};
    if (nonzero == 1) {
      single = last;
      return;
    }
    int64_t left = 1;
    for (int l = 1; l <= kMaxCodeLength; ++l) {
      left <<= 1;
      left -= count[l];
      if (left < 0) throw Error{"corrupt VP8L prefix code (over-subscribed)"};
    }
    if (left != 0) throw Error{"corrupt VP8L prefix code (incomplete)"};
    int code = 0, idx = 0;
    for (int l = 1; l <= kMaxCodeLength; ++l) {
      code = (code + (l > 1 ? count[l - 1] : 0)) << (l > 1 ? 1 : 0);
      first_code[l] = code;
      first_index[l] = idx;
      idx += count[l];
    }
    sorted.assign(idx, 0);
    std::vector<int> fill(kMaxCodeLength + 1, 0);
    fast.assign(1u << kFastBits, 0);
    for (size_t s = 0; s < lengths.size(); ++s) {
      int l = lengths[s];
      if (!l) continue;
      int c = first_code[l] + fill[l];
      sorted[first_index[l] + fill[l]] = (uint16_t)s;
      ++fill[l];
      if (l <= kFastBits) {
        uint32_t r = 0;  // the code bit-reversed: its first bit is read first
        for (int i = 0; i < l; ++i) r |= ((c >> (l - 1 - i)) & 1u) << i;
        for (uint32_t k = r; k < (1u << kFastBits); k += 1u << l) fast[k] = (uint32_t)s | (l << 16);
      }
    }
  }

  int read(LBits& br) const {
    if (single >= 0) return single;
    uint32_t e = fast[br.peek(kFastBits)];
    if (e >> 16) {
      br.skip(e >> 16);
      return e & 0xffff;
    }
    int code = 0;
    for (int l = 1; l <= kMaxCodeLength; ++l) {
      code = (code << 1) | (int)br.read(1);
      int d = code - first_code[l];
      if (d >= 0 && d < count[l]) return sorted[first_index[l] + d];
    }
    throw Error{"corrupt VP8L prefix code"};
  }
};

void read_code(LBits& br, int alphabet, Huffman& h) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code: one or two symbols; libwebp drops one past the alphabet
    int num = (int)br.read(1) + 1;
    int first_bits = br.read(1) ? 8 : 1;
    int s0 = (int)br.read(first_bits);
    if (s0 < alphabet) lengths[s0] = 1;
    if (num == 2) {
      int s1 = (int)br.read(8);
      if (s1 < alphabet) lengths[s1] = 1;
    }
  } else {
    int num_codes = (int)br.read(4) + 4;
    std::vector<int> cl(19, 0);
    for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = (int)br.read(3);
    Huffman lc;
    lc.build(cl);
    int max_symbol = alphabet;
    if (br.read(1)) {
      int nbits = 2 + 2 * (int)br.read(3);
      max_symbol = 2 + (int)br.read(nbits);
      if (max_symbol > alphabet) throw Error{"corrupt VP8L code lengths"};
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      int c = lc.read(br);
      if (c < 16) {
        lengths[symbol++] = c;
        if (c) prev = c;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = (int)br.read(kExtra[c - 16]) + kOffset[c - 16];
        if (symbol + repeat > alphabet) throw Error{"corrupt VP8L code lengths"};
        int len = c == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = len;
      }
    }
  }
  h.build(lengths);
}

struct Group {
  Huffman h[5];
};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

uint32_t copy_distance(int sym, LBits& br) {
  if (sym < 4) return sym + 1;
  int extra = (sym - 2) >> 1;
  uint32_t offset = (2u + (sym & 1)) << extra;
  return offset + br.read(extra) + 1;
}

int64_t plane_distance(int xsize, uint32_t code) {
  if (code > 120) return (int64_t)code - 120;
  int v = kCodeToPlane[code - 1];
  int64_t d = (int64_t)(v >> 4) * xsize + (8 - (v & 0xf));
  return d >= 1 ? d : 1;
}

std::vector<uint32_t> decode_stream(LBits& br, int xsize, int ysize, bool level0,
                                    std::vector<Transform>* transforms);

// What a VP8L stream used (for tests of coverage): a bit per transform type,
// whether any image had a colour cache, whether level 0 had an entropy image,
// and how many backward references were decoded.
struct VP8LInfo {
  int transforms = 0, cache = 0, meta = 0, copies = 0;
};
thread_local VP8LInfo* g_linfo = nullptr;

// The entropy-coded pixels of one image (level 0 or a sub-image).
std::vector<uint32_t> decode_pixels(LBits& br, int xsize, int ysize, bool level0) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > kMaxCacheBits) throw Error{"corrupt VP8L colour cache size"};
    if (g_linfo) g_linfo->cache = 1;
  }
  int hbits = 0, hxsize = 0;
  std::vector<uint32_t> himage;
  int num_groups = 1;
  if (level0 && br.read(1)) {
    hbits = (int)br.read(3) + 2;
    if (g_linfo) g_linfo->meta = 1;
    hxsize = div_round_up(xsize, hbits);
    himage = decode_stream(br, hxsize, div_round_up(ysize, hbits), false, nullptr);
    for (auto& g : himage) {
      g = (g >> 8) & 0xffff;
      num_groups = std::max(num_groups, (int)g + 1);
    }
  }
  // libwebp reads the codes of every group up to the largest index, and keeps
  // the ones the entropy image uses
  std::vector<int> slot(num_groups, -1);
  int used = 0;
  if (himage.empty()) {
    slot[0] = used++;
  } else {
    for (uint32_t g : himage)
      if (slot[g] < 0) slot[g] = used++;
  }
  std::vector<Group> groups(used);
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int alphabets[5] = {kLiteral + kLengthCodes + cache_size, kLiteral, kLiteral, kLiteral,
                            kDistanceCodes};
  for (int g = 0; g < num_groups; ++g) {
    Group scratch;
    Group& dst = slot[g] >= 0 ? groups[slot[g]] : scratch;
    for (int j = 0; j < 5; ++j) read_code(br, alphabets[j], dst.h[j]);
  }
  for (auto& g : himage) g = (uint32_t)slot[g];

  const int64_t total = (int64_t)xsize * ysize;
  std::vector<uint32_t> out((size_t)total);
  std::vector<uint32_t> cache(cache_size);
  const int cache_shift = 32 - cache_bits;
  int64_t pos = 0, cached = 0;
  int col = 0, row = 0;
  auto group_at = [&](int c, int r) -> const Group& {
    if (himage.empty()) return groups[0];
    return groups[himage[(size_t)(r >> hbits) * hxsize + (c >> hbits)]];
  };
  auto flush_cache = [&]() {
    if (!cache_size) {
      cached = pos;
      return;
    }
    for (; cached < pos; ++cached) {
      uint32_t a = out[cached];
      cache[(uint32_t)(a * 0x1e35a7bdu) >> cache_shift] = a;
    }
  };
  while (pos < total) {
    const Group& g = group_at(col, row);
    int code = g.h[0].read(br);
    if (code < kLiteral) {
      uint32_t red = g.h[1].read(br), blue = g.h[2].read(br), alpha = g.h[3].read(br);
      out[pos++] = (alpha << 24) | (red << 16) | ((uint32_t)code << 8) | blue;
      if (++col >= xsize) {
        col = 0;
        ++row;
      }
    } else if (code < kLiteral + kLengthCodes) {
      uint32_t length = copy_distance(code - kLiteral, br);
      int dsym = g.h[4].read(br);
      int64_t dist = plane_distance(xsize, copy_distance(dsym, br));
      if (dist > pos || (int64_t)length > total - pos) throw Error{"corrupt VP8L backward reference"};
      if (g_linfo) ++g_linfo->copies;
      for (uint32_t i = 0; i < length; ++i, ++pos) out[pos] = out[pos - dist];
      col += length;
      while (col >= xsize) {
        col -= xsize;
        ++row;
      }
    } else {
      int key = code - kLiteral - kLengthCodes;
      if (key >= cache_size) throw Error{"corrupt VP8L colour cache code"};
      flush_cache();
      out[pos++] = cache[key];
      if (++col >= xsize) {
        col = 0;
        ++row;
      }
    }
    flush_cache();
  }
  return out;
}

std::vector<uint32_t> decode_stream(LBits& br, int xsize, int ysize, bool level0,
                                    std::vector<Transform>* transforms) {
  int width = xsize;
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = (int)br.read(2);
      if (seen & (1u << t.type)) throw Error{"corrupt VP8L stream (a transform given twice)"};
      seen |= 1u << t.type;
      if (g_linfo) g_linfo->transforms |= 1 << t.type;
      t.xsize = width;
      t.ysize = ysize;
      t.bits = 0;
      if (t.type == 0 || t.type == 1) {
        t.bits = (int)br.read(3) + 2;
        t.data = decode_stream(br, div_round_up(t.xsize, t.bits), div_round_up(ysize, t.bits), false,
                               nullptr);
      } else if (t.type == 3) {
        int num_colors = (int)br.read(8) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        width = div_round_up(t.xsize, t.bits);
        std::vector<uint32_t> pal = decode_stream(br, num_colors, 1, false, nullptr);
        t.data.assign((size_t)1 << (8 >> t.bits), 0);  // past the palette: transparent black
        uint8_t* d = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* s = reinterpret_cast<const uint8_t*>(pal.data());
        for (int i = 0; i < 4 * num_colors; ++i) d[i] = (uint8_t)(s[i] + (i >= 4 ? d[i - 4] : 0));
      }
      transforms->push_back(std::move(t));
    }
  }
  return decode_pixels(br, width, ysize, level0);
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((a >> s) & 0xff) + (int)((b >> s) & 0xff) - (int)((c >> s) & 0xff)) << s;
  return out;
}
inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int x = (a >> s) & 0xff, y = (b >> s) & 0xff;
    out |= (uint32_t)clip255(x + (x - y) / 2) << s;
  }
  return out;
}
inline uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
  int d = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (t >> s) & 0xff, b = (l >> s) & 0xff, c = (tl >> s) & 0xff;
    d += std::abs(b - c) - std::abs(a - c);
  }
  return d <= 0 ? t : l;
}

// The lossless format's 14 predictors (14 and 15 predict black, as libwebp's
// padding entries do); `top` points at the pixel above, `left` at the one on
// its left, and top[1] of the last column is the first pixel of this row.
inline uint32_t predict(int mode, const uint32_t* top, uint32_t left) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return clamp_add_sub_full(left, top[0], top[-1]);
    case 13: return clamp_add_sub_half(average2(left, top[0]), top[-1]);
    default: return 0xff000000u;
  }
}

void inverse_predictor(const Transform& t, uint32_t* px) {
  const int w = t.xsize, h = t.ysize, tw = div_round_up(w, t.bits);
  px[0] = add_pixels(px[0], 0xff000000u);
  for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
  for (int y = 1; y < h; ++y) {
    uint32_t* cur = px + (size_t)y * w;
    const uint32_t* top = cur - w;
    const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tw;
    cur[0] = add_pixels(cur[0], top[0]);
    for (int x = 1; x < w; ++x) {
      int mode = (modes[x >> t.bits] >> 8) & 0xf;
      cur[x] = add_pixels(cur[x], predict(mode, top + x, cur[x - 1]));
    }
  }
}

inline int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

void inverse_cross_color(const Transform& t, uint32_t* px) {
  const int w = t.xsize, h = t.ysize, tw = div_round_up(w, t.bits);
  for (int y = 0; y < h; ++y) {
    const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tw;
    for (int x = 0; x < w; ++x) {
      uint32_t code = codes[x >> t.bits];
      int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff),
             r2b = (int8_t)((code >> 16) & 0xff);
      uint32_t& a = px[(size_t)y * w + x];
      int8_t green = (int8_t)(a >> 8);
      int red = (a >> 16) & 0xff, blue = a & 0xff;
      red = (red + color_delta(g2r, green)) & 0xff;
      blue = (blue + color_delta(g2b, green) + color_delta(r2b, (int8_t)red)) & 0xff;
      a = (a & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
    }
  }
}

void add_green(uint32_t* px, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t g = (px[i] >> 8) & 0xff;
    uint32_t rb = (px[i] & 0x00ff00ffu) + ((g << 16) | g);
    px[i] = (px[i] & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
}

// Colour indexing: from the packed (reduced-width) image `src` into `dst`.
void inverse_indexing(const Transform& t, const uint32_t* src, uint32_t* dst) {
  const int w = t.xsize, h = t.ysize, sw = div_round_up(w, t.bits);
  const int per = 1 << t.bits, bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
  for (int y = 0; y < h; ++y) {
    const uint32_t* s = src + (size_t)y * sw;
    uint32_t* d = dst + (size_t)y * w;
    uint32_t packed = 0;
    for (int x = 0; x < w; ++x) {
      if ((x & (per - 1)) == 0) packed = (*s++ >> 8) & 0xff;
      d[x] = t.data[packed & mask];
      packed >>= bpp;
    }
  }
}

// A level-0 image stream of `w` x `h` with its transforms undone: ARGB.
std::vector<uint32_t> decode_image(LBits& br, int w, int h) {
  std::vector<Transform> transforms;
  std::vector<uint32_t> px = decode_stream(br, w, h, true, &transforms);
  for (int i = (int)transforms.size() - 1; i >= 0; --i) {
    const Transform& t = transforms[i];
    switch (t.type) {
      case 0: inverse_predictor(t, px.data()); break;
      case 1: inverse_cross_color(t, px.data()); break;
      case 2: add_green(px.data(), (int64_t)t.xsize * t.ysize); break;
      default: {
        std::vector<uint32_t> full((size_t)t.xsize * t.ysize);
        inverse_indexing(t, px.data(), full.data());
        px.swap(full);
      }
    }
  }
  return px;
}

// ================================================================ VP8 (RFC 6386)

// RFC 6386's tables, in libwebp's mode order: the DC / AC quantiser steps
// (14.1), the key-frame subblock-mode probabilities (11.5), the default
// coefficient probabilities (13.5) and their update probabilities (13.4).
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};


const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
              kCat5[] = {180, 157, 141, 134, 130, 0},
              kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's mode numbering (B_DC_PRED .. B_HU_PRED; DC/TM/V/H for 16x16 and chroma)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

// The boolean decoder (RFC 6386 section 7).  `eof` is set as libwebp sets it:
// when a bit needs a byte past the partition's end.
struct BoolDec {
  const uint8_t* p = nullptr;
  int64_t n = 0, pos = 0;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 255;
  bool eof = false;
  std::vector<uint16_t>* trace = nullptr;  // (prob << 1) | bit of every bit read, for tests
  void init(const uint8_t* p_, int64_t n_) {
    p = p_;
    n = n_;
    pos = 0;
    value = 0;
    bits = -8;
    range = 255;
    eof = false;
  }
  void load() {
    if (pos < n) {
      value = (value << 8) | p[pos++];
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    if (bits < 0) load();
    uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    uint32_t v = (uint32_t)(value >> bits);
    int bit;
    if (v >= split) {
      range -= split;
      value -= (uint64_t)split << bits;
      bit = 1;
    } else {
      range = split;
      bit = 0;
    }
    while (range < 128) {
      range <<= 1;
      --bits;
    }
    if (trace) trace->push_back((uint16_t)((prob << 1) | bit));
    return bit;
  }
  uint32_t value_bits(int nbits) {
    uint32_t v = 0;
    while (nbits-- > 0) v |= (uint32_t)get(0x80) << nbits;
    return v;
  }
  int signed_value(int nbits) {
    int v = (int)value_bits(nbits);
    return get(0x80) ? -v : v;
  }
};

constexpr int BPS = 32;  // libwebp's work-buffer stride
constexpr int Y_OFF = BPS * 1 + 8, U_OFF = Y_OFF + BPS * 16 + BPS, V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;
const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) ((uint8_t)(((a) + (b) + 1) >> 1))

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - tl);
}
void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// 4x4 luma predictors (libwebp dsp/dec.c)
void pred4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
            G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE: {
      const int v[4] = {AVG3(X, I, J), AVG3(I, J, K), AVG3(J, K, L), AVG3(K, L, L)};
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, v[i], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
  }
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) predictors; DC at the frame's
// top and left edges as libwebp's CheckMode picks them.
void pred_block(int mode, uint8_t* dst, int size, int mb_x, int mb_y) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = 0;
      if (mb_x > 0 && mb_y > 0) {
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
        fill(dst, (dc + size) >> (shift + 1), size);
      } else if (mb_y > 0) {  // no left
        for (int j = 0; j < size; ++j) dc += dst[j - BPS];
        fill(dst, (dc + size / 2) >> shift, size);
      } else if (mb_x > 0) {  // no top
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
        fill(dst, (dc + size / 2) >> shift, size);
      } else {
        fill(dst, 0x80, size);
      }
      break;
    }
    case B_TM: true_motion(dst, size); break;
    case B_VE:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    default:  // B_HE
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
  }
}

// libwebp's TransformOne: the inverse DCT of one 4x4 block added to `dst`.
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
void idct_add(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

typedef uint8_t Probas[8][3][11];

int large_value(BoolDec& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    const int bit1 = br.get(p[8]);
    const int bit0 = br.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// libwebp's GetCoeffs: the tokens of one block from position n, dequantised
// into `out` (natural order); returns the position after the last token
// (16 when a run of zeros reaches the end).
int get_coeffs(BoolDec& br, const Probas& prob, int ctx, const int dq[2], int n, int16_t* out) {
  const uint8_t* p = prob[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = prob[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = prob[kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = prob[kBands[n + 1]][2];
    }
    const int s = br.get(0x80) ? -v : v;
    out[kZigzag[n]] = (int16_t)(s * dq[n > 0]);
  }
  return 16;
}

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0, inner = 0;
};

struct MBInfo {
  uint8_t nz = 0, nz_dc = 0;
};

inline uint32_t nz_code(uint32_t bits, int nz, int dc_nz) {
  bits <<= 2;
  bits |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return bits;
}

// ---- loop filters (libwebp dsp/dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }   // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }       // [-112, 112]

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > t || std::abs(q1 - q0) > t;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// `hstride` crosses the edge, `vstride` runs along it
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (; size-- > 0; p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t))
      do_filter2(p, hstride);
    else if (edge)
      do_filter6(p, hstride);
    else
      do_filter4(p, hstride);
  }
}

struct VP8Frame {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  std::vector<uint8_t> y, u, v;  // mb_w*16 x mb_h*16 and mb_w*8 x mb_h*8
  int ystride = 0, uvstride = 0;
};

// What a frame's headers chose (for tests of coverage): segments used and
// their map updated, token partitions, filter type (0 none, 1 simple,
// 2 normal), level, sharpness, loop-filter deltas, skip probability used.
struct VP8Info {
  int use_segment, update_map, num_parts, filter_type, level, sharpness, use_lf_delta, use_skip;
};

// The bits of the first partition as read, and the index of the
// loop-filter-delta flag among them (for tests that rewrite the header).
struct VP8Trace {
  std::vector<uint16_t> bits;
  int64_t lf_delta_at = -1;
};

void vp8_decode(const uint8_t* src, int64_t n, VP8Frame& f, VP8Info* info = nullptr,
                VP8Trace* trace = nullptr) {
  if (n < 10) throw Error{"VP8 data too short"};
  const uint32_t bits = src[0] | (src[1] << 8) | (src[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const uint32_t part0_len = bits >> 5;
  if (!key_frame) throw Error{"not a VP8 key frame"};
  if (profile > 3) throw Error{"incorrect VP8 keyframe parameters"};
  if (!show) throw Error{"VP8 frame not displayable"};
  if (src[3] != 0x9d || src[4] != 0x01 || src[5] != 0x2a) throw Error{"bad VP8 start code"};
  f.width = (src[6] | (src[7] << 8)) & 0x3fff;
  f.height = (src[8] | (src[9] << 8)) & 0x3fff;
  if (f.width == 0 || f.height == 0) throw Error{"VP8 frame of zero size"};
  src += 10;
  n -= 10;
  if (part0_len > n) throw Error{"bad VP8 partition length"};
  BoolDec br;
  br.init(src, part0_len);
  if (trace) br.trace = &trace->bits;
  br.value_bits(1);  // colour space
  br.value_bits(1);  // clamping type (libwebp clamps always)
  // segment header
  bool use_segment = br.get(0x80), update_map = false, absolute_delta = true;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_probs[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.get(0x80);
    if (br.get(0x80)) {  // update data
      absolute_delta = br.get(0x80);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.get(0x80) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.get(0x80) ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) segment_probs[s] = br.get(0x80) ? (uint8_t)br.value_bits(8) : 255;
  }
  // filter header
  const bool simple = br.get(0x80);
  const int level = (int)br.value_bits(6), sharpness = (int)br.value_bits(3);
  if (trace) trace->lf_delta_at = (int64_t)trace->bits.size();
  const bool use_lf_delta = br.get(0x80);
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  if (use_lf_delta && br.get(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) mode_lf_delta[i] = br.signed_value(6);
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) throw Error{"cannot parse the VP8 segment and filter headers"};
  // token partitions
  const int num_parts = 1 << br.value_bits(2);
  BoolDec parts[8];
  {
    const uint8_t* sz = src + part0_len;
    const uint8_t* buf_end = src + n;
    int64_t size_left = n - part0_len - 3 * (num_parts - 1);
    if (size_left < 0) throw Error{"cannot parse the VP8 partitions"};
    const uint8_t* part_start = sz + 3 * (num_parts - 1);
    for (int p = 0; p < num_parts - 1; ++p) {
      int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[num_parts - 1].init(part_start, size_left);
    if (part_start >= buf_end) throw Error{"VP8 data ends before its last partition"};
  }
  // quantisers
  int dq_y1[4][2], dq_y2[4][2], dq_uv[4][2];
  {
    const int base_q0 = (int)br.value_bits(7);
    const int dqy1_dc = br.get(0x80) ? br.signed_value(4) : 0;
    const int dqy2_dc = br.get(0x80) ? br.signed_value(4) : 0;
    const int dqy2_ac = br.get(0x80) ? br.signed_value(4) : 0;
    const int dquv_dc = br.get(0x80) ? br.signed_value(4) : 0;
    const int dquv_ac = br.get(0x80) ? br.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i] + (absolute_delta ? 0 : base_q0);
      } else if (i > 0) {
        std::memcpy(dq_y1[i], dq_y1[0], sizeof(dq_y1[0]));
        std::memcpy(dq_y2[i], dq_y2[0], sizeof(dq_y2[0]));
        std::memcpy(dq_uv[i], dq_uv[0], sizeof(dq_uv[0]));
        continue;
      } else {
        q = base_q0;
      }
      dq_y1[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
      dq_y1[i][1] = kAcTable[clip(q, 127)];
      dq_y2[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      dq_y2[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (dq_y2[i][1] < 8) dq_y2[i][1] = 8;
      dq_uv[i][0] = kDcTable[clip(q + dquv_dc, 117)];
      dq_uv[i][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }
  br.get(0x80);  // refresh entropy probabilities: ignored for a key frame
  static thread_local Probas proba[4];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p]) ? (uint8_t)br.value_bits(8)
                                                                      : kCoeffsProba0[t][b][c][p];
  const bool use_skip_proba = br.get(0x80);
  const int skip_p = use_skip_proba ? (int)br.value_bits(8) : 0;
  if (br.eof) throw Error{"cannot parse the VP8 frame header"};
  if (info) {
    *info = {use_segment, update_map, num_parts, filter_type, level, sharpness, use_lf_delta,
             use_skip_proba};
    return;
  }

  // filter strengths per segment and i4x4
  FInfo fstrengths[4][2];
  if (filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s] + (absolute_delta ? 0 : level);
      } else {
        base_level = level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths[s][i4x4];
        int lv = base_level;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4x4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        if (lv > 0) {
          int ilevel = lv;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lv + ilevel;
          info.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  const int mb_w = (f.width + 15) >> 4, mb_h = (f.height + 15) >> 4;
  f.mb_w = mb_w;
  f.mb_h = mb_h;
  f.ystride = mb_w * 16;
  f.uvstride = mb_w * 8;
  f.y.assign((size_t)f.ystride * mb_h * 16, 0);
  f.u.assign((size_t)f.uvstride * mb_h * 8, 0);
  f.v.assign((size_t)f.uvstride * mb_h * 8, 0);
  std::vector<FInfo> finfo((size_t)mb_w * mb_h);
  std::vector<uint8_t> intra_t((size_t)4 * mb_w, B_DC);
  std::vector<MBInfo> mb_info(mb_w + 1);  // [0] is the left neighbour
  struct TopSamples {
    uint8_t y[16], u[8], v[8];
  };
  std::vector<TopSamples> yuv_t(mb_w);
  uint8_t yuv_b[YUV_SIZE];
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  int16_t coeffs[384];
  struct Block {
    uint8_t segment, skip, is_i4x4, imodes[16], uvmode;
  };
  std::vector<Block> row_blocks(mb_w);

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    // intra modes of the row, from the first partition
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      Block& blk = row_blocks[mb_x];
      uint8_t* top = intra_t.data() + 4 * mb_x;
      if (update_map) {
        blk.segment = !br.get(segment_probs[0]) ? (uint8_t)br.get(segment_probs[1])
                                                : (uint8_t)(br.get(segment_probs[2]) + 2);
      } else {
        blk.segment = 0;
      }
      blk.skip = use_skip_proba ? (uint8_t)br.get(skip_p) : 0;
      blk.is_i4x4 = !br.get(145);
      if (!blk.is_i4x4) {
        const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE) : (br.get(163) ? B_VE : B_DC);
        blk.imodes[0] = (uint8_t)ymode;
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        uint8_t* modes = blk.imodes;
        for (int yy = 0; yy < 4; ++yy) {
          int ymode = intra_l[yy];
          for (int xx = 0; xx < 4; ++xx) {
            const uint8_t* prob = kBModesProba[top[xx]][ymode];
            int i = kYModesIntra4[br.get(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
            ymode = -i;
            top[xx] = (uint8_t)ymode;
          }
          std::memcpy(modes, top, 4);
          modes += 4;
          intra_l[yy] = (uint8_t)ymode;
        }
      }
      blk.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE;
    }
    if (br.eof) throw Error{"VP8 first partition ends early"};

    BoolDec& tbr = parts[mb_y & (num_parts - 1)];
    MBInfo& left = mb_info[0];
    left.nz = left.nz_dc = 0;
    // work buffer edges (libwebp frame_dec.c ReconstructRow)
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const Block& blk = row_blocks[mb_x];
      MBInfo& mb = mb_info[1 + mb_x];
      // residuals
      uint32_t non_zero_y = 0, non_zero_uv = 0;
      std::memset(coeffs, 0, sizeof(coeffs));
      bool skip = use_skip_proba ? blk.skip : false;
      if (!skip) {
        const int seg = blk.segment;
        int16_t* dst = coeffs;
        int first;
        const Probas* ac_proba;
        if (!blk.is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = mb.nz_dc + left.nz_dc;
          const int nz = get_coeffs(tbr, proba[1], ctx, dq_y2[seg], 0, dc);
          mb.nz_dc = left.nz_dc = (nz > 0);
          if (nz > 1) {
            inverse_wht(dc, dst);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
          }
          first = 1;
          ac_proba = &proba[0];
        } else {
          first = 0;
          ac_proba = &proba[3];
        }
        uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
        for (int yy = 0; yy < 4; ++yy) {
          int l = lnz & 1;
          uint32_t nz_coeffs = 0;
          for (int xx = 0; xx < 4; ++xx) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(tbr, *ac_proba, ctx, dq_y1[seg], first, dst);
            l = (nz > first);
            tnz = (uint8_t)((tnz >> 1) | (l << 7));
            nz_coeffs = nz_code(nz_coeffs, nz, dst[0] != 0);
            dst += 16;
          }
          tnz >>= 4;
          lnz = (uint8_t)((lnz >> 1) | (l << 7));
          non_zero_y = (non_zero_y << 8) | nz_coeffs;
        }
        uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          uint32_t nz_coeffs = 0;
          tnz = (uint8_t)(mb.nz >> (4 + ch));
          lnz = (uint8_t)(left.nz >> (4 + ch));
          for (int yy = 0; yy < 2; ++yy) {
            int l = lnz & 1;
            for (int xx = 0; xx < 2; ++xx) {
              const int ctx = l + (tnz & 1);
              const int nz = get_coeffs(tbr, proba[2], ctx, dq_uv[seg], 0, dst);
              l = (nz > 0);
              tnz = (uint8_t)((tnz >> 1) | (l << 3));
              nz_coeffs = nz_code(nz_coeffs, nz, dst[0] != 0);
              dst += 16;
            }
            tnz >>= 2;
            lnz = (uint8_t)((lnz >> 1) | (l << 5));
          }
          non_zero_uv |= nz_coeffs << (4 * ch);
          out_t_nz |= (uint32_t)(tnz << 4) << ch;
          out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
        }
        mb.nz = (uint8_t)out_t_nz;
        left.nz = (uint8_t)out_l_nz;
        skip = !(non_zero_y | non_zero_uv);
      } else {
        left.nz = mb.nz = 0;
        if (!blk.is_i4x4) left.nz_dc = mb.nz_dc = 0;
      }
      if (tbr.eof) throw Error{"VP8 token partition ends early"};
      if (filter_type > 0) {
        FInfo& fi = finfo[(size_t)mb_y * mb_w + mb_x];
        fi = fstrengths[blk.segment][blk.is_i4x4];
        fi.inner |= !skip;
      }

      // reconstruction
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      TopSamples& top_yuv = yuv_t[mb_x];
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_yuv.y, 16);
        std::memcpy(u_dst - BPS, top_yuv.u, 8);
        std::memcpy(v_dst - BPS, top_yuv.v, 8);
      }
      if (blk.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1)
            std::memset(top_right, top_yuv.y[15], 4);
          else
            std::memcpy(top_right, yuv_t[mb_x + 1].y, 4);
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + r * 4 * BPS, top_right, 4);
        uint32_t bits_y = non_zero_y;
        for (int k = 0; k < 16; ++k, bits_y <<= 2) {
          uint8_t* dst = y_dst + kScan[k];
          pred4(blk.imodes[k], dst);
          if (bits_y >> 30) idct_add(coeffs + k * 16, dst);
        }
      } else {
        pred_block(blk.imodes[0], y_dst, 16, mb_x, mb_y);
        uint32_t bits_y = non_zero_y;
        if (bits_y)
          for (int k = 0; k < 16; ++k, bits_y <<= 2)
            if (bits_y >> 30) idct_add(coeffs + k * 16, y_dst + kScan[k]);
      }
      pred_block(blk.uvmode, u_dst, 8, mb_x, mb_y);
      pred_block(blk.uvmode, v_dst, 8, mb_x, mb_y);
      for (int ch = 0; ch < 2; ++ch) {
        const uint32_t b = non_zero_uv >> (8 * ch);
        if (!(b & 0xff)) continue;
        uint8_t* d = ch ? v_dst : u_dst;
        const int16_t* c = coeffs + (16 + 4 * ch) * 16;
        idct_add(c, d);
        idct_add(c + 16, d + 4);
        idct_add(c + 32, d + 4 * BPS);
        idct_add(c + 48, d + 4 * BPS + 4);
      }
      if (mb_y < mb_h - 1) {
        std::memcpy(top_yuv.y, y_dst + 15 * BPS, 16);
        std::memcpy(top_yuv.u, u_dst + 7 * BPS, 8);
        std::memcpy(top_yuv.v, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&f.y[(size_t)(mb_y * 16 + j) * f.ystride + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&f.u[(size_t)(mb_y * 8 + j) * f.uvstride + mb_x * 8], u_dst + j * BPS, 8);
        std::memcpy(&f.v[(size_t)(mb_y * 8 + j) * f.uvstride + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }

  // the loop filter, macroblocks in raster order (libwebp frame_dec.c DoFilter)
  if (filter_type > 0) {
    const int ys = f.ystride, uvs = f.uvstride;
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& fi = finfo[(size_t)mb_y * mb_w + mb_x];
        const int limit = fi.limit;
        if (limit == 0) continue;
        uint8_t* yd = &f.y[(size_t)mb_y * 16 * ys + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) simple_filter(yd, 1, ys, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k, 1, ys, limit);
          if (mb_y > 0) simple_filter(yd, ys, 1, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k * ys, ys, 1, limit);
        } else {
          uint8_t* ud = &f.u[(size_t)mb_y * 8 * uvs + mb_x * 8];
          uint8_t* vd = &f.v[(size_t)mb_y * 8 * uvs + mb_x * 8];
          const int il = fi.ilevel, ht = fi.hev;
          if (mb_x > 0) {
            filter_loop(yd, 1, ys, 16, limit + 4, il, ht, true);
            filter_loop(ud, 1, uvs, 8, limit + 4, il, ht, true);
            filter_loop(vd, 1, uvs, 8, limit + 4, il, ht, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) filter_loop(yd + 4 * k, 1, ys, 16, limit, il, ht, false);
            filter_loop(ud + 4, 1, uvs, 8, limit, il, ht, false);
            filter_loop(vd + 4, 1, uvs, 8, limit, il, ht, false);
          }
          if (mb_y > 0) {
            filter_loop(yd, ys, 1, 16, limit + 4, il, ht, true);
            filter_loop(ud, uvs, 1, 8, limit + 4, il, ht, true);
            filter_loop(vd, uvs, 1, 8, limit + 4, il, ht, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k)
              filter_loop(yd + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
            filter_loop(ud + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
            filter_loop(vd + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
          }
        }
      }
  }
}

// ---- libwebp's output stage: YUV -> RGB (dsp/yuv.h, 14-bit fixed point) and
// the fancy upsampler (dsp/upsampling.c UpsampleRgbLinePair)

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (uint8_t)(((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255); }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](int u, int v) -> uint32_t { return (uint32_t)u | ((uint32_t)v << 16); };
  auto put = [](int y, uint32_t uv, uint8_t* dst) { yuv_to_rgb(y, uv & 0xff, uv >> 16, dst); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]), l_uv = load(cur_u[0], cur_v[0]);
  put(top_y[0], (3 * tl_uv + l_uv + 0x00020002u) >> 2, top_dst);
  if (bottom_y) put(bottom_y[0], (3 * l_uv + tl_uv + 0x00020002u) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]), uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    put(top_y[2 * x - 1], (diag_12 + tl_uv) >> 1, top_dst + (2 * x - 1) * 3);
    put(top_y[2 * x], (diag_03 + t_uv) >> 1, top_dst + (2 * x) * 3);
    if (bottom_y) {
      put(bottom_y[2 * x - 1], (diag_03 + l_uv) >> 1, bottom_dst + (2 * x - 1) * 3);
      put(bottom_y[2 * x], (diag_12 + uv) >> 1, bottom_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    put(top_y[len - 1], (3 * tl_uv + l_uv + 0x00020002u) >> 2, top_dst + (len - 1) * 3);
    if (bottom_y)
      put(bottom_y[len - 1], (3 * l_uv + tl_uv + 0x00020002u) >> 2, bottom_dst + (len - 1) * 3);
  }
}

// (height, width, 3) RGB of a decoded frame, as libwebp's EmitFancyRGB emits it.
void vp8_to_rgb(const VP8Frame& f, uint8_t* rgb) {
  const int w = f.width, h = f.height, ys = f.ystride, uvs = f.uvstride;
  const uint8_t *Y = f.y.data(), *U = f.u.data(), *V = f.v.data();
  const size_t stride = (size_t)w * 3;
  upsample_pair(Y, nullptr, U, V, U, V, rgb, nullptr, w);
  int k = 1;
  for (; 2 * k < h; ++k) {  // rows 2k-1 and 2k, between chroma rows k-1 and k
    upsample_pair(Y + (size_t)(2 * k - 1) * ys, Y + (size_t)(2 * k) * ys, U + (size_t)(k - 1) * uvs,
                  V + (size_t)(k - 1) * uvs, U + (size_t)k * uvs, V + (size_t)k * uvs,
                  rgb + (2 * k - 1) * stride, rgb + (2 * k) * stride, w);
  }
  if (!(h & 1)) {  // the last row of an even height
    const size_t r = h / 2 - 1;
    upsample_pair(Y + (size_t)(h - 1) * ys, nullptr, U + r * uvs, V + r * uvs, U + r * uvs,
                  V + r * uvs, rgb + (h - 1) * stride, nullptr, w);
  }
}

// ================================================================ ALPH

// The alpha plane of an ALPH chunk (its header byte included), unfiltered
// (libwebp alpha_dec.c, dsp/filters.c): w x h bytes into `out`.
void alpha_decode(const uint8_t* src, int64_t n, int w, int h, uint8_t* out) {
  if (n < 1) throw Error{"empty ALPH chunk"};
  const int method = src[0] & 3, filter = (src[0] >> 2) & 3, pre = (src[0] >> 4) & 3,
            rsrv = (src[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) throw Error{"unsupported ALPH header"};
  const uint8_t* data = src + 1;
  const int64_t size = n - 1, total = (int64_t)w * h;
  if (method == 0) {
    if (size < total) throw Error{"ALPH data ends early"};
    std::memcpy(out, data, (size_t)total);
  } else {
    LBits br(data, size);
    std::vector<uint32_t> argb = decode_image(br, w, h);
    for (int64_t i = 0; i < total; ++i) out[i] = (uint8_t)(argb[i] >> 8);
  }
  for (int y = 0; y < h && filter; ++y) {
    uint8_t* row = out + (size_t)y * w;
    const uint8_t* prev = y ? row - w : nullptr;
    if (filter == 1 || !prev) {  // horizontal, and the first row of every filter
      uint8_t pred = prev ? prev[0] : 0;
      for (int i = 0; i < w; ++i) pred = row[i] = (uint8_t)(pred + row[i]);
    } else if (filter == 2) {  // vertical
      for (int i = 0; i < w; ++i) row[i] = (uint8_t)(prev[i] + row[i]);
    } else {  // gradient
      int top_left = prev[0], left = prev[0];
      for (int i = 0; i < w; ++i) {
        const int top = prev[i];
        left = (uint8_t)(row[i] + clip255(left + top - top_left));
        top_left = top;
        row[i] = (uint8_t)left;
      }
    }
  }
}

// ================================================================ VP8L encoder

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int used = 0;
  void put(uint32_t v, int n) {
    acc |= (uint64_t)v << used;
    used += n;
    while (used >= 8) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      used -= 8;
    }
  }
  void finish() {
    if (used) out.push_back((uint8_t)acc);
    acc = 0;
    used = 0;
  }
};

// Code lengths (at most `limit` bits) of a Huffman code for `counts`;
// counts under a floor that doubles are raised until the code fits.
std::vector<int> code_lengths(const std::vector<uint32_t>& counts, int limit) {
  const int n = (int)counts.size();
  std::vector<int> len(n, 0);
  int used = 0;
  for (uint32_t c : counts) used += c > 0;
  if (used == 0) return len;
  if (used == 1) {
    for (int i = 0; i < n; ++i)
      if (counts[i]) len[i] = 1;
    return len;
  }
  for (uint64_t floor_count = 1;; floor_count *= 2) {
    struct Node {
      uint64_t w;
      int left, right;
    };
    std::vector<Node> nodes;
    std::vector<std::pair<uint64_t, int>> heap;
    for (int i = 0; i < n; ++i)
      if (counts[i]) {
        nodes.push_back({std::max<uint64_t>(counts[i], floor_count), -1, i});
        heap.push_back({nodes.back().w, (int)nodes.size() - 1});
      }
    auto cmp = [](const std::pair<uint64_t, int>& a, const std::pair<uint64_t, int>& b) {
      return a.first > b.first || (a.first == b.first && a.second > b.second);
    };
    std::make_heap(heap.begin(), heap.end(), cmp);
    while (heap.size() > 1) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      auto a = heap.back();
      heap.pop_back();
      std::pop_heap(heap.begin(), heap.end(), cmp);
      auto b = heap.back();
      heap.pop_back();
      nodes.push_back({a.first + b.first, a.second, b.second});
      heap.push_back({nodes.back().w, (int)nodes.size() - 1});
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
    // depths, from the root down
    std::vector<int> depth(nodes.size(), 0);
    int max_depth = 0;
    for (int i = (int)nodes.size() - 1; i >= 0; --i) {
      if (nodes[i].left >= 0) {
        depth[nodes[i].left] = depth[i] + 1;
        depth[nodes[i].right] = depth[i] + 1;
      } else {
        len[nodes[i].right] = depth[i];
        max_depth = std::max(max_depth, depth[i]);
      }
    }
    if (max_depth <= limit) return len;
  }
}

// Canonical codes, bit-reversed for the LSB-first stream.
std::vector<uint32_t> canonical_codes(const std::vector<int>& len) {
  int count[kMaxCodeLength + 2] = {0}, next[kMaxCodeLength + 2] = {0};
  for (int l : len) ++count[l];
  count[0] = 0;
  int code = 0;
  for (int l = 1; l <= kMaxCodeLength; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  std::vector<uint32_t> codes(len.size(), 0);
  for (size_t s = 0; s < len.size(); ++s) {
    const int l = len[s];
    if (!l) continue;
    const int c = next[l]++;
    uint32_t r = 0;
    for (int i = 0; i < l; ++i) r |= ((c >> (l - 1 - i)) & 1u) << i;
    codes[s] = r;
  }
  return codes;
}

struct Code {
  std::vector<int> len;
  std::vector<uint32_t> bits;
  bool zero_bits = false;  // one symbol: read with no bits
  void put(BitWriter& bw, int s) const {
    if (!zero_bits) bw.put(bits[s], len[s]);
  }
};

// Writes a prefix code for `counts` (as the decoder's read_code reads it) and
// returns it.
Code write_code(BitWriter& bw, const std::vector<uint32_t>& counts) {
  Code c;
  c.len = code_lengths(counts, kMaxCodeLength);
  std::vector<int> syms;
  for (size_t s = 0; s < counts.size(); ++s)
    if (c.len[s]) syms.push_back((int)s);
  if (syms.size() <= 2 && (syms.empty() || syms.back() < 256)) {
    if (syms.empty()) syms.push_back(0);
    bw.put(1, 1);
    bw.put((uint32_t)syms.size() - 1, 1);
    if (syms[0] < 2) {
      bw.put(0, 1);
      bw.put(syms[0], 1);
    } else {
      bw.put(1, 1);
      bw.put(syms[0], 8);
    }
    if (syms.size() == 2) bw.put(syms[1], 8);
    c.len.assign(counts.size(), 0);
    for (int s : syms) c.len[s] = 1;
    c.zero_bits = syms.size() == 1;
    c.bits = canonical_codes(c.len);
    return c;
  }
  c.zero_bits = syms.size() == 1;
  c.bits = canonical_codes(c.len);
  // the lengths as tokens: 0-15, and 17 / 18 for runs of zeros
  std::vector<std::pair<int, int>> tokens;  // (symbol, extra bits value)
  const int n = (int)c.len.size();
  for (int i = 0; i < n;) {
    if (c.len[i] == 0) {
      int run = 1;
      while (i + run < n && c.len[i + run] == 0 && run < 138) ++run;
      if (run >= 11) {
        tokens.push_back({18, run - 11});
      } else if (run >= 3) {
        tokens.push_back({17, run - 3});
      } else {
        for (int k = 0; k < run; ++k) tokens.push_back({0, 0});
      }
      i += run;
    } else {
      tokens.push_back({c.len[i], 0});
      ++i;
    }
  }
  std::vector<uint32_t> tcounts(19, 0);
  for (auto& t : tokens) ++tcounts[t.first];
  Code cl;
  cl.len = code_lengths(tcounts, 7);
  int used = 0;
  for (int l : cl.len) used += l > 0;
  cl.zero_bits = used == 1;
  cl.bits = canonical_codes(cl.len);
  int num_codes = 19;
  while (num_codes > 4 && cl.len[kCodeLengthOrder[num_codes - 1]] == 0) --num_codes;
  bw.put(0, 1);
  bw.put(num_codes - 4, 4);
  for (int i = 0; i < num_codes; ++i) bw.put(cl.len[kCodeLengthOrder[i]], 3);
  bw.put(0, 1);  // max_symbol: the whole alphabet
  for (auto& t : tokens) {
    cl.put(bw, t.first);
    if (t.first == 17) bw.put(t.second, 3);
    if (t.first == 18) bw.put(t.second, 7);
  }
  return c;
}

// LZ77 length / distance value -> (prefix symbol, extra bits, extra value)
inline void prefix_encode(uint32_t v, int* sym, int* nbits, uint32_t* extra) {
  --v;
  if (v < 4) {
    *sym = (int)v;
    *nbits = 0;
    *extra = 0;
    return;
  }
  int h = 31 - __builtin_clz(v);
  int second = (v >> (h - 1)) & 1;
  *sym = 2 * h + second;
  *nbits = h - 1;
  *extra = v & ((1u << (h - 1)) - 1);
}

struct Token {
  uint32_t argb;   // a literal
  uint16_t len;    // 0: literal, else a copy of `len` at plane code `plane`
  uint8_t plane;
};

// An entropy-coded image: one prefix-code group, no colour cache; copies from
// the pixel on the left and from the one above where they repeat.
void write_image(BitWriter& bw, const std::vector<uint32_t>& px, int w, bool level0) {
  const int64_t total = (int64_t)px.size();
  std::vector<Token> tokens;
  tokens.reserve(total);
  for (int64_t i = 0; i < total;) {
    int64_t best = 0;
    int plane = 0;
    if (i >= 1) {
      int64_t k = 0;
      while (i + k < total && k < 4096 && px[i + k] == px[i + k - 1]) ++k;
      best = k;
      plane = 2;  // (1, 0): the pixel on the left
    }
    if (i >= w) {
      int64_t k = 0;
      while (i + k < total && k < 4096 && px[i + k] == px[i + k - w]) ++k;
      if (k > best) {
        best = k;
        plane = 1;  // (0, 1): the pixel above
      }
    }
    if (best >= 3) {
      tokens.push_back({0, (uint16_t)best, (uint8_t)plane});
      i += best;
    } else {
      tokens.push_back({px[i], 0, 0});
      ++i;
    }
  }
  std::vector<uint32_t> hg(kLiteral + kLengthCodes, 0), hr(256, 0), hb(256, 0), ha(256, 0),
      hd(kDistanceCodes, 0);
  for (const Token& t : tokens) {
    if (t.len) {
      int sym, nb;
      uint32_t ex;
      prefix_encode(t.len, &sym, &nb, &ex);
      ++hg[kLiteral + sym];
      prefix_encode(t.plane, &sym, &nb, &ex);
      ++hd[sym];
    } else {
      ++hg[(t.argb >> 8) & 0xff];
      ++hr[(t.argb >> 16) & 0xff];
      ++hb[t.argb & 0xff];
      ++ha[t.argb >> 24];
    }
  }
  bw.put(0, 1);             // no colour cache
  if (level0) bw.put(0, 1);  // no meta prefix codes
  const Code cg = write_code(bw, hg), cr = write_code(bw, hr), cb = write_code(bw, hb),
             ca = write_code(bw, ha), cd = write_code(bw, hd);
  for (const Token& t : tokens) {
    if (t.len) {
      int sym, nb;
      uint32_t ex;
      prefix_encode(t.len, &sym, &nb, &ex);
      cg.put(bw, kLiteral + sym);
      bw.put(ex, nb);
      prefix_encode(t.plane, &sym, &nb, &ex);
      cd.put(bw, sym);
      bw.put(ex, nb);
    } else {
      cg.put(bw, (t.argb >> 8) & 0xff);
      cr.put(bw, (t.argb >> 16) & 0xff);
      cb.put(bw, t.argb & 0xff);
      ca.put(bw, t.argb >> 24);
    }
  }
}

inline uint32_t sub_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
  uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline int residual_cost(uint32_t r) {
  int c = 0;
  for (int s = 0; s < 32; s += 8) {
    int v = (r >> s) & 0xff;
    c += v < 128 ? v : 256 - v;
  }
  return c;
}

constexpr int kEncodeBits = 4;  // 16 x 16 predictor tiles

// A VP8L bitstream (header included) of w x h ARGB: subtract-green, then a
// predictor per tile (the mode of least absolute residual), then the residuals.
std::vector<uint8_t> vp8l_encode(const uint32_t* argb, int w, int h, bool alpha) {
  const int64_t total = (int64_t)w * h;
  std::vector<uint32_t> px(argb, argb + total);
  for (auto& p : px) {
    const uint32_t g = (p >> 8) & 0xff;
    const uint32_t rb = ((p & 0x00ff00ffu) + 0x01000100u - ((g << 16) | g)) & 0x00ff00ffu;
    p = (p & 0xff00ff00u) | rb;
  }
  const int tw = div_round_up(w, kEncodeBits), th = div_round_up(h, kEncodeBits);
  std::vector<uint32_t> modes((size_t)tw * th);
  std::vector<uint32_t> res((size_t)total);
  auto pred_at = [&](int mode, int x, int y) -> uint32_t {
    if (y == 0) return x == 0 ? 0xff000000u : px[x - 1];
    if (x == 0) return px[(size_t)(y - 1) * w];
    const size_t i = (size_t)y * w + x;
    return predict(mode, &px[i - w], px[i - 1]);
  };
  for (int ty = 0; ty < th; ++ty)
    for (int tx = 0; tx < tw; ++tx) {
      const int x0 = tx << kEncodeBits, y0 = ty << kEncodeBits;
      const int x1 = std::min(w, x0 + (1 << kEncodeBits)), y1 = std::min(h, y0 + (1 << kEncodeBits));
      int best_mode = 0;
      int64_t best_cost = -1;
      for (int mode = 0; mode < 14; ++mode) {
        int64_t cost = 0;
        for (int y = y0; y < y1 && (best_cost < 0 || cost < best_cost); ++y)
          for (int x = x0; x < x1; ++x)
            cost += residual_cost(sub_pixels(px[(size_t)y * w + x], pred_at(mode, x, y)));
        if (best_cost < 0 || cost < best_cost) {
          best_cost = cost;
          best_mode = mode;
        }
      }
      modes[(size_t)ty * tw + tx] = 0xff000000u | ((uint32_t)best_mode << 8);
      for (int y = y0; y < y1; ++y)
        for (int x = x0; x < x1; ++x)
          res[(size_t)y * w + x] = sub_pixels(px[(size_t)y * w + x], pred_at(best_mode, x, y));
    }
  BitWriter bw;
  bw.put(0x2f, 8);
  bw.put(w - 1, 14);
  bw.put(h - 1, 14);
  bw.put(alpha ? 1 : 0, 1);
  bw.put(0, 3);
  bw.put(1, 1);
  bw.put(2, 2);  // subtract green
  bw.put(1, 1);
  bw.put(0, 2);  // predictor
  bw.put(kEncodeBits - 2, 3);
  write_image(bw, modes, tw, false);
  bw.put(0, 1);  // no more transforms
  write_image(bw, res, w, true);
  bw.finish();
  return bw.out;
}

}  // namespace

extern "C" {

// A VP8L chunk (its 5-byte header included) of w x h -> ARGB.
int mkw_vp8l_decode(const uint8_t* src, int64_t n, int w, int h, uint32_t* out, char* err,
                    int errlen) {
  try {
    LBits br(src, n);
    if (br.read(8) != 0x2f) throw Error{"not a VP8L stream (bad signature)"};
    const int fw = (int)br.read(14) + 1, fh = (int)br.read(14) + 1;
    br.read(1);
    if (br.read(3) != 0) throw Error{"unsupported VP8L version"};
    if (fw != w || fh != h) throw Error{"VP8L size differs from the caller's"};
    std::vector<uint32_t> px = decode_image(br, w, h);
    std::memcpy(out, px.data(), px.size() * 4);
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

// A VP8 chunk of w x h -> (h, w, 3) RGB through libwebp's fancy upsampler.
int mkw_vp8_decode(const uint8_t* src, int64_t n, int w, int h, uint8_t* rgb, char* err,
                   int errlen) {
  try {
    VP8Frame f;
    vp8_decode(src, n, f);
    if (f.width != w || f.height != h) throw Error{"VP8 size differs from the caller's"};
    vp8_to_rgb(f, rgb);
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

// The first partition's bits as a full decode reads them ((prob << 1) | bit,
// up to `cap`), their count and the index of the loop-filter-delta flag.
int mkw_vp8_trace(const uint8_t* src, int64_t n, uint16_t* out, int64_t cap, int64_t* count,
                  int64_t* lf_delta_at, char* err, int errlen) {
  try {
    VP8Frame f;
    VP8Trace trace;
    vp8_decode(src, n, f, nullptr, &trace);
    *count = (int64_t)trace.bits.size();
    *lf_delta_at = trace.lf_delta_at;
    std::memcpy(out, trace.bits.data(), std::min<int64_t>(cap, *count) * 2);
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

// What a VP8L chunk used (VP8LInfo, 4 ints), decoding all of it.
int mkw_vp8l_info(const uint8_t* src, int64_t n, int* out, char* err, int errlen) {
  VP8LInfo info;
  g_linfo = &info;
  try {
    LBits br(src, n);
    br.read(8);
    const int w = (int)br.read(14) + 1, h = (int)br.read(14) + 1;
    br.read(4);
    decode_image(br, w, h);
    g_linfo = nullptr;
    std::memcpy(out, &info, sizeof(info));
    return 0;
  } catch (const Error& e) {
    g_linfo = nullptr;
    put_err(e.msg, err, errlen);
    return 1;
  }
}

// The header fields of a VP8 chunk (VP8Info, 8 ints).
int mkw_vp8_info(const uint8_t* src, int64_t n, int* out, char* err, int errlen) {
  try {
    VP8Frame f;
    VP8Info info;
    vp8_decode(src, n, f, &info);
    std::memcpy(out, &info, sizeof(info));
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

// An ALPH chunk of a w x h frame -> w * h alpha values.
int mkw_alpha_decode(const uint8_t* src, int64_t n, int w, int h, uint8_t* out, char* err,
                     int errlen) {
  try {
    alpha_decode(src, n, w, h, out);
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

// w x h ARGB -> a VP8L chunk's payload in `dst` (`cap` bytes); *written its size.
int mkw_vp8l_encode(const uint32_t* argb, int w, int h, int alpha, uint8_t* dst, int64_t cap,
                    int64_t* written, char* err, int errlen) {
  try {
    std::vector<uint8_t> out = vp8l_encode(argb, w, h, alpha != 0);
    if ((int64_t)out.size() > cap) throw Error{"VP8L output buffer too small"};
    std::memcpy(dst, out.data(), out.size());
    *written = (int64_t)out.size();
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

}  // extern "C"
