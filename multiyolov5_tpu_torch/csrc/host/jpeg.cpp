// The bit-serial half of the port's JPEG codec (multiyolov5_tpu_torch/data/jpeg.py):
// the marker walk and Huffman decoding of sequential and progressive files into
// quantised coefficients, and Huffman encoding of quantised coefficients into a
// baseline scan.  Everything arithmetic (dequantisation, IDCT, upsampling,
// colour conversion and their encoder counterparts) is numpy's, in jpeg.py.
//
// Built with g++ on the host at first use and bound through ctypes; a plain C
// interface, no Python or PyTorch headers.  Every entry point returns 0 on
// success, or non-zero with a message written into `err`.  This file is the
// one parser of a file's markers: jpeg.py sizes its buffers from what
// mkj_header reports, and mkj_decode checks them against its own walk.
//
// Decoding follows the ISO/IEC 10918-1 Huffman procedures as libjpeg-turbo
// implements them (jdhuff.c for sequential scans, jdphuff.c for progressive
// ones: DC first and refinement, AC first and refinement with end-of-band runs).
// Where libjpeg-turbo warns and carries on (a corrupt code, a stream that runs
// out, a missing restart marker), this raises instead.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

// zigzag position -> natural (row-major) index, ISO/IEC 10918-1 Figure A.6
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLook = 9;  // bits resolved by one table lookup

struct Error {
  std::string msg;
  bool truncated = false;  // the data ended; a longer prefix of the file may parse
};

struct HuffTable {
  bool defined = false;
  uint8_t look_len[1 << kLook];  // 0: code longer than kLook bits
  uint8_t look_val[1 << kLook];
  int32_t maxcode[18];           // largest code of each length, -1 if none
  int32_t valoffset[18];         // symbol index of a length's first code, minus that code
  uint8_t vals[256];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    // a length's codes must fit in it, the all-ones code left out (jdhuff.c);
    // checked for the whole table before any lookup entry is written
    int32_t code = 0;
    for (int len = 1; len <= 16; ++len) {
      code += counts[len - 1];
      if (counts[len - 1] && code >= (1 << len))
        throw Error{"bad Huffman table (codes overflow their lengths)"};
      code <<= 1;
    }
    std::memset(look_len, 0, sizeof(look_len));
    std::memcpy(vals, symbols, nsym);
    code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      int n = counts[len - 1];
      for (int i = 0; i < n; ++i, ++k, ++code) {
        if (len <= kLook) {
          int shift = kLook - len;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = (uint8_t)len;
            look_val[(code << shift) | j] = symbols[k];
          }
        }
      }
      maxcode[len] = n ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;  // sentinel
    defined = true;
  }
};

// Entropy-coded data reader: 0xFF 0x00 is a data 0xFF; any other 0xFF starts a
// marker, where reading stops and zero bits are supplied.  `fake` counts those
// supplied bits; consuming any of them means the scan ran out of data.
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t buf = 0;
  int cnt = 0;
  int fake = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          if (pos + 1 < n && d[pos + 1] == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
            fake += 8;
          }
        } else {
          ++pos;
        }
      } else {
        fake += 8;
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  inline void need(int k) {
    if (cnt < k) fill();
  }
  inline uint32_t get(int k) {  // k in 1..16
    need(k);
    uint32_t v = (uint32_t)(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  inline int decode(const HuffTable& h) {
    need(16);
    uint32_t peek = (uint32_t)(buf >> (64 - kLook));
    int len = h.look_len[peek];
    if (len) {
      buf <<= len;
      cnt -= len;
      return h.look_val[peek];
    }
    for (len = kLook + 1; len <= 16; ++len) {
      int32_t code = (int32_t)(buf >> (64 - len));
      if (code <= h.maxcode[len]) {
        buf <<= len;
        cnt -= len;
        return h.vals[h.valoffset[len] + code];
      }
    }
    throw Error{"corrupt JPEG data (a Huffman code matches no symbol)"};
  }
  void check() const {
    if (fake > cnt) throw Error{"JPEG data ends inside a scan (truncated or corrupt file)"};
  }
  void reset() {  // byte-align at a restart marker
    buf = 0;
    cnt = 0;
    fake = 0;
    at_marker = false;
  }
};

inline int extend(uint32_t v, int s) {
  return (int)v < (1 << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;        // the coefficient plane's blocks (the MCU grid)
  int dw = 0, dh = 0;        // the component's samples
  int rbw = 0, rbh = 0;      // blocks that hold image samples
  int16_t* coefs = nullptr;  // (bh, bw, 64), natural order
  bool latched = false;
  int coef_bits[64];         // progressive: precision still to come (-1: never sent)
};

// How far a walk goes: to the frame header (its size only, of any frame
// type), to the first scan (the header, validated), or through every scan.
enum Target { kFrame, kFirstScan, kDecode };

// Frame types past baseline, extended and progressive Huffman, by SOF marker.
const char* unsupported_frame(int m) {
  switch (m) {
    case 0xC3: return "lossless";
    case 0xC5: case 0xC6: return "hierarchical";
    case 0xC7: return "hierarchical lossless";
    case 0xC9: case 0xCA: return "arithmetic-coded";
    case 0xCB: return "arithmetic-coded lossless";
    case 0xCD: case 0xCE: case 0xCF: return "arithmetic-coded hierarchical";
  }
  return nullptr;
}

struct Decoder {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t pos = 0;
  Target target = kDecode;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, have_sof = false;
  int restart = 0;
  // colour-space and orientation hints from APPn before the first scan
  bool jfif = false;
  int adobe_transform = -1;
  long long exif_off = -1, exif_len = 0;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  uint16_t qt_latched[4][64];

  int byte() {
    if (pos >= n) throw Error{"JPEG file ends inside a marker segment (truncated)", true};
    return d[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  // next marker code, skipping fill bytes; -1 at the end of the data
  int next_marker() {
    while (pos < n && d[pos] != 0xFF) ++pos;  // tolerate nothing but a marker here
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) return -1;
    return d[pos++];
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) throw Error{"bad DQT segment"};
      for (int k = 0; k < 64; ++k) qt[tq][kNatural[k]] = (uint16_t)(pq ? word() : byte());
      qt_defined[tq] = true;
    }
  }
  void read_dht(size_t end) {
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error{"bad DHT segment"};
      uint8_t counts[16], symbols[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)byte();
      if (total > 256) throw Error{"bad DHT segment (more than 256 symbols)"};
      for (int i = 0; i < total; ++i) symbols[i] = (uint8_t)byte();
      (tc ? ac[th] : dc[th]).build(counts, symbols, total);
    }
  }
  void read_sof(int marker) {
    if (have_sof) throw Error{"JPEG with more than one frame header"};
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    have_sof = true;
    if (target == kFrame) return;
    if (const char* what = unsupported_frame(marker))
      throw Error{std::string(what) + " JPEG is not supported"};
    if (precision != 8)
      throw Error{std::to_string(precision) + "-bit JPEG is not supported (8-bit only)"};
    if (ncomp == 4) throw Error{"4-component (CMYK/YCCK) JPEG is not supported"};
    if (ncomp != 1 && ncomp != 3)
      throw Error{"JPEG with " + std::to_string(ncomp) + " components is not supported"};
    if (height == 0 || width == 0) throw Error{"JPEG with a zero or deferred (DNL) size"};
    progressive = marker == 0xC2;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) throw Error{"bad JPEG sampling factors"};
      if (c.tq > 3) throw Error{"bad JPEG frame header"};
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)  // jdsample.c upsamples by whole ratios only
        throw Error{"JPEG with fractional sampling ratios is not supported"};
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.rbw = (c.dw + 7) / 8;
      c.rbh = (c.dh + 7) / 8;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = progressive ? -1 : 0;
    }
  }

  // Point the components at the caller's planes, which must be the sizes
  // this frame header gives: `ncoefs` int16 values for `want_ncomp` planes.
  void place(int want_ncomp, int16_t* coefs, long long ncoefs) {
    long long total = 0;
    for (int i = 0; i < ncomp; ++i) total += (long long)comp[i].bh * comp[i].bw * 64;
    if (ncomp != want_ncomp || total != ncoefs)
      throw Error{"frame header disagrees with the caller's buffers"};
    for (int i = 0; i < ncomp; ++i) {
      comp[i].coefs = coefs;
      coefs += (size_t)comp[i].bh * comp[i].bw * 64;
    }
  }

  // One scan: its header at `pos`, its entropy-coded data after.
  void read_scan(size_t end) {
    int ns = byte();
    if (ns < 1 || ns > 4) throw Error{"bad scan header"};
    Component* sc[4];
    int td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int cid = byte(), t = byte();
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) sc[i] = &comp[j];
      if (!sc[i]) throw Error{"scan names a component the frame does not have"};
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) throw Error{"bad scan header"};
    }
    int ss = byte(), se = byte(), a = byte();
    if (pos != end) throw Error{"bad scan header length"};
    int ah = a >> 4, al = a & 15;
    if (!progressive) {
      if (ss != 0 || se != 63 || a != 0) throw Error{"bad sequential scan parameters"};
    } else {
      bool dc_scan = ss == 0;
      if ((dc_scan && se != 0) || (!dc_scan && (se < ss || se > 63 || ns != 1)) || al > 13 ||
          ah > 13)
        throw Error{"bad progressive scan parameters"};
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.latched) {  // libjpeg latches a table at the component's first scan
        if (!qt_defined[c.tq]) throw Error{"quantisation table used before it is defined"};
        std::memcpy(qt_latched[&c - comp], qt[c.tq], sizeof(qt[0]));
        c.latched = true;
      }
      bool need_dc = ss == 0 && ah == 0, need_ac = se > 0;
      if ((need_dc && !dc[td[i]].defined) || (need_ac && !ac[ta[i]].defined))
        throw Error{"Huffman table used before it is defined"};
      if (progressive) {
        for (int k = ss; k <= se; ++k) {
          int expect = c.coef_bits[k] < 0 ? 0 : c.coef_bits[k];
          if (ah != expect) throw Error{"progressive scan out of sequence"};
          c.coef_bits[k] = al;
        }
      }
    }

    BitReader br{d, n, pos};
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    long long units, ux;  // MCUs in the scan, MCUs a row
    if (ns == 1) {
      ux = sc[0]->rbw;
      units = ux * sc[0]->rbh;
    } else {
      ux = mcux;
      units = (long long)mcux * mcuy;
    }
    int todo = restart;
    int next_rst = 0;
    for (long long u = 0; u < units; ++u) {
      if (restart && todo == 0) {
        // byte-align, then expect RSTn at the reader's position
        size_t p = br.pos;
        while (p < n && d[p] == 0xFF) ++p;
        if (p >= n || d[p] != 0xD0 + next_rst || (p > 0 && d[p - 1] != 0xFF))
          throw Error{"missing or out-of-order restart marker"};
        br.pos = p + 1;
        br.reset();
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < 4; ++i) pred[i] = 0;
        eobrun = 0;
        todo = restart;
      }
      long long my = u / ux, mx = u % ux;
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        int bh = ns == 1 ? 1 : c.v, bwn = ns == 1 ? 1 : c.h;
        for (int yy = 0; yy < bh; ++yy)
          for (int xx = 0; xx < bwn; ++xx) {
            long long by = my * bh + yy, bx = mx * bwn + xx;
            int16_t* blk = c.coefs + (by * c.bw + bx) * 64;
            if (!progressive)
              block_sequential(br, blk, dc[td[i]], ac[ta[i]], pred[i]);
            else if (ss == 0 && ah == 0)
              pred[i] = dc_first(br, blk, dc[td[i]], pred[i], al);
            else if (ss == 0)
              dc_refine(br, blk, al);
            else if (ah == 0)
              ac_first(br, blk, ac[ta[i]], ss, se, al, eobrun);
            else
              ac_refine(br, blk, ac[ta[i]], ss, se, al, eobrun);
          }
      }
      br.check();
      if (restart) --todo;
    }
    br.check();
    pos = br.pos;  // at the marker after the scan (or the end of the data)
  }

  void block_sequential(BitReader& br, int16_t* blk, const HuffTable& hd, const HuffTable& ha,
                        int& pred) {
    int s = br.decode(hd);
    if (s > 15) throw Error{"corrupt JPEG data (bad DC magnitude category)"};
    int diff = s ? extend(br.get(s), s) : 0;
    pred += diff;
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) throw Error{"corrupt JPEG data (coefficient past the block)"};
        blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
  int dc_first(BitReader& br, int16_t* blk, const HuffTable& hd, int pred, int al) {
    int s = br.decode(hd);
    if (s > 15) throw Error{"corrupt JPEG data (bad DC magnitude category)"};
    if (s) pred += extend(br.get(s), s);
    blk[0] = (int16_t)(pred * (1 << al));
    return pred;
  }
  void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get(1)) blk[0] |= (int16_t)(1 << al);
  }
  void ac_first(BitReader& br, int16_t* blk, const HuffTable& ha, int ss, int se, int al,
                int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) throw Error{"corrupt JPEG data (coefficient past the band)"};
        blk[kNatural[k]] = (int16_t)(extend(br.get(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }
  void ac_refine(BitReader& br, int16_t* blk, const HuffTable& ha, int ss, int se, int al,
                 int& eobrun) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) throw Error{"corrupt JPEG data (bad refinement magnitude)"};
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {  // skip already-nonzero coefs (refining each) and r zero ones
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            if (br.get(1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) throw Error{"corrupt JPEG data (coefficient past the band)"};
          blk[kNatural[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0 && br.get(1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eobrun;
    }
  }


  // Walk the markers from SOI as far as `target`; in kDecode, decode every
  // scan into the planes `place` set up.
  void run(int want_ncomp = 0, int16_t* coefs = nullptr, long long ncoefs = 0) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) throw Error{"not a JPEG file"};
    pos = 2;
    bool scanned = false;
    for (;;) {
      int m = next_marker();
      if (m < 0) {
        if (!scanned)
          throw Error{"JPEG file ends before its image data (truncated)", target != kDecode};
        break;  // no EOI: the scans that were there are complete
      }
      if (m == 0xD9) {
        if (!scanned) throw Error{"JPEG without image data"};
        break;
      }
      if (m == 0xD8) throw Error{"JPEG with a second start-of-image marker"};
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // no length
      size_t start = pos;
      int len = word();
      if (len < 2) throw Error{"bad marker segment length"};
      if (start + len > n)
        throw Error{"marker segment past the end of the file (truncated)", true};
      size_t end = start + len;
      if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDD) {
        restart = word();
      } else if (m == 0xDA) {
        if (!have_sof) throw Error{"scan before the frame header"};
        if (target != kDecode) return;
        read_scan(end);
        scanned = true;
        continue;
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(m);
        if (target == kFrame) return;
        if (target == kDecode) place(want_ncomp, coefs, ncoefs);
      } else if (m == 0xDC) {
        throw Error{"JPEG with a DNL marker is not supported"};
      } else if (m == 0xCC) {
        throw Error{"arithmetic-coded JPEG is not supported"};
      } else if (!scanned && m == 0xE0 && len >= 7 && !std::memcmp(d + pos, "JFIF\0", 5)) {
        jfif = true;
      } else if (!scanned && m == 0xE1 && exif_off < 0 && len >= 8 &&
                 !std::memcmp(d + pos, "Exif\0\0", 6)) {
        exif_off = (long long)pos;
        exif_len = len - 2;
      } else if (!scanned && m == 0xEE && len >= 14 && !std::memcmp(d + pos, "Adobe", 5)) {
        adobe_transform = d[pos + 11];
      }
      if (pos > end) throw Error{"bad marker segment length"};
      pos = end;  // APPn, COM and anything else with a length: skipped
    }
    if (!have_sof) throw Error{"JPEG without a frame header"};
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched) throw Error{"a component is never coded"};
      // libjpeg-turbo smooths blocks whose first AC coefficients are still
      // imprecise after the last scan (jdcoefct.c); that is not reproduced
      for (int k = 0; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          throw Error{"progressive JPEG whose scans leave coefficients unrefined"};
    }
  }
};

void put_err(const std::string& s, char* err, int errlen) {
  if (errlen > 0) std::snprintf(err, (size_t)errlen, "%s", s.c_str());
}

// Huffman encoder state: libjpeg's emit_bits, byte stuffing, ones for padding.
struct BitWriter {
  uint8_t* out;
  int64_t cap, len = 0;
  uint64_t acc = 0;
  int nbits = 0;

  inline void put_byte(uint8_t b) {
    if (len + 2 > cap) throw Error{"encoder output buffer too small"};
    out[len++] = b;
    if (b == 0xFF) out[len++] = 0;
  }
  inline void emit(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      nbits -= 8;
      put_byte((uint8_t)(acc >> nbits));
    }
  }
  void flush() {
    if (nbits) emit(0x7F, 8 - nbits);
    acc = 0;
    nbits = 0;
  }
};

struct EncTable {
  uint32_t code[256];
  uint8_t size[256];
  void build(const uint8_t* counts, const uint8_t* symbols) {
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++c) {
        code[symbols[k]] = c;
        size[symbols[k]] = (uint8_t)len;
      }
      c <<= 1;
    }
  }
};

inline int nbits_of(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const EncTable& dc,
                  const EncTable& ac) {
  int t = blk[0] - last_dc, t2 = t;
  last_dc = blk[0];
  if (t < 0) {
    t = -t;
    --t2;
  }
  int nb = nbits_of(t);
  if (!dc.size[nb]) throw Error{"DC difference outside the Huffman table"};
  bw.emit(dc.code[nb], dc.size[nb]);
  if (nb) bw.emit((uint32_t)t2, nb);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    int v = blk[kNatural[k]];
    if (v == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.emit(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    int a = v, a2 = v;
    if (a < 0) {
      a = -a;
      --a2;
    }
    nb = nbits_of(a);
    int sym = (r << 4) + nb;
    if (nb > 15 || !ac.size[sym]) throw Error{"AC coefficient outside the Huffman table"};
    bw.emit(ac.code[sym], ac.size[sym]);
    bw.emit((uint32_t)a2, nb);
    r = 0;
  }
  if (r > 0) bw.emit(ac.code[0], ac.size[0]);
}

}  // namespace

extern "C" {

// Walk a JPEG's markers to its frame header (`frame_only`: its size, of any
// frame type) or to its first scan (the header, validated as the decoder
// validates it).  info (kInfoLen int32):
//   [0] width, [1] height, [2] components, [3] hmax, [4] vmax, [5] a JFIF
//   APP0 seen, [6] the Adobe APP14 transform (-1: none), [7] offset of the
//   first APP1 Exif segment's body (-1: none), [8] its length; from [9], 8
//   a component: id, h, v, quantisation table, plane blocks down, across,
//   samples down, across (components and on: zero with `frame_only`).
// Returns 0, 1 with a message, or 2 with a message where the data ended
// first (a longer prefix of the file may parse).
constexpr int kInfoLen = 9 + 8 * 3;

int mkj_header(const uint8_t* data, int64_t n, int frame_only, int32_t* info, char* err,
               int errlen) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = (size_t)n;
    dec.target = frame_only ? kFrame : kFirstScan;
    dec.run();
    std::memset(info, 0, sizeof(int32_t) * kInfoLen);
    int32_t head[9] = {dec.width, dec.height, 0, 0, 0, dec.jfif, dec.adobe_transform,
                       (int32_t)dec.exif_off, (int32_t)dec.exif_len};
    std::memcpy(info, head, sizeof(head));
    if (!frame_only) {
      info[2] = dec.ncomp;
      info[3] = dec.hmax;
      info[4] = dec.vmax;
      for (int i = 0; i < dec.ncomp; ++i) {
        const Component& c = dec.comp[i];
        int32_t row[8] = {c.id, c.h, c.v, c.tq, c.bh, c.bw, c.dh, c.dw};
        std::memcpy(info + 9 + 8 * i, row, sizeof(row));
      }
    }
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return e.truncated ? 2 : 1;
  }
}

// Decode a JPEG's entropy-coded data into quantised coefficients.
//   ncomp, coefs, ncoefs: the components' (bh, bw, 64) int16 planes, back to
//           back and zeroed, `ncoefs` values in all, sized from mkj_header;
//           a frame header that gives other sizes raises
//   qt:     out, per component the 64 quantisation values (natural order)
//           latched at its first scan
int mkj_decode(const uint8_t* data, int64_t n, int ncomp, int16_t* coefs, int64_t ncoefs,
               uint16_t* qt, char* err, int errlen) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = (size_t)n;
    dec.run(ncomp, coefs, ncoefs);
    for (int i = 0; i < dec.ncomp; ++i) std::memcpy(qt + 64 * i, dec.qt_latched[i], 128);
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

// Encode one interleaved baseline scan (or the one component of a gray image).
//   geom:   per component h, v, blocks down, blocks across (the MCU grid), and
//           its Huffman table index (0 luma, 1 chroma)
//   coefs:  the components' (bh, bw, 64) int16 planes, back to back,
//           `ncoefs` values in all
//   tables: for index 0 then 1: DC counts[16], DC symbols[12], AC counts[16],
//           AC symbols[162]
//   out:    the scan's bytes (stuffed, padded with ones), its length in *outlen
int mkj_encode(int ncomp, const int32_t* geom, const int16_t* coefs, int64_t ncoefs, int mcux,
               int mcuy, const uint8_t* tables, uint8_t* out, int64_t cap, int64_t* outlen, char* err,
               int errlen) {
  try {
    EncTable dc[2], ac[2];
    for (int t = 0; t < 2; ++t) {
      const uint8_t* p = tables + t * (16 + 12 + 16 + 162);
      dc[t].build(p, p + 16);
      ac[t].build(p + 28, p + 44);
    }
    if (ncomp != 1 && ncomp != 3) throw Error{"the encoder takes 1 or 3 components"};
    const int16_t* plane[3];
    long long total = 0;
    for (int i = 0; i < ncomp; ++i) {
      const int32_t* g = geom + 5 * i;
      if (g[0] < 1 || g[1] < 1 || g[2] != mcuy * g[1] || g[3] != mcux * g[0] || g[4] < 0 ||
          g[4] > 1)
        throw Error{"component geometry disagrees with the MCU grid"};
      plane[i] = coefs + total;
      total += (long long)g[2] * g[3] * 64;
    }
    if (total != ncoefs) throw Error{"coefficient planes disagree with their geometry"};
    BitWriter bw{out, cap};
    int last[3] = {0, 0, 0};
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx)
        for (int i = 0; i < ncomp; ++i) {
          int h = geom[5 * i], v = geom[5 * i + 1], bwid = geom[5 * i + 3], t = geom[5 * i + 4];
          for (int yy = 0; yy < v; ++yy)
            for (int xx = 0; xx < h; ++xx) {
              long long by = (long long)my * v + yy, bx = (long long)mx * h + xx;
              encode_block(bw, plane[i] + (by * bwid + bx) * 64, last[i], dc[t], ac[t]);
            }
        }
    bw.flush();
    *outlen = bw.len;
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  }
}

}  // extern "C"
