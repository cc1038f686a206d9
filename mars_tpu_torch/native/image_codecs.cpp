// Host image codecs of the port's data path, bound through ctypes
// (native/__init__.py): a JPEG decoder, PNG's row unfiltering and PIL's
// polygon fill and the inner loop of its resampling, each written to give
// the bytes that Pillow 12.1.0 on libjpeg-turbo 3.1.3 gives for the same
// file or the same call.
//
// JPEG: Huffman-coded baseline, extended sequential and progressive frames
// (SOF0, SOF1, SOF2), 8-bit samples, 1, 3 or 4 components with sampling
// factors 1-2, restart markers.  Decoding follows libjpeg's defaults as
// Pillow leaves them: the integer "slow" IDCT (jidctint.c's
// jpeg_idct_islow), fancy upsampling (jdsample.c's triangle filters for
// h2v1, h1v2 and h2v2, box replication where libjpeg uses it), the
// integer YCbCr->RGB tables of jdcolor.c, libjpeg's colour-space rules
// (JFIF, Adobe APP14 transform, component ids) and Pillow's inverted
// ("CMYK;I") reading of 4-component files.  Everything else raises,
// naming what it met: lossless, hierarchical and arithmetic-coded frames,
// 12-bit samples, data that ends before the image does, and progressive
// files whose scans leave coefficients unrefined (libjpeg smooths those).
//
// Every entry point returns 0, or 1 with a message in `err`.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct CodecError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError(msg); }

std::string hex_marker(int m) {
  char b[8];
  std::snprintf(b, sizeof b, "0xFF%02X", m & 0xFF);
  return b;
}

// zigzag index -> natural index; 16 extra entries absorb a corrupt run
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman
struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << 9];  // (length << 8) | value for codes of <= 9 bits, 0 otherwise

  void build(const uint8_t counts[17], const uint8_t* values, int nvals, bool dc) {
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < counts[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail("JPEG: bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l]) {
        valoffset[l] = p - huffcode[p];
        p += counts[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memcpy(vals, values, nvals);
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= 9; l++)
      for (int i = 0; i < counts[l]; i++, p++) {
        int lookbits = huffcode[p] << (9 - l);
        for (int c = 0; c < (1 << (9 - l)); c++) look[lookbits + c] = (uint16_t)((l << 8) | vals[p]);
      }
    if (dc)
      for (int i = 0; i < nvals; i++)
        if (vals[i] > 15) fail("JPEG: bad Huffman table");
    defined = true;
  }
};

// ---------------------------------------------------------------- bits
// Entropy-coded bytes with 0xFF00 stuffing.  At a marker the reader feeds
// zero bits, as libjpeg does; consuming one of them means the segment
// ended early, and running off the end of the file means it was cut.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int bits = 0;
  bool at_marker = false;

  BitReader(const uint8_t* d_, size_t n_, size_t pos_) : d(d_), n(n_), pos(pos_) {}

  void fill(int need) {
    while (bits < need && bits <= 56) {
      if (at_marker || pos >= n) return;
      uint8_t b = d[pos];
      if (b == 0xFF) {
        if (pos + 1 >= n) return;
        uint8_t b2 = d[pos + 1];
        if (b2 == 0x00) {
          pos += 2;
        } else if (b2 == 0xFF) {  // fill byte before a marker
          pos++;
          continue;
        } else {
          at_marker = true;
          return;
        }
      } else {
        pos++;
      }
      acc |= (uint64_t)b << (56 - bits);
      bits += 8;
    }
  }

  void short_of(int need) {
    if (bits >= need) return;
    if (!at_marker) fail("JPEG: image file is truncated");
    fail("JPEG: corrupt data: the entropy-coded segment ends early");
  }

  int peek(int nb) {  // zero-padded past what is there
    fill(nb);
    return (int)(acc >> (64 - nb));
  }

  void skip(int nb) {
    short_of(nb);
    acc <<= nb;
    bits -= nb;
  }

  int get(int nb) {
    if (nb == 0) return 0;
    fill(nb);
    short_of(nb);
    int v = (int)(acc >> (64 - nb));
    acc <<= nb;
    bits -= nb;
    return v;
  }

  int decode(const Huffman& h) {
    int look = h.look[peek(9)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int l = 10;
    fill(16);
    int code = (int)(acc >> (64 - l));
    while (l <= 16 && code > h.maxcode[l]) {
      l++;
      code = (int)(acc >> (64 - l));
    }
    if (l > 16) fail("JPEG: corrupt data: bad Huffman code");
    skip(l);
    return h.vals[code + h.valoffset[l]];
  }

  // discard the partial byte, then expect RSTn
  void restart(int expected) {
    acc = 0;
    bits = 0;
    if (!at_marker) {
      while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF)) pos++;
      if (pos + 1 >= n) fail("JPEG: image file is truncated");
    }
    while (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] == 0xFF) pos++;
    if (pos + 1 >= n) fail("JPEG: image file is truncated");
    int m = d[pos + 1];
    if (m != 0xD0 + expected)
      fail("JPEG: expected restart marker RST" + std::to_string(expected) + ", found " +
           hex_marker(m));
    pos += 2;
    at_marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---------------------------------------------------------------- frame
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;  // downsampled size in samples (libjpeg's downsampled_width/height)
  int bw = 0, bh = 0;  // blocks held: the MCU grid's
  std::vector<int16_t> coef;
  uint16_t q[64];
  bool latched = false;
  int coef_bits[64];
  int dc_tbl = 0, ac_tbl = 0, pred = 0;
};

struct Jpeg {
  const uint8_t* d;
  size_t n;
  int width = 0, height = 0, ncomp = 0, sof = -1;
  bool progressive = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1, restart_interval = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;

  Jpeg(const uint8_t* d_, size_t n_) : d(d_), n(n_) {}

  int u16(size_t p) const {
    if (p + 2 > n) fail("JPEG: image file is truncated");
    return (d[p] << 8) | d[p + 1];
  }

  // the segment after a marker at `p` (p points at 0xFF): [start, end)
  std::pair<size_t, size_t> segment(size_t p) const {
    int len = u16(p + 2);
    if (len < 2) fail("JPEG: bad marker length");
    if (p + 2 + len > n) fail("JPEG: image file is truncated");
    return {p + 4, p + 2 + len};
  }

  void read_sof(size_t s, size_t e, int marker) {
    if (sof >= 0) fail("JPEG: more than one frame header");
    if (e - s < 6) fail("JPEG: bad SOF length");
    int precision = d[s];
    if (precision != 8)
      fail("JPEG: " + std::to_string(precision) + "-bit samples (" + hex_marker(marker) +
           ") are not supported: only 8-bit");
    height = u16(s + 1);
    width = u16(s + 3);
    ncomp = d[s + 5];
    if (height == 0) fail("JPEG: the frame's height is 0 (DNL marker) : not supported");
    if (width == 0) fail("JPEG: the frame's width is 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("JPEG: " + std::to_string(ncomp) + " components: not supported");
    if (e - s != (size_t)(6 + 3 * ncomp)) fail("JPEG: bad SOF length");
    comps.resize(ncomp);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comps[i];
      c.id = d[s + 6 + 3 * i];
      c.h = d[s + 7 + 3 * i] >> 4;
      c.v = d[s + 7 + 3 * i] & 15;
      c.tq = d[s + 8 + 3 * i];
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        fail("JPEG: sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) +
             ": only 1 and 2 are supported");
      if (c.tq > 3) fail("JPEG: bad quantisation table index");
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    sof = marker;
    progressive = marker == 0xC2;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      if (ncomp == 1) {  // a lone component is its own MCU, at full size
        c.h = c.v = 1;
      }
      int hm = ncomp == 1 ? 1 : hmax, vm = ncomp == 1 ? 1 : vmax;
      c.dw = (int)(((long long)width * c.h + hm - 1) / hm);
      c.dh = (int)(((long long)height * c.v + vm - 1) / vm);
      c.bw = ncomp == 1 ? (c.dw + 7) / 8 : mcux * c.h;
      c.bh = ncomp == 1 ? (c.dh + 7) / 8 : mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    if (ncomp == 1) hmax = vmax = 1;
  }

  void read_dqt(size_t s, size_t e) {
    while (s < e) {
      int pq = d[s] >> 4, tq = d[s] & 15;
      s++;
      if (tq > 3 || pq > 1) fail("JPEG: bad quantisation table");
      size_t need = pq ? 128 : 64;
      if (s + need > e) fail("JPEG: bad DQT length");
      for (int k = 0; k < 64; k++) qt[tq][kNatural[k]] = pq ? (uint16_t)u16(s + 2 * k) : d[s + k];
      qt_defined[tq] = true;
      s += need;
    }
  }

  void read_dht(size_t s, size_t e) {
    while (s < e) {
      int tc = d[s] >> 4, th = d[s] & 15;
      if (s + 17 > e) fail("JPEG: bad DHT length");
      uint8_t counts[17];
      counts[0] = 0;
      int total = 0;
      for (int l = 1; l <= 16; l++) total += counts[l] = d[s + l];
      s += 17;
      if (tc > 1 || th > 3 || total > 256 || s + total > e) fail("JPEG: bad Huffman table");
      (tc ? ac : dc)[th].build(counts, d + s, total, tc == 0);
      s += total;
    }
  }

  void read_app(size_t s, size_t e, int marker) {
    size_t len = e - s;
    if (marker == 0xE0 && len >= 14 && std::memcmp(d + s, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(d + s, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[s + 11];
    }
  }

  // ------------------------------------------------------------ scans
  size_t scan(size_t s, size_t e) {
    if (sof < 0) fail("JPEG: scan before the frame header");
    int ns = d[s];
    if (ns < 1 || ns > 4 || e - s != (size_t)(4 + 2 * ns)) fail("JPEG: bad SOS length");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = d[s + 1 + 2 * i];
      Component* c = nullptr;
      for (Component& k : comps)
        if (k.id == id && std::find(sc.begin(), sc.end(), &k) == sc.end()) {
          c = &k;
          break;
        }
      if (!c) fail("JPEG: the scan names a component that the frame has not");
      c->dc_tbl = d[s + 2 + 2 * i] >> 4;
      c->ac_tbl = d[s + 2 + 2 * i] & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) fail("JPEG: bad Huffman table index");
      sc.push_back(c);
    }
    int ss = d[s + 1 + 2 * ns], se = d[s + 2 + 2 * ns];
    int ah = d[s + 3 + 2 * ns] >> 4, al = d[s + 3 + 2 * ns] & 15;
    if (progressive) {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1))
        fail("JPEG: bad progressive scan parameters");
      if (ah > 13 || al > 13) fail("JPEG: bad progressive scan parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("JPEG: bad sequential scan parameters");
    }
    for (Component* c : sc) {
      if (!c->latched) {  // libjpeg latches a table at the component's first scan
        if (!qt_defined[c->tq]) fail("JPEG: a quantisation table is missing");
        std::memcpy(c->q, qt[c->tq], sizeof c->q);
        c->latched = true;
      }
      bool needs_dc = ss == 0 && ah == 0, needs_ac = !progressive || ss > 0;
      if (needs_dc && !dc[c->dc_tbl].defined) fail("JPEG: a Huffman table is missing");
      if (needs_ac && !ac[c->ac_tbl].defined) fail("JPEG: a Huffman table is missing");
      for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
      c->pred = 0;
    }

    BitReader br(d, n, e);
    int eobrun = 0, restarts_to_go = restart_interval, next_rst = 0;
    long long mcus;
    int per_row;
    if (ns == 1) {
      per_row = (sc[0]->dw + 7) / 8;
      mcus = (long long)per_row * ((sc[0]->dh + 7) / 8);
    } else {
      per_row = mcux;
      mcus = (long long)mcux * mcuy;
    }
    for (long long m = 0; m < mcus; m++) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          br.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          restarts_to_go = restart_interval;
          eobrun = 0;
          for (Component* c : sc) c->pred = 0;
        }
        restarts_to_go--;
      }
      int my = (int)(m / per_row), mx = (int)(m % per_row);
      for (Component* c : sc) {
        int nv = ns == 1 ? 1 : c->v, nh = ns == 1 ? 1 : c->h;
        for (int by = 0; by < nv; by++)
          for (int bx = 0; bx < nh; bx++) {
            int row = my * nv + by, col = mx * nh + bx;
            int16_t* blk = &c->coef[((size_t)row * c->bw + col) * 64];
            if (!progressive) {
              block_sequential(br, *c, blk);
            } else if (ss == 0) {
              if (ah == 0) {
                int t = br.decode(dc[c->dc_tbl]);
                int diff = t ? extend(br.get(t), t) : 0;
                c->pred += diff;
                blk[0] = (int16_t)(c->pred * (1 << al));
              } else if (br.get(1)) {
                blk[0] = (int16_t)(blk[0] | (1 << al));
              }
            } else if (ah == 0) {
              ac_first(br, *c, blk, ss, se, al, eobrun);
            } else {
              ac_refine(br, *c, blk, ss, se, al, eobrun);
            }
          }
      }
    }
    // the next marker: after the bytes the reader took
    size_t p = br.pos;
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0x00 && d[p + 1] != 0xFF &&
                          !(d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7)))
      p++;
    if (p + 1 >= n) fail("JPEG: image file is truncated");
    return p;
  }

  void block_sequential(BitReader& br, Component& c, int16_t* blk) {
    int t = br.decode(dc[c.dc_tbl]);
    int diff = t ? extend(br.get(t), t) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    const Huffman& h = ac[c.ac_tbl];
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void ac_first(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al, int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huffman& h = ac[c.ac_tbl];
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)(extend(br.get(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
  }

  void ac_refine(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const Huffman& h = ac[c.ac_tbl];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("JPEG: corrupt data: bad refinement value");
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      eobrun--;
    }
  }

  // ------------------------------------------------------------ markers
  void parse(bool header_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("JPEG: no SOI marker");
    size_t p = 2;
    while (true) {
      while (p < n && d[p] != 0xFF) p++;  // libjpeg skips stray bytes
      while (p + 1 < n && d[p + 1] == 0xFF) p++;
      if (p + 1 >= n) fail("JPEG: image file is truncated");
      int m = d[p + 1];
      if (m == 0xD9) return;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        p += 2;
        continue;
      }
      auto seg = segment(p);
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(seg.first, seg.second, m);
        if (header_only) return;
      } else if (m == 0xC3) {
        fail("JPEG: lossless frames (SOF3, 0xFFC3) are not supported");
      } else if (m >= 0xC5 && m <= 0xC7) {
        fail("JPEG: hierarchical frames (" + hex_marker(m) + ") are not supported");
      } else if (m >= 0xC9 && m <= 0xCF && m != 0xCC) {
        fail("JPEG: arithmetic-coded frames (" + hex_marker(m) + ") are not supported");
      } else if (m == 0xCC) {
        fail("JPEG: arithmetic coding conditioning (DAC, 0xFFCC) is not supported");
      } else if (m == 0xDE || m == 0xDF) {
        fail("JPEG: hierarchical markers (" + hex_marker(m) + ") are not supported");
      } else if (m == 0xDB) {
        read_dqt(seg.first, seg.second);
      } else if (m == 0xC4) {
        read_dht(seg.first, seg.second);
      } else if (m == 0xDD) {
        if (seg.second - seg.first != 2) fail("JPEG: bad DRI length");
        restart_interval = u16(seg.first);
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(seg.first, seg.second, m);
      } else if (m == 0xDA) {
        p = scan(seg.first, seg.second);
        continue;
      }
      p = seg.second;
    }
  }

  // ------------------------------------------------------------ output
  void check_smoothing() const {
    // jdcoefct.c's smoothing_ok: libjpeg smooths the output of a
    // progressive file whose first ten coefficients are not all refined
    if (!progressive) return;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const Component& c : comps) {
      if (!c.latched) return;
      for (int i = 0; i < 10; i++)
        if (c.q[kPos[i]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      fail("JPEG: a progressive file whose scans leave low coefficients unrefined "
           "(libjpeg's block smoothing) is not supported");
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride,
                         const uint8_t* range) {
    // jidctint.c: CONST_BITS 13, PASS1_BITS 2
    const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int32_t ws[64];
    for (int c = 0; c < 8; c++) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
          ip[48] == 0 && ip[56] == 0) {
        int32_t dcval = (int32_t)ip[0] * qp[0] * 4;
        for (int r = 0; r < 8; r++) ws[r * 8 + c] = dcval;
        continue;
      }
      int32_t z2 = (int32_t)ip[16] * qp[16], z3 = (int32_t)ip[48] * qp[48];
      int32_t z1 = (z2 + z3) * F0541;
      int32_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      z2 = (int32_t)ip[0] * qp[0];
      z3 = (int32_t)ip[32] * qp[32];
      int32_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (int32_t)ip[56] * qp[56];
      tmp1 = (int32_t)ip[40] * qp[40];
      tmp2 = (int32_t)ip[24] * qp[24];
      tmp3 = (int32_t)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int32_t z4 = tmp1 + tmp3;
      int32_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 11;  // CONST_BITS - PASS1_BITS
      const int32_t rnd = 1 << (sh - 1);
      ws[0 * 8 + c] = (tmp10 + tmp3 + rnd) >> sh;
      ws[7 * 8 + c] = (tmp10 - tmp3 + rnd) >> sh;
      ws[1 * 8 + c] = (tmp11 + tmp2 + rnd) >> sh;
      ws[6 * 8 + c] = (tmp11 - tmp2 + rnd) >> sh;
      ws[2 * 8 + c] = (tmp12 + tmp1 + rnd) >> sh;
      ws[5 * 8 + c] = (tmp12 - tmp1 + rnd) >> sh;
      ws[3 * 8 + c] = (tmp13 + tmp0 + rnd) >> sh;
      ws[4 * 8 + c] = (tmp13 - tmp0 + rnd) >> sh;
    }
    for (int r = 0; r < 8; r++) {
      const int32_t* w = ws + r * 8;
      uint8_t* o = out + (size_t)r * stride;
      const int sh = 18;  // CONST_BITS + PASS1_BITS + 3
      const int32_t rnd = 1 << (sh - 1);
      if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
        uint8_t v = range[((w[0] + 16) >> 5) & 1023];
        for (int i = 0; i < 8; i++) o[i] = v;
        continue;
      }
      int32_t z2 = w[2], z3 = w[6];
      int32_t z1 = (z2 + z3) * F0541;
      int32_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      int32_t tmp0 = (w[0] + w[4]) * 8192, tmp1 = (w[0] - w[4]) * 8192;
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int32_t z4 = tmp1 + tmp3;
      int32_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = range[((tmp10 + tmp3 + rnd) >> sh) & 1023];
      o[7] = range[((tmp10 - tmp3 + rnd) >> sh) & 1023];
      o[1] = range[((tmp11 + tmp2 + rnd) >> sh) & 1023];
      o[6] = range[((tmp11 - tmp2 + rnd) >> sh) & 1023];
      o[2] = range[((tmp12 + tmp1 + rnd) >> sh) & 1023];
      o[5] = range[((tmp12 - tmp1 + rnd) >> sh) & 1023];
      o[3] = range[((tmp13 + tmp0 + rnd) >> sh) & 1023];
      o[4] = range[((tmp13 - tmp0 + rnd) >> sh) & 1023];
    }
  }

  // a component's samples at its own resolution: (bh * 8) x (bw * 8)
  std::vector<uint8_t> samples(const Component& c) const {
    // jdmaster.c's post-IDCT range table, indexed by (x & 1023) for x
    // without the +128 level shift
    uint8_t range[1024];
    for (int i = 0; i < 1024; i++) {
      int v = i < 512 ? i + 128 : i - 1024 + 128;
      range[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
    size_t stride = (size_t)c.bw * 8;
    std::vector<uint8_t> out(stride * c.bh * 8);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q, &out[(size_t)by * 8 * stride + bx * 8],
                   (int)stride, range);
    return out;
  }

  // jdsample.c: a component brought to full size, height x width
  std::vector<uint8_t> upsample(const Component& c) const {
    std::vector<uint8_t> src = samples(c);
    size_t stride = (size_t)c.bw * 8;
    int hr = hmax / c.h, vr = vmax / c.v;
    std::vector<uint8_t> out((size_t)width * height);
    auto at = [&](int y, int x) -> int { return src[(size_t)y * stride + x]; };
    auto clamp_row = [&](int y) { return y < 0 ? 0 : y >= c.dh ? c.dh - 1 : y; };
    bool fancy_h = hr == 2 && c.dw > 2;
    std::vector<uint8_t> row((size_t)2 * c.dw + 2);
    for (int y = 0; y < height; y++) {
      uint8_t* o = &out[(size_t)y * width];
      if (hr == 1 && vr == 1) {
        std::memcpy(o, &src[(size_t)y * stride], width);
        continue;
      }
      if (vr == 2 && (hr == 1 || fancy_h)) {
        // triangle filter on rows: the nearer row 3/4, the other 1/4
        int r = y / 2;
        int other = clamp_row(y % 2 ? r + 1 : r - 1);
        if (hr == 1) {  // h1v2_fancy_upsample
          int bias = y % 2 ? 2 : 1;
          for (int x = 0; x < width; x++) o[x] = (uint8_t)((at(r, x) * 3 + at(other, x) + bias) >> 2);
          continue;
        }
        // h2v2_fancy_upsample
        int dw = c.dw;
        auto colsum = [&](int x) { return at(r, x) * 3 + at(other, x); };
        int thiscol = colsum(0), nextcol = colsum(1), lastcol;
        row[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
        row[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 1; x < dw - 1; x++) {
          nextcol = colsum(x + 1);
          row[2 * x] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          row[2 * x + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        row[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        row[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
        std::memcpy(o, row.data(), width);
        continue;
      }
      int r = y / vr;  // box replication down the rows
      if (hr == 1) {
        std::memcpy(o, &src[(size_t)r * stride], width);
      } else if (fancy_h) {  // h2v1_fancy_upsample
        int dw = c.dw;
        int v0 = at(r, 0);
        row[0] = (uint8_t)v0;
        row[1] = (uint8_t)((v0 * 3 + at(r, 1) + 2) >> 2);
        for (int x = 1; x < dw - 1; x++) {
          int iv = at(r, x) * 3;
          row[2 * x] = (uint8_t)((iv + at(r, x - 1) + 1) >> 2);
          row[2 * x + 1] = (uint8_t)((iv + at(r, x + 1) + 2) >> 2);
        }
        int vl = at(r, dw - 1);
        row[2 * dw - 2] = (uint8_t)((vl * 3 + at(r, dw - 2) + 1) >> 2);
        row[2 * dw - 1] = (uint8_t)vl;
        std::memcpy(o, row.data(), width);
      } else {
        for (int x = 0; x < width; x++) o[x] = (uint8_t)at(r, x / 2);
      }
    }
    return out;
  }

  // after parse(false), which returns only at EOI: the pixels, height x
  // width x components
  void render(uint8_t* out) {
    check_smoothing();
    std::vector<std::vector<uint8_t>> planes;
    for (const Component& c : comps) planes.push_back(upsample(c));
    size_t npix = (size_t)width * height;
    if (ncomp == 1) {
      std::memcpy(out, planes[0].data(), npix);
      return;
    }
    // colour space, as jdapimin.c's default_decompress_parms picks it
    bool transform;
    if (ncomp == 3) {
      if (saw_jfif) {
        transform = true;
      } else if (saw_adobe) {
        transform = adobe_transform != 0;
      } else {
        int c0 = comps[0].id, c1 = comps[1].id, c2 = comps[2].id;
        transform = !(c0 == 82 && c1 == 71 && c2 == 66);
      }
    } else {
      transform = saw_adobe && adobe_transform != 0;
    }
    // jdcolor.c's build_ycc_rgb_table: SCALEBITS 16
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    const int32_t half = 1 << 15;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + half) >> 16;
      cb_b[i] = (fix(1.77200) * x + half) >> 16;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    auto clip = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint8_t* p0 = planes[0].data();
    const uint8_t* p1 = planes[1].data();
    const uint8_t* p2 = planes[2].data();
    if (ncomp == 3) {
      for (size_t i = 0; i < npix; i++) {
        uint8_t* o = out + 3 * i;
        if (!transform) {
          o[0] = p0[i];
          o[1] = p1[i];
          o[2] = p2[i];
          continue;
        }
        int y = p0[i], cb = p1[i], cr = p2[i];
        o[0] = clip(y + cr_r[cr]);
        o[1] = clip(y + ((cb_g[cb] + cr_g[cr]) >> 16));
        o[2] = clip(y + cb_b[cb]);
      }
      return;
    }
    // CMYK, or YCCK brought to CMYK; Pillow reads it inverted ("CMYK;I")
    const uint8_t* p3 = planes[3].data();
    for (size_t i = 0; i < npix; i++) {
      uint8_t* o = out + 4 * i;
      uint8_t c, m, yy;
      if (transform) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        c = clip(255 - (y + cr_r[cr]));
        m = clip(255 - (y + ((cb_g[cb] + cr_g[cr]) >> 16)));
        yy = clip(255 - (y + cb_b[cb]));
      } else {
        c = p0[i];
        m = p1[i];
        yy = p2[i];
      }
      o[0] = (uint8_t)(255 - c);
      o[1] = (uint8_t)(255 - m);
      o[2] = (uint8_t)(255 - yy);
      o[3] = (uint8_t)(255 - p3[i]);
    }
  }
};

// ---------------------------------------------------------------- polygon
// Pillow 12.1.0's Draw.c: ImagingDrawPolygon with fill on an 8-bit image
// (_draw_polygon's truncation of the points, add_edge, polygon_generic
// with hline8).  Float arithmetic as Pillow compiles it: `float` edges and
// crossings, no fused multiply-add.
struct Edge {
  int d;
  int x0, y0;
  int xmin, ymin, xmax, ymax;
  float dx;
};

void add_edge(Edge* e, int x0, int y0, int x1, int y1) {
  if (x0 <= x1) {
    e->xmin = x0;
    e->xmax = x1;
  } else {
    e->xmin = x1;
    e->xmax = x0;
  }
  if (y0 <= y1) {
    e->ymin = y0;
    e->ymax = y1;
  } else {
    e->ymin = y1;
    e->ymax = y0;
  }
  if (y0 == y1) {
    e->d = 0;
    e->dx = 0.0f;
  } else {
    e->dx = ((float)(x1 - x0)) / (y1 - y0);
    e->d = y0 == e->ymin ? 1 : -1;
  }
  e->x0 = x0;
  e->y0 = y0;
}

// Draw.c's ROUND_UP / ROUND_DOWN on a float: the positive branch adds in
// float, the negative one in double (fabs returns double in C)
inline int round_up_f(float f) {
  return f >= 0.0 ? (int)std::floor((double)(float)(f + 0.5F)) : (int)-std::floor(std::fabs((double)f) + 0.5);
}
inline int round_down_f(float f) {
  return f >= 0.0 ? (int)std::ceil((double)(float)(f - 0.5F)) : (int)-std::ceil(std::fabs((double)f) - 0.5);
}

void hline8(uint8_t* im, int w, int h, int x0, int y0, int x1, uint8_t ink) {
  if (y0 >= 0 && y0 < h) {
    if (x0 < 0)
      x0 = 0;
    else if (x0 >= w)
      return;
    if (x1 < 0)
      return;
    else if (x1 >= w)
      x1 = w - 1;
    if (x0 <= x1) std::memset(im + (size_t)y0 * w + x0, ink, x1 - x0 + 1);
  }
}

void polygon_generic(uint8_t* im, int w, int h, int n, Edge* e, uint8_t ink) {
  if (n <= 0) return;
  std::vector<Edge*> table;
  int ymin = h - 1, ymax = 0;
  for (int i = 0; i < n; i++) {
    if (ymin > e[i].ymin) ymin = e[i].ymin;
    if (ymax < e[i].ymax) ymax = e[i].ymax;
    if (e[i].ymin == e[i].ymax) {
      hline8(im, w, h, e[i].xmin, e[i].ymin, e[i].xmax, ink);
      continue;
    }
    table.push_back(e + i);
  }
  if (ymin < 0) ymin = 0;
  if (ymax > h) ymax = h;
  int count = (int)table.size();
  std::vector<float> xx((size_t)count * 2 + 1);
  for (; ymin <= ymax; ymin++) {
    int j = 0;
    for (int i = 0; i < count; i++) {
      Edge* cur = table[i];
      if (ymin >= cur->ymin && ymin <= cur->ymax) {
        xx[j++] = (float)(ymin - cur->y0) * cur->dx + (float)cur->x0;
        if (ymin == cur->ymax && ymin < ymax) {
          // needed to draw consistent polygons
          xx[j] = xx[j - 1];
          j++;
        } else if ((ymin == cur->ymin || ymin == cur->ymax) && cur->dx != 0) {
          // connect discontiguous corners
          for (int k = 0; k < i; k++) {
            Edge* other = table[k];
            if ((ymin != other->ymin && ymin != other->ymax) || other->dx == 0) continue;
            // do the two edges join to make a corner?
            if (std::round(xx[j - 1]) != std::round((float)(ymin - other->y0) * other->dx + (float)other->x0))
              continue;
            // the edges' points on the next row, or on the previous one at the edge's last row
            int adj_y = ymin == cur->ymax ? ymin - 1 : ymin + 1;
            if (adj_y < other->ymin || adj_y > other->ymax) continue;
            float adj = (float)(adj_y - cur->y0) * cur->dx + (float)cur->x0;
            float adj_other = (float)(adj_y - other->y0) * other->dx + (float)other->x0;
            if (xx[j - 1] > adj + 1 && xx[j - 1] > adj_other + 1)
              xx[j - 1] = std::round((float)std::fmax((double)adj, (double)adj_other)) + 1;
            else if (xx[j - 1] < adj - 1 && xx[j - 1] < adj_other - 1)
              xx[j - 1] = std::round((float)std::fmin((double)adj, (double)adj_other)) - 1;
            break;
          }
        }
      }
    }
    std::sort(xx.begin(), xx.begin() + j);
    for (int i = 1; i < j; i += 2) hline8(im, w, h, round_up_f(xx[i - 1]), ymin, round_down_f(xx[i]), ink);
  }
}

void draw_polygon(const double* xy_d, int count, uint8_t* im, int w, int h, uint8_t ink) {
  if (count <= 0) return;
  std::vector<int> xy((size_t)count * 2);
  for (int i = 0; i < 2 * count; i++) xy[i] = (int)xy_d[i];  // _draw_polygon truncates toward zero
  std::vector<Edge> e(count);
  int n = 0, i;
  for (i = 0; i < count - 1; i++) {
    int x0 = xy[i * 2], y0 = xy[i * 2 + 1], x1 = xy[i * 2 + 2], y1 = xy[i * 2 + 3];
    if (y0 == y1 && i != 0 && y0 == xy[i * 2 - 1]) {
      // a horizontal line that immediately follows another horizontal line
      Edge* last = &e[n - 1];
      if (x1 > x0 && x0 > xy[i * 2 - 2]) {
        last->xmax = x1;
        continue;
      } else if (x1 < x0 && x0 < xy[i * 2 - 2]) {
        last->xmin = x1;
        continue;
      }
    }
    add_edge(&e[n++], x0, y0, x1, y1);
  }
  if (xy[i * 2] != xy[0] || xy[i * 2 + 1] != xy[1]) add_edge(&e[n++], xy[i * 2], xy[i * 2 + 1], xy[0], xy[1]);
  polygon_generic(im, w, h, n, e.data(), ink);
}

// ---------------------------------------------------------------- PNG
inline int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

void unfilter(const uint8_t* raw, int64_t height, int64_t rowbytes, int bpp, uint8_t* out) {
  for (int64_t y = 0; y < height; y++) {
    const uint8_t* in = raw + y * (rowbytes + 1);
    int f = in[0];
    in++;
    uint8_t* o = out + y * rowbytes;
    const uint8_t* up = y ? o - rowbytes : nullptr;
    for (int64_t x = 0; x < rowbytes; x++) {
      int a = x >= bpp ? o[x - bpp] : 0, b = up ? up[x] : 0, c = (up && x >= bpp) ? up[x - bpp] : 0;
      int v;
      switch (f) {
        case 0: v = in[x]; break;
        case 1: v = in[x] + a; break;
        case 2: v = in[x] + b; break;
        case 3: v = in[x] + ((a + b) >> 1); break;
        case 4: v = in[x] + paeth(a, b, c); break;
        default: fail("PNG: unknown row filter type " + std::to_string(f) + " in row " + std::to_string(y));
      }
      o[x] = (uint8_t)v;
    }
  }
}

// ---------------------------------------------------------------- resample
// One 8-bit pass of Pillow's Resample.c along an axis of an (outer, n, inner)
// uint8 array: out[o][x][i] = clip8((1 << 21) + sum_j in[o][xmin[x] + j][i]
// * k[x][j]) >> 22, the taps past an output's last weighing 0.
void resample_pass(const uint8_t* in, int64_t outer, int64_t n, int64_t inner, const int64_t* xmin,
                   const int32_t* k, int ksize, int64_t out_n, uint8_t* out) {
  const int precision = 22;
  std::vector<int32_t> acc(inner);
  for (int64_t o = 0; o < outer; o++)
    for (int64_t x = 0; x < out_n; x++) {
      const int32_t* kx = k + x * ksize;
      std::fill(acc.begin(), acc.end(), 1 << (precision - 1));
      int64_t taps = std::min<int64_t>(ksize, n - xmin[x]);  // the rest weigh 0
      for (int64_t j = 0; j < taps; j++) {
        const uint8_t* row = in + (o * n + xmin[x] + j) * inner;
        const int32_t w = kx[j];
        for (int64_t i = 0; i < inner; i++) acc[i] += (int32_t)row[i] * w;
      }
      uint8_t* dst = out + (o * out_n + x) * inner;
      for (int64_t i = 0; i < inner; i++) {
        int32_t v = acc[i] >> precision;
        dst[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
      }
    }
}

int report(const std::exception& ex, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, ex.what(), errlen - 1);
    err[errlen - 1] = 0;
  }
  return 1;
}

}  // namespace

extern "C" {

// width, height and channels (1, 3 or 4) of a JPEG's frame
int jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.parse(true);
    if (j.sof < 0) fail("JPEG: no frame header");
    info[0] = j.width;
    info[1] = j.height;
    info[2] = j.ncomp;
    return 0;
  } catch (const std::exception& ex) {
    return report(ex, err, errlen);
  }
}

// the pixels, height x width x channels, into `out` (out_len bytes)
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_len, char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.parse(false);
    if (j.sof < 0) fail("JPEG: no frame header");
    if ((int64_t)j.width * j.height * j.ncomp != out_len) fail("JPEG: output buffer of the wrong size");
    j.render(out);
    return 0;
  } catch (const std::exception& ex) {
    return report(ex, err, errlen);
  }
}

// PNG rows without their filters: raw holds height rows of 1 + rowbytes
int png_unfilter(const uint8_t* raw, int64_t height, int64_t rowbytes, int32_t bpp, uint8_t* out,
                 char* err, int errlen) {
  try {
    unfilter(raw, height, rowbytes, bpp, out);
    return 0;
  } catch (const std::exception& ex) {
    return report(ex, err, errlen);
  }
}

// one pass of PIL's resampling (see resample_pass), the coefficients given
int resample_8bpc(const uint8_t* in, int64_t outer, int64_t n, int64_t inner, const int64_t* xmin,
                  const int32_t* k, int32_t ksize, int64_t out_n, uint8_t* out, char* err,
                  int errlen) {
  try {
    resample_pass(in, outer, n, inner, xmin, k, ksize, out_n, out);
    return 0;
  } catch (const std::exception& ex) {
    return report(ex, err, errlen);
  }
}

// ImageDraw.Draw(im).polygon(xy, fill=ink, outline=ink) on an h x w 8-bit image
int polygon_fill(const double* xy, int32_t count, uint8_t* im, int32_t w, int32_t h, int32_t ink,
                 char* err, int errlen) {
  try {
    draw_polygon(xy, count, im, w, h, (uint8_t)ink);
    return 0;
  } catch (const std::exception& ex) {
    return report(ex, err, errlen);
  }
}

}  // extern "C"
