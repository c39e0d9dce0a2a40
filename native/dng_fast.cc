// dng_fast: native decode + preprocessing for the pysp_tpu host IO path.
//
// Plays the role libraw (C++) plays in the reference (image.py:224-292): getting
// sensor data out of container files and into normalized float planes fast enough to
// feed the accelerator. Exposed as a C ABI consumed via ctypes (pysp_tpu/io/native.py).
//
// Components:
//   - byteswap/widen of uncompressed 16-bit strips (multithreaded)
//   - lossless JPEG (ITU T.81 process 14, SOF3) decoder — the compression used by
//     essentially all compressed DNGs — plus a matching encoder (predictor 1) used
//     for test fixtures and for writing compressed DNGs
//   - fused black-level/saturation normalization u16 mosaic -> f32 (multithreaded)
//
// Build: make -C native   (g++ -O3 -shared -fPIC, no external deps)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  // DNG_FAST_THREADS caps/pins the pool (benchmarks' threads axis; 0/unset =
  // hardware concurrency)
  if (const char* env = std::getenv("DNG_FAST_THREADS")) {
    int v = std::atoi(env);
    if (v > 0) return v;
  }
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

void parallel_rows(int64_t rows, const std::function<void(int64_t, int64_t)>& fn) {
  int nt = std::min<int64_t>(hw_threads(), rows);
  if (nt <= 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, rows);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------------
// Lossless JPEG (SOF3)
// ---------------------------------------------------------------------------------

struct HuffTable {
  // Canonical DC-style table: maps (length, code) -> ssss category 0..16
  uint16_t min_code[17];
  uint16_t max_code[17];  // inclusive; max_code < min_code means empty level
  int16_t val_index[17];
  uint8_t values[17];
  bool present = false;
};

// Buffered MSB-first bit reader: a 64-bit window refilled a byte at a time
// (byte-stuffing aware), so hot paths peek up to 16 bits and consume in one
// shift instead of looping per bit. Past-end reads see zero bits; `bad` is
// set exactly when a caller consumes beyond the real payload (same contract
// as the original per-bit reader the fuzz/vector tests were written against).
struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos = 0;        // next input byte
  uint64_t acc = 0;       // low `nbits` bits valid
  int nbits = 0;
  int64_t consumed = 0;   // bits handed to callers
  int64_t loaded = 0;     // real payload bits loaded so far
  int64_t real_bits = -1; // total real payload bits, set once input ends
  bool bad = false;
  bool stuffed = true;  // false: plain MSB-first bitstream (NEF/ORF/PEF)
  bool ended = false;

  inline void refill() {
    // fast path: plain bytes, no stuffing/end handling
    if (!ended) {
      while (nbits <= 56 && pos < size) {
        uint8_t raw = data[pos];
        if (stuffed && raw == 0xFF) break;
        acc = (acc << 8) | raw;
        pos++;
        nbits += 8;
        loaded += 8;
      }
      if (nbits > 56) return;
    }
    while (nbits <= 56) {
      int b = -1;
      if (!ended) {
        if (pos >= size) {
          ended = true;
          real_bits = loaded;
        } else {
          uint8_t raw = data[pos++];
          if (stuffed && raw == 0xFF) {
            if (pos < size && data[pos] == 0x00) {
              pos++;
              b = 0xFF;
            } else {  // marker: end of scan
              pos--;
              ended = true;
              real_bits = loaded;
            }
          } else {
            b = raw;
          }
        }
      }
      if (b < 0) {
        b = 0;  // zero-fill padding
      } else {
        loaded += 8;
      }
      acc = (acc << 8) | static_cast<uint64_t>(b);
      nbits += 8;
    }
  }

  // requires refill() first; n in [1, 32]
  inline uint32_t peek(int n) const {
    return static_cast<uint32_t>((acc >> (nbits - n)) & ((1ull << n) - 1));
  }

  inline void consume(int n) {
    nbits -= n;
    consumed += n;
    if (real_bits >= 0 && consumed > real_bits) bad = true;
  }

  inline int get_bits(int n) {
    if (n <= 0) return 0;
    refill();
    uint32_t v = peek(n);
    consume(n);
    return static_cast<int>(v);
  }

  inline int get_bit() { return get_bits(1); }
};

// Flat 16-bit-peek decode table: lut[peek16] = (code_len << 8) | value.
// One 128 KB table per Huffman table, built once per file — turns the
// per-bit canonical-range walk into a single load.
struct HuffLut {
  std::vector<uint16_t> lut;
  bool built = false;
};

template <typename HT>
void build_lut(const HT& ht, HuffLut* out) {
  out->lut.assign(size_t(1) << 16, 0);
  for (int len = 1; len <= 16; ++len) {
    if (ht.val_index[len] < 0) continue;
    for (int code = ht.min_code[len]; code <= ht.max_code[len]; ++code) {
      uint32_t base = static_cast<uint32_t>(code) << (16 - len);
      uint32_t span = 1u << (16 - len);
      uint16_t e = static_cast<uint16_t>(
          (len << 8) | ht.values[ht.val_index[len] + (code - ht.min_code[len])]);
      std::fill(out->lut.begin() + base, out->lut.begin() + base + span, e);
    }
  }
  out->built = true;
}

inline int decode_lut(BitReader& br, const HuffLut& h) {
  br.refill();
  uint16_t e = h.lut[br.peek(16)];
  int len = e >> 8;
  if (len == 0) {  // invalid code: consume the full window like the old walk
    br.consume(16);
    return -1;
  }
  br.consume(len);
  if (br.bad) return -1;
  return e & 0xFF;
}

inline int extend(int v, int ssss) {
  // T.81 F.2.2.1 EXTEND
  if (ssss == 0) return 0;
  if (ssss == 16) return 32768;  // lossless special case
  if (v < (1 << (ssss - 1))) return v - (1 << ssss) + 1;
  return v;
}

struct Sof3 {
  int precision = 0;
  int width = 0;
  int height = 0;
  int n_comp = 0;
  uint8_t comp_id[4];
  uint8_t comp_tq[4];
};

}  // namespace

extern "C" {

// Decode a lossless-JPEG (SOF3) blob into out (height*width*n_comp uint16, component-
// interleaved as stored). Returns 0 on success, negative error codes otherwise.
// out_dims receives [height, width, n_components].
int dng_ljpeg_decode(const uint8_t* data, int64_t size, uint16_t* out,
                     int64_t out_capacity, int32_t* out_dims) {
  if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;  // no SOI

  Sof3 sof;
  HuffTable tables[4];
  int predictor = 1;
  int point_transform = 0;
  uint8_t scan_comp_table[4] = {0, 0, 0, 0};
  int64_t pos = 2;

  while (pos + 4 <= size) {
    if (data[pos] != 0xFF) return -2;
    uint8_t marker = data[pos + 1];
    if (marker == 0xD8) {
      pos += 2;
      continue;
    }
    int seg_len = (data[pos + 2] << 8) | data[pos + 3];
    const uint8_t* seg = data + pos + 4;
    int64_t body = seg_len - 2;

    if (marker == 0xC3) {  // SOF3
      sof.precision = seg[0];
      sof.height = (seg[1] << 8) | seg[2];
      sof.width = (seg[3] << 8) | seg[4];
      sof.n_comp = seg[5];
      if (sof.n_comp < 1 || sof.n_comp > 4) return -3;
      for (int c = 0; c < sof.n_comp; ++c) {
        sof.comp_id[c] = seg[6 + 3 * c];
        // sampling factors seg[7+3c] must be 1x1 for our path
        if (seg[7 + 3 * c] != 0x11) return -4;
      }
    } else if (marker == 0xC4) {  // DHT
      int64_t off = 0;
      while (off + 17 <= body) {
        int th = seg[off] & 0x0F;
        if (th > 3) return -5;
        HuffTable& ht = tables[th];
        ht.present = true;
        int counts[17];
        int total = 0;
        for (int i = 1; i <= 16; ++i) {
          counts[i] = seg[off + i];
          total += counts[i];
        }
        if (total > 17 || off + 17 + total > body) return -6;
        // canonical codes: values listed in length order
        int code = 0, k = 0;
        for (int len = 1; len <= 16; ++len) {
          if (counts[len] > 0) {
            ht.val_index[len] = static_cast<int16_t>(k);
            ht.min_code[len] = static_cast<uint16_t>(code);
            ht.max_code[len] = static_cast<uint16_t>(code + counts[len] - 1);
            for (int i = 0; i < counts[len]; ++i) {
              ht.values[k] = seg[off + 17 + k];
              k++;
            }
            code += counts[len];
          } else {
            ht.val_index[len] = -1;
            ht.min_code[len] = 1;
            ht.max_code[len] = 0;
          }
          code <<= 1;
        }
        off += 17 + total;
      }
    } else if (marker == 0xDA) {  // SOS
      int ns = seg[0];
      if (ns != sof.n_comp) return -7;
      for (int c = 0; c < ns; ++c) {
        uint8_t cs = seg[1 + 2 * c];
        uint8_t td = seg[2 + 2 * c] >> 4;
        int idx = -1;
        for (int k = 0; k < sof.n_comp; ++k)
          if (sof.comp_id[k] == cs) idx = k;
        if (idx < 0) return -8;
        scan_comp_table[idx] = td;
      }
      predictor = seg[1 + 2 * ns];          // Ss
      point_transform = seg[3 + 2 * ns] & 0x0F;  // Al
      pos += 4 + body;

      // --- entropy-coded scan ---
      int W = sof.width, H = sof.height, NC = sof.n_comp;
      int64_t total = static_cast<int64_t>(W) * H * NC;
      if (total > out_capacity) return -9;

      BitReader br{data + pos, size - pos};
      int default_val = 1 << (sof.precision - point_transform - 1);

      HuffLut luts[4];
      for (int c = 0; c < NC; ++c) {
        int td = scan_comp_table[c];
        if (!tables[td].present) return -8;
        if (!luts[td].built) build_lut(tables[td], &luts[td]);
      }

      std::vector<int32_t> prev_row(static_cast<size_t>(W) * NC);
      std::vector<int32_t> cur_row(static_cast<size_t>(W) * NC);

      for (int y = 0; y < H; ++y) {
        for (int x = 0; x < W; ++x) {
          for (int c = 0; c < NC; ++c) {
            int ssss = decode_lut(br, luts[scan_comp_table[c]]);
            if (ssss < 0 || br.bad) return -10;
            int diff = extend(ssss == 16 ? 0 : br.get_bits(ssss), ssss);

            int32_t pred;
            int32_t ra = (x > 0) ? cur_row[(x - 1) * NC + c] : 0;
            int32_t rb = (y > 0) ? prev_row[x * NC + c] : 0;
            int32_t rc = (y > 0 && x > 0) ? prev_row[(x - 1) * NC + c] : 0;

            if (y == 0 && x == 0) {
              pred = default_val;
            } else if (y == 0) {
              pred = ra;
            } else if (x == 0) {
              pred = rb;
            } else {
              switch (predictor) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                case 7: pred = (ra + rb) >> 1; break;
                default: pred = ra; break;
              }
            }
            int32_t v = (pred + diff) & 0xFFFF;
            cur_row[x * NC + c] = v;
            out[(static_cast<int64_t>(y) * W + x) * NC + c] =
                static_cast<uint16_t>(v << point_transform);
          }
        }
        std::swap(prev_row, cur_row);
      }

      out_dims[0] = H;
      out_dims[1] = W;
      out_dims[2] = NC;
      return 0;
    } else if (marker == 0xD9) {  // EOI before SOS
      return -11;
    } else {
      // skip other segments (APPn, COM, ...)
    }
    pos += 4 + body;
  }
  return -12;
}

// Decode n_tiles independent lossless-JPEG tile/strip blobs IN PARALLEL and
// assemble them into a (height, width) uint16 mosaic. `offsets`/`counts` index
// into `data` (the whole file); tiles are row-major tile_h x tile_w windows
// (strip organization = tile_w == width). Each tile is decoded by the exact
// same dng_ljpeg_decode above into a scratch buffer and copied into its
// window, so the output is byte-identical to the serial per-tile loop — the
// threads only exploit the independence of the entropy streams (the same
// parallelism the reference gets from OpenMP, /root/reference/setup.py:9-19).
// Returns 0, or the first failing tile's negative code.
int dng_ljpeg_decode_tiles(const uint8_t* data, int64_t size,
                           const int64_t* offsets, const int64_t* counts,
                           int32_t n_tiles, uint16_t* out, int32_t height,
                           int32_t width, int32_t tile_h, int32_t tile_w) {
  if (n_tiles <= 0 || tile_h <= 0 || tile_w <= 0 || height <= 0 || width <= 0)
    return -90;
  int64_t tiles_x = (width + tile_w - 1) / tile_w;
  if (tiles_x < 1) tiles_x = 1;
  std::atomic<int> err{0};
  parallel_rows(n_tiles, [&](int64_t lo, int64_t hi) {
    // scratch sized for a full tile; multi-component scans span NC adjacent
    // columns per sample, which still totals tile_h*tile_w mosaic values
    std::vector<uint16_t> scratch(static_cast<int64_t>(tile_h) * tile_w);
    for (int64_t idx = lo; idx < hi; ++idx) {
      int64_t o = offsets[idx], c = counts[idx];
      if (o < 0 || c < 0 || o + c > size) {
        err.store(-91);
        return;
      }
      int32_t dims[3] = {0, 0, 0};
      int rc = dng_ljpeg_decode(data + o, c, scratch.data(),
                                static_cast<int64_t>(scratch.size()), dims);
      if (rc != 0) {
        err.store(rc);
        return;
      }
      int64_t ph = dims[0];
      int64_t pw = static_cast<int64_t>(dims[1]) * dims[2];
      int64_t ty = idx / tiles_x, tx = idx % tiles_x;
      int64_t y0 = ty * tile_h, x0 = tx * tile_w;
      if (y0 >= height || x0 >= width) continue;  // excess tiles: ignore
      int64_t h_eff = std::min<int64_t>({tile_h, height - y0, ph});
      int64_t w_eff = std::min<int64_t>({tile_w, width - x0, pw});
      for (int64_t y = 0; y < h_eff; ++y) {
        std::memcpy(out + (y0 + y) * width + x0, scratch.data() + y * pw,
                    w_eff * sizeof(uint16_t));
      }
    }
  });
  return err.load();
}

// Encode rows (height*width*n_comp uint16, interleaved) as lossless JPEG SOF3 with
// predictor 1 and a single shared Huffman table. Returns encoded size, or negative.
int64_t dng_ljpeg_encode(const uint16_t* img, int32_t height, int32_t width,
                         int32_t n_comp, int32_t precision, uint8_t* out,
                         int64_t out_capacity) {
  if (n_comp < 1 || n_comp > 4 || precision < 2 || precision > 16) return -1;

  // Histogram of ssss categories to build the table? Keep it simple: fixed table
  // with all categories 0..16 present (lengths chosen ascending).
  // counts per code length: lengths 2..6 carry most categories.
  // A simple valid canonical table: category i gets length ~ i+2 clipped.
  uint8_t bits[17] = {0};
  uint8_t huffval[17];
  // categories 0..16 -> 17 values; assign lengths: 0..1 ->2, rest increasing
  int lens[17];
  lens[0] = 2; lens[1] = 2; lens[2] = 2;
  for (int i = 3; i <= 16; ++i) lens[i] = std::min(16, i);
  // canonical requires counts per length with kraft <= 1; compute
  for (int i = 0; i <= 16; ++i) bits[lens[i]]++;
  // order values by length (stable by category)
  int k = 0;
  for (int len = 1; len <= 16; ++len)
    for (int i = 0; i <= 16; ++i)
      if (lens[i] == len) huffval[k++] = static_cast<uint8_t>(i);

  // derive canonical codes
  uint16_t code_of[17];
  int len_of[17];
  {
    int code = 0, idx = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len]; ++i) {
        code_of[huffval[idx]] = static_cast<uint16_t>(code);
        len_of[huffval[idx]] = len;
        code++;
        idx++;
      }
      code <<= 1;
    }
  }

  // --- write headers ---
  int64_t p = 0;
  auto put = [&](uint8_t b) {
    if (p < out_capacity) out[p] = b;
    p++;
  };
  auto put16 = [&](int v) {
    put(static_cast<uint8_t>(v >> 8));
    put(static_cast<uint8_t>(v & 0xFF));
  };

  put(0xFF); put(0xD8);  // SOI
  // DHT
  {
    int total = 17;
    put(0xFF); put(0xC4);
    put16(2 + 1 + 16 + total);
    put(0x00);  // class 0, id 0
    for (int len = 1; len <= 16; ++len) put(bits[len]);
    for (int i = 0; i < total; ++i) put(huffval[i]);
  }
  // SOF3
  {
    put(0xFF); put(0xC3);
    put16(8 + 3 * n_comp);
    put(static_cast<uint8_t>(precision));
    put16(height);
    put16(width);
    put(static_cast<uint8_t>(n_comp));
    for (int c = 0; c < n_comp; ++c) {
      put(static_cast<uint8_t>(c));
      put(0x11);
      put(0x00);
    }
  }
  // SOS
  {
    put(0xFF); put(0xDA);
    put16(6 + 2 * n_comp);
    put(static_cast<uint8_t>(n_comp));
    for (int c = 0; c < n_comp; ++c) {
      put(static_cast<uint8_t>(c));
      put(0x00);
    }
    put(0x01);  // predictor 1
    put(0x00);
    put(0x00);  // point transform 0
  }

  // --- entropy-coded data ---
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  auto flush_byte = [&](uint8_t b) {
    put(b);
    if (b == 0xFF) put(0x00);  // stuffing
  };
  auto put_bits = [&](uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      bitbuf = (bitbuf << 1) | ((v >> i) & 1);
      bitcnt++;
      if (bitcnt == 8) {
        flush_byte(static_cast<uint8_t>(bitbuf & 0xFF));
        bitbuf = 0;
        bitcnt = 0;
      }
    }
  };

  int default_val = 1 << (precision - 1);
  std::vector<int32_t> prev_row(static_cast<size_t>(width) * n_comp);
  std::vector<int32_t> cur_row(static_cast<size_t>(width) * n_comp);

  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      for (int c = 0; c < n_comp; ++c) {
        int32_t v = img[(static_cast<int64_t>(y) * width + x) * n_comp + c];
        cur_row[x * n_comp + c] = v;
        int32_t pred;
        if (y == 0 && x == 0) pred = default_val;
        else if (y == 0) pred = cur_row[(x - 1) * n_comp + c];
        else if (x == 0) pred = prev_row[x * n_comp + c];
        else pred = cur_row[(x - 1) * n_comp + c];  // predictor 1

        int32_t diff = v - pred;
        // wrap to 16-bit modulo domain
        diff = static_cast<int16_t>(diff & 0xFFFF);
        int ssss = 0;
        int32_t a = diff < 0 ? -diff : diff;
        while (a > 0) {
          ssss++;
          a >>= 1;
        }
        put_bits(code_of[ssss], len_of[ssss]);
        if (ssss > 0 && ssss < 16) {
          int32_t val = diff;
          if (diff < 0) val = diff + (1 << ssss) - 1;
          put_bits(static_cast<uint32_t>(val) & ((1u << ssss) - 1), ssss);
        }
      }
    }
    std::swap(prev_row, cur_row);
  }
  if (bitcnt > 0) {
    bitbuf <<= (8 - bitcnt);
    bitbuf |= (1 << (8 - bitcnt)) - 1;  // pad with 1s
    flush_byte(static_cast<uint8_t>(bitbuf & 0xFF));
  }
  put(0xFF); put(0xD9);  // EOI

  return (p <= out_capacity) ? p : -2;
}


// ---------------------------------------------------------------------------------
// Nikon NEF compressed CFA (TIFF compression 34713)
//
// Per-pixel Huffman-coded prediction residuals: the first two columns of each
// row update running vertical predictors (two-row phase), later columns predict
// horizontally per column parity; decoded values map through the camera's
// linearization curve. The six canonical tree specs (JPEG-style length
// histogram + value bytes whose high nibble is an extra shift) are the
// long-public constants every open raw decoder ships; which tree applies is
// keyed by the metadata blob's version bytes and bit depth (io/nef.py).

namespace {

const uint8_t kNefTree[6][32] = {
    // 12-bit lossy
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12},
    // 12-bit lossy after split
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     0x39, 0x5a, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0, 11, 12, 12},
    // 12-bit lossless
    {0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12},
    // 14-bit lossy
    {0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13},
    // 14-bit lossy after split
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0,
     8, 0x5c, 0x4b, 0x3a, 0x29, 7, 6, 5, 4, 3, 2, 1, 0, 13, 14},
    // 14-bit lossless
    {0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0,
     7, 6, 5, 8, 4, 9, 3, 10, 2, 11, 12, 0, 1, 13, 14},
};

struct NefHuff {
  uint16_t min_code[17];
  uint16_t max_code[17];
  int16_t val_index[17];
  uint8_t values[32];
};

void nef_build_huff(const uint8_t* spec, NefHuff* ht) {
  int code = 0, idx = 0;
  for (int len = 1; len <= 16; ++len) {
    int n = spec[len - 1];
    if (n == 0) {
      ht->val_index[len] = -1;
      ht->min_code[len] = 1;
      ht->max_code[len] = 0;
    } else {
      ht->min_code[len] = static_cast<uint16_t>(code);
      ht->max_code[len] = static_cast<uint16_t>(code + n - 1);
      ht->val_index[len] = static_cast<int16_t>(idx);
      for (int i = 0; i < n; ++i) ht->values[idx + i] = spec[16 + idx + i];
      idx += n;
      code += n;
    }
    code <<= 1;
  }
}

// (the per-bit canonical-range walk this replaced lives in git history;
// decode_lut + build_lut above are the production path)

}  // namespace

// Decode a NEF compressed CFA strip. vpred_in: 4 u16 seeds (row-phase 0: cols
// 0/1, row-phase 1: cols 0/1). split_row > 0 switches to tree_idx+1 at that
// row (lossy-type-2 files). curve: linearization LUT (values clamped to
// curve_len-1). Returns 0 on success.
int nef_decode(const uint8_t* data, int64_t size, uint16_t* out,
               int32_t height, int32_t width, int32_t tree_idx,
               const uint16_t* vpred_in, int32_t split_row,
               const uint16_t* curve, int32_t curve_len) {
  if (tree_idx < 0 || tree_idx > 5 || curve_len < 1) return -1;
  if (split_row > 0 && tree_idx + 1 > 5) return -1;
  NefHuff ht;
  nef_build_huff(kNefTree[tree_idx], &ht);
  HuffLut lut;
  build_lut(ht, &lut);
  BitReader br{data, size};
  br.stuffed = false;
  int vpred[2][2] = {
      {vpred_in[0], vpred_in[1]}, {vpred_in[2], vpred_in[3]}};
  int hpred[2] = {0, 0};
  for (int32_t row = 0; row < height; ++row) {
    if (split_row > 0 && row == split_row) {
      nef_build_huff(kNefTree[tree_idx + 1], &ht);
      build_lut(ht, &lut);
    }
    for (int32_t col = 0; col < width; ++col) {
      int i = decode_lut(br, lut);
      if (i < 0) return -2;
      int len = i & 15;
      int shl = i >> 4;
      int diff = 0;
      if (len > 0) {
        int bitsv = br.get_bits(len - shl);
        if (br.bad) return -3;
        diff = (((bitsv << 1) + 1) << shl) >> 1;
        if ((diff & (1 << (len - 1))) == 0) diff -= (1 << len) - (shl ? 0 : 1);
      }
      if (col < 2) {
        vpred[row & 1][col] += diff;
        hpred[col] = vpred[row & 1][col];
      } else {
        hpred[col & 1] += diff;
      }
      int v = hpred[col & 1];
      if (v < 0) v = 0;
      if (v > 0x3fff) v = 0x3fff;
      if (v >= curve_len) v = curve_len - 1;
      out[static_cast<int64_t>(row) * width + col] = curve[v];
    }
  }
  return 0;
}

// Encode a mosaic as a NEF compressed strip (test fixtures; lossless trees
// only — every value byte must have a zero shift nibble). Inverse of
// nef_decode with an identity curve. Returns encoded size or negative.
int64_t nef_encode(const uint16_t* img, int32_t height, int32_t width,
                   int32_t tree_idx, const uint16_t* vpred_in, uint8_t* out,
                   int64_t out_capacity) {
  if (tree_idx != 0 && tree_idx != 2 && tree_idx != 3 && tree_idx != 5)
    return -1;  // trees whose leaves carry no shift nibble
  const uint8_t* spec = kNefTree[tree_idx];
  uint16_t code_of[17];
  int len_of[17];
  for (int i = 0; i <= 16; ++i) len_of[i] = 0;
  {
    int code = 0, idx = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < spec[len - 1]; ++i) {
        uint8_t v = spec[16 + idx];
        if (v >> 4) return -2;  // shifted leaf: not invertible losslessly here
        code_of[v] = static_cast<uint16_t>(code);
        len_of[v] = len;
        code++;
        idx++;
      }
      code <<= 1;
    }
  }

  int64_t p = 0;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  auto put_bits = [&](uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      bitbuf = (bitbuf << 1) | ((v >> i) & 1);
      if (++bitcnt == 8) {
        if (p < out_capacity) out[p] = static_cast<uint8_t>(bitbuf & 0xFF);
        p++;
        bitbuf = 0;
        bitcnt = 0;
      }
    }
  };

  int vpred[2][2] = {
      {vpred_in[0], vpred_in[1]}, {vpred_in[2], vpred_in[3]}};
  int hpred[2] = {0, 0};
  for (int32_t row = 0; row < height; ++row) {
    for (int32_t col = 0; col < width; ++col) {
      int v = img[static_cast<int64_t>(row) * width + col] & 0x3fff;
      int diff;
      if (col < 2) {
        diff = v - vpred[row & 1][col];
        vpred[row & 1][col] = v;
        hpred[col] = v;
      } else {
        diff = v - hpred[col & 1];
        hpred[col & 1] = v;
      }
      int s = 0;
      for (int a = diff < 0 ? -diff : diff; a > 0; a >>= 1) s++;
      if (s > 16 || len_of[s] == 0) return -3;
      put_bits(code_of[s], len_of[s]);
      if (s > 0) {
        int val = diff < 0 ? diff + (1 << s) - 1 : diff;
        put_bits(static_cast<uint32_t>(val) & ((1u << s) - 1), s);
      }
    }
  }
  if (bitcnt > 0) {
    bitbuf <<= (8 - bitcnt);
    if (p < out_capacity) out[p] = static_cast<uint8_t>(bitbuf & 0xFF);
    p++;
  }
  return (p <= out_capacity) ? p : -4;
}

// u16 mosaic -> f32 normalized mosaic: clip(x - black[phase], 0, sat[phase]) / sat.
// Phases in RGGB order (R, G1, B, G2) matching normalization.py:19-23.
void dng_normalize_mosaic(const uint16_t* in, float* out, int64_t height,
                          int64_t width, const float* black4,
                          const float* sat4) {
  parallel_rows(height, [&](int64_t lo, int64_t hi) {
    for (int64_t y = lo; y < hi; ++y) {
      int row_phase = (y & 1) << 1;
      const uint16_t* src = in + y * width;
      float* dst = out + y * width;
      for (int64_t x = 0; x < width; ++x) {
        int phase_idx = row_phase | (x & 1);
        // map (row,col) phase to RGGB plane index: (0,0)->0 R, (0,1)->1 G1,
        // (1,0)->3 G2, (1,1)->2 B
        static const int lut[4] = {0, 1, 3, 2};
        int p = lut[phase_idx];
        float v = static_cast<float>(src[x]) - black4[p];
        if (v < 0) v = 0;
        if (v > sat4[p]) v = sat4[p];
        dst[x] = v / sat4[p];
      }
    }
  });
}

// big-endian u16 strip -> native u16 (multithreaded)
void dng_swap16(const uint8_t* in, uint16_t* out, int64_t count) {
  parallel_rows(count, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out[i] = static_cast<uint16_t>((in[2 * i] << 8) | in[2 * i + 1]);
    }
  });
}

// ---------------------------------------------------------------------------
// Panasonic RW2 v4 codec (io/rw2.py fast path; the Python module documents the
// bitstream: 0x4000-byte sections rotated at 0x2008, down-counting 17-bit
// cursor, 14-pixel packets of two interleaved CFA channels).

namespace {

constexpr int kRw2Section = 0x4000;
constexpr int kRw2Split = 0x2008;

struct Rw2Bits {
  const uint8_t* data;
  int64_t len;
  int64_t sec = 0;
  int vbits = 0;
  uint8_t buf[kRw2Section + 1] = {};

  int get(int n) {
    if (!vbits) {
      for (int i = 0; i < kRw2Section; ++i) {
        int64_t src = sec * kRw2Section + ((i - kRw2Split) & (kRw2Section - 1));
        buf[i] = (src < len) ? data[src] : 0;
      }
      buf[kRw2Section] = 0;
      ++sec;
    }
    vbits = (vbits - n) & 0x1FFFF;
    int byte = vbits >> 3 ^ 0x3FF0;  // dcraw pana_bits byte addressing
    int word = buf[byte] | (buf[byte + 1] << 8);
    return (word >> (vbits & 7)) & ((1 << n) - 1);
  }
};

struct Rw2BitWriter {
  std::vector<uint8_t> bufs;  // concatenated sections, reader layout
  int vbits = 0;

  void put(int n, int value) {
    if (!vbits) bufs.resize(bufs.size() + kRw2Section, 0);
    vbits = (vbits - n) & 0x1FFFF;
    uint8_t* buf = bufs.data() + (bufs.size() - kRw2Section);
    int byte = vbits >> 3 ^ 0x3FF0;  // mirror the reader's byte addressing
    int word = value << (vbits & 7);
    buf[byte] |= word & 0xFF;
    if (byte + 1 < kRw2Section) buf[byte + 1] |= (word >> 8) & 0xFF;
  }
};

// decoder's predictor update for a nonzero delta code (keep identical to
// io/rw2.py::_delta_step / _best_delta)
inline int rw2_delta_base(int pred, int sh) {
  int p = pred - (0x80 << sh);
  if (p < 0 || sh == 4) p = pred & ((1 << sh) - 1);
  return p;
}

inline void rw2_best_delta(int pred, int sh, int target, int* code, int* ach) {
  int base = rw2_delta_base(pred, sh);
  // round-half-even to match Python round()
  double q = static_cast<double>(target - base) / (1 << sh);
  int j8 = static_cast<int>(std::nearbyint(q));
  if (j8 < 1) j8 = 1;
  if (j8 > 255) j8 = 255;
  int cand = base + (j8 << sh);
  if (std::abs(pred - target) <= std::abs(cand - target)) {
    *code = 0;
    *ach = pred;
  } else {
    *code = j8;
    *ach = cand;
  }
}

}  // namespace

int rw2_decode(const uint8_t* data, int64_t len, uint16_t* out, int32_t h,
               int32_t w) {
  Rw2Bits bits{data, len};
  int pred[2] = {0, 0}, nonz[2] = {0, 0}, sh = 0;
  for (int32_t row = 0; row < h; ++row) {
    for (int32_t col = 0; col < w; ++col) {
      int i = col % 14;
      if (i == 0) pred[0] = pred[1] = nonz[0] = nonz[1] = 0;
      if (i % 3 == 2) sh = 4 >> (3 - bits.get(2));
      int j = i & 1;
      if (nonz[j]) {
        int d = bits.get(8);
        if (d) {
          pred[j] -= 0x80 << sh;
          if (pred[j] < 0 || sh == 4) pred[j] &= (1 << sh) - 1;
          pred[j] += d << sh;
        }
      } else {
        nonz[j] = bits.get(8);
        if (nonz[j] || i > 11) pred[j] = (nonz[j] << 4) | bits.get(4);
      }
      out[static_cast<int64_t>(row) * w + col] =
          static_cast<uint16_t>(pred[col & 1]);
    }
  }
  return 0;
}

// Fixed-rate greedy encoder, bit-identical to io/rw2.py::pana_v4_encode.
// `achieved` (optional) receives the decoder-exact values. Returns the
// payload size, or -1 on bad args / -2 if out_capacity is too small.
int64_t rw2_encode(const uint16_t* values, int32_t h, int32_t w, uint8_t* out,
                   int64_t out_capacity, uint16_t* achieved) {
  if (w % 14) return -1;
  Rw2BitWriter wr;
  for (int32_t row = 0; row < h; ++row) {
    for (int32_t g0 = 0; g0 < w; g0 += 14) {
      const uint16_t* v = values + static_cast<int64_t>(row) * w + g0;
      uint16_t* a =
          achieved ? achieved + static_cast<int64_t>(row) * w + g0 : nullptr;
      int pred[2] = {0, 0};
      int sh = 0;
      for (int i = 0; i < 2; ++i) {
        int t = v[i];
        if (t < 16) t = 16;
        if (t > 0xFFF) t = 0xFFF;
        wr.put(8, t >> 4);
        wr.put(4, t & 0xF);
        pred[i] = t;
        if (a) a[i] = static_cast<uint16_t>(t);
      }
      for (int i = 2; i < 14; ++i) {
        if (i % 3 == 2) {
          static const int kSh[4] = {0, 1, 2, 4};
          int best_err = -1, best_code = 0;
          int upto = (i + 3 < 14) ? i + 3 : 14;
          for (int code = 0; code < 4; ++code) {
            int p[2] = {pred[0], pred[1]};
            int err = 0;
            for (int k = i; k < upto; ++k) {
              int c, ach;
              rw2_best_delta(p[k & 1], kSh[code], v[k], &c, &ach);
              err += std::abs(ach - v[k]);
              p[k & 1] = ach;
            }
            if (best_err < 0 || err < best_err) {
              best_err = err;
              best_code = code;
            }
          }
          sh = kSh[best_code];
          wr.put(2, best_code);
        }
        int c, ach;
        rw2_best_delta(pred[i & 1], sh, v[i], &c, &ach);
        wr.put(8, c);
        pred[i & 1] = ach;
        if (a) a[i] = static_cast<uint16_t>(ach);
      }
    }
  }
  int64_t total = static_cast<int64_t>(wr.bufs.size());
  if (total > out_capacity) return -2;
  // rotate each section back to file order: file[j] = buf[(j + split) % sec]
  for (int64_t s = 0; s < total; s += kRw2Section) {
    const uint8_t* buf = wr.bufs.data() + s;
    uint8_t* dst = out + s;
    for (int j = 0; j < kRw2Section; ++j)
      dst[j] = buf[(j + kRw2Split) & (kRw2Section - 1)];
  }
  return total;
}

// ---------------------------------------------------------------------------
// Olympus ORF codec (io/orf.py fast path; the Python module documents the
// format: MSB-first stream after a 7-byte skip, 3-bit sign+low field, unary
// magnitude class with a 12-zeros escape, per-parity carry chains, W/N/NW
// gradient predictor over distance-2 neighbors).

namespace {

struct OrfBits {
  BitReader br;

  OrfBits(const uint8_t* data, int64_t len) : br{data, len} {
    br.stuffed = false;  // plain MSB-first stream, zero-fill past end
  }

  int get(int n) { return br.get_bits(n); }

  int zeros_then_one() {
    // unary magnitude class, capped at 12 zeros: one peek + clz instead of
    // up to 12 single-bit reads
    br.refill();
    uint32_t v = br.peek(12);
    if (v == 0) {
      br.consume(12);
      return 12;
    }
    int k = __builtin_clz(v) - 20;  // leading zeros within the 12-bit window
    br.consume(k + 1);
    return k;
  }
};

struct OrfBitWriter {
  std::vector<uint8_t> bytes;
  int64_t pos = 0;

  void put(int n, int value) {
    for (int i = n - 1; i >= 0; --i) {
      if ((pos >> 3) >= static_cast<int64_t>(bytes.size())) bytes.push_back(0);
      if ((value >> i) & 1) bytes[pos >> 3] |= 0x80 >> (pos & 7);
      ++pos;
    }
  }
};

inline int orf_pred(const uint16_t* raw, int64_t w, int row, int col) {
  if (row < 2 && col < 2) return 0;
  if (row < 2) return raw[static_cast<int64_t>(row) * w + col - 2];
  if (col < 2) return raw[static_cast<int64_t>(row - 2) * w + col];
  int wv = raw[static_cast<int64_t>(row) * w + col - 2];
  int n = raw[static_cast<int64_t>(row - 2) * w + col];
  int nw = raw[static_cast<int64_t>(row - 2) * w + col - 2];
  if ((wv < nw && nw < n) || (n < nw && nw < wv)) {
    if (std::abs(wv - nw) > 32 || std::abs(n - nw) > 32) return wv + n - nw;
    return (wv + n) >> 1;
  }
  return std::abs(wv - nw) > std::abs(n - nw) ? wv : n;
}

inline int orf_nbits(const int* carry) {
  int i = 2 * (carry[2] < 3);
  int nbits = 2 + i;
  while (((carry[0] & 0xFFFF) >> (nbits + i)) && nbits < 16) ++nbits;
  return nbits;
}

}  // namespace

int orf_decode(const uint8_t* data, int64_t len, uint16_t* out, int32_t h,
               int32_t w) {
  if (len < 7) return -1;
  OrfBits bits{data + 7, len - 7};
  for (int32_t row = 0; row < h; ++row) {
    int acarry[2][3] = {{0, 0, 0}, {0, 0, 0}};
    for (int32_t col = 0; col < w; ++col) {
      int* carry = acarry[col & 1];
      int nbits = orf_nbits(carry);
      int field = bits.get(3);
      int low = field & 3;
      int sign = (field & 4) ? -1 : 0;
      int high = bits.zeros_then_one();
      if (high == 12) high = bits.get(16 - nbits) >> 1;
      carry[0] = (high << nbits) | bits.get(nbits);
      int diff = (carry[0] ^ sign) + carry[1];
      carry[1] = (diff * 3 + carry[1]) >> 5;
      carry[2] = carry[0] > 16 ? 0 : carry[2] + 1;
      int pred = orf_pred(out, w, row, col);
      out[static_cast<int64_t>(row) * w + col] =
          static_cast<uint16_t>(pred + ((diff << 2) | low));
    }
  }
  return 0;
}

// Lossless encoder, bit-identical to io/orf.py::olympus_encode. Returns the
// payload size (including the 7 leading zero bytes), -1 on oversized
// residuals, -2 if out_capacity is too small.
int64_t orf_encode(const uint16_t* values, int32_t h, int32_t w, uint8_t* out,
                   int64_t out_capacity) {
  OrfBitWriter wr;
  std::vector<uint16_t> raw(static_cast<int64_t>(h) * w, 0);
  for (int32_t row = 0; row < h; ++row) {
    int acarry[2][3] = {{0, 0, 0}, {0, 0, 0}};
    for (int32_t col = 0; col < w; ++col) {
      int* carry = acarry[col & 1];
      int nbits = orf_nbits(carry);
      int pred = orf_pred(raw.data(), w, row, col);
      int r = static_cast<int>(values[static_cast<int64_t>(row) * w + col]) - pred;
      int low = r & 3;
      int diff = r >> 2;
      int d = diff - carry[1];
      int sign, c0;
      if (d >= 0) {
        sign = 0;
        c0 = d;
      } else {
        sign = -1;
        c0 = -d - 1;
      }
      if (c0 >= (1 << 15)) return -1;
      wr.put(3, (sign ? 4 : 0) | low);
      int high = c0 >> nbits;
      if (high < 12) {
        wr.put(high + 1, 1);
      } else {
        wr.put(12, 0);
        wr.put(16 - nbits, high << 1);
      }
      wr.put(nbits, c0 & ((1 << nbits) - 1));
      carry[0] = c0;
      int dd = (c0 ^ sign) + carry[1];
      carry[1] = (dd * 3 + carry[1]) >> 5;
      carry[2] = c0 > 16 ? 0 : carry[2] + 1;
      raw[static_cast<int64_t>(row) * w + col] =
          static_cast<uint16_t>(pred + ((dd << 2) | low));
    }
  }
  int64_t total = 7 + static_cast<int64_t>(wr.bytes.size());
  if (total > out_capacity) return -2;
  std::memset(out, 0, 7);
  std::memcpy(out + 7, wr.bytes.data(), wr.bytes.size());
  return total;
}

// --- Pentax PEF (pentax_load_raw semantics; twin of io/pef.py::pef_decode) ---
// Plain MSB-first bitstream; the Huffman code is given as per-symbol 12-bit
// left-aligned prefixes + code lengths (MakerNote tag 0x0220). Decode peeks
// 12 bits through a 4096-entry LUT. Residuals are JPEG-lossless style; the
// predictor uses two per-row-parity vertical seeds then horizontal DPCM per
// column parity. Out-of-range predictions clamp (divergence from dcraw's
// abort; see io/pef.py header). Returns 0 on success.
int pef_decode(const uint8_t* data, int64_t len, uint16_t* out, int32_t h,
               int32_t w, const uint16_t* prefixes, const uint8_t* lengths,
               int32_t dep, int32_t bits) {
  if (dep < 1 || dep > 15 || bits < 8 || bits > 16) return -1;
  uint16_t lut[4096];
  std::memset(lut, 0, sizeof(lut));
  for (int c = 0; c < dep; ++c) {
    int ln = lengths[c];
    if (ln < 1 || ln > 12) return -1;
    int n = 4096 >> ln;
    int p = prefixes[c];
    if (p + n > 4096) return -1;
    for (int i = 0; i < n; ++i) lut[p + i] = static_cast<uint16_t>((ln << 8) | c);
  }
  BitReader br{data, len};
  br.stuffed = false;  // plain MSB-first stream; zero-fill past end (clamp
                       // semantics — `bad` deliberately unchecked, io/pef.py)
  auto peek12 = [&]() -> int {
    br.refill();
    return static_cast<int>(br.peek(12));
  };
  auto getn = [&](int n) -> int {
    if (n == 0) return 0;
    br.refill();
    int v = static_cast<int>(br.peek(n));
    br.consume(n);
    return v;
  };
  int vpred[2][2] = {{0, 0}, {0, 0}};
  int hpred[2] = {0, 0};
  const int lim = (1 << bits) - 1;
  for (int32_t row = 0; row < h; ++row) {
    for (int32_t col = 0; col < w; ++col) {
      uint16_t e = lut[peek12()];
      int ln = e >> 8;
      if (ln == 0) return -2;
      br.consume(ln);
      int sym = e & 0xFF;
      int diff = 0;
      if (sym) {
        int v = getn(sym);
        diff = v >= (1 << (sym - 1)) ? v : v - (1 << sym) + 1;
      }
      if (col < 2) {
        vpred[row & 1][col] += diff;
        hpred[col] = vpred[row & 1][col];
      } else {
        hpred[col & 1] += diff;
      }
      int v = hpred[col & 1];
      out[static_cast<int64_t>(row) * w + col] =
          static_cast<uint16_t>(v < 0 ? 0 : (v > lim ? lim : v));
    }
  }
  return 0;
}

// --- Sony ARW2 (sony_arw2_load_raw semantics; twin of io/arw.py::arw2_decode) ---
// One 16-byte block -> 16 photosites of one column parity in a 32-column
// span; header word packs max/min values + their positions; 15 7-bit deltas
// at bit offsets 30+7j, the 15th crossing into the next block's first two
// bytes (zeros at the end of a row — io/arw.py documents the dcraw UB this
// replaces). Returns 0 on success.
int arw2_decode(const uint8_t* data, int64_t len, uint16_t* out, int32_t h,
                int32_t w) {
  if (w % 32) return -1;
  if (len < static_cast<int64_t>(h) * w) return -2;
  const int nb = w / 16;
  for (int32_t row = 0; row < h; ++row) {
    const uint8_t* rp = data + static_cast<int64_t>(row) * w;
    uint16_t* op = out + static_cast<int64_t>(row) * w;
    for (int b = 0; b < nb; ++b) {
      const uint8_t* dp = rp + b * 16;
      uint32_t w0 = static_cast<uint32_t>(dp[0]) | (dp[1] << 8) |
                    (dp[2] << 16) | (static_cast<uint32_t>(dp[3]) << 24);
      int mx = w0 & 0x7FF;
      int mn = (w0 >> 11) & 0x7FF;
      int imax = (w0 >> 22) & 0xF;
      int imin = (w0 >> 26) & 0xF;
      int diff = mx - mn;
      int sh = (diff >= 0x80) + (diff >= 0x100) + (diff >= 0x200) +
               (diff >= 0x400);
      uint8_t ext[18];
      std::memcpy(ext, dp, 16);
      if (b + 1 < nb) {
        ext[16] = dp[16];
        ext[17] = dp[17];
      } else {
        ext[16] = ext[17] = 0;
      }
      const int base = 32 * (b >> 1) + (b & 1);
      for (int i = 0; i < 16; ++i) {
        int v;
        if (i == imax) {
          v = mx;
        } else if (i == imin && imax != imin) {
          v = mn;
        } else {
          int rank = i - (imax < i) - ((imin < i) && (imax != imin));
          if (rank < 0) rank = 0;
          if (rank > 14) rank = 14;
          int start = 30 + 7 * rank;
          int delta =
              ((ext[start >> 3] | (ext[(start >> 3) + 1] << 8)) >> (start & 7)) &
              0x7F;
          v = mn + (delta << sh);
          if (v > 0x7FF) v = 0x7FF;
        }
        op[base + 2 * i] = static_cast<uint16_t>(v);
      }
    }
  }
  return 0;
}

// --- Samsung SRW (samsung_load_raw semantics; twin of io/srw.py::srw_decode) ---
// ph1-style bitstream: little-endian u32 words consumed MSB-first. 16-pixel
// blocks: 1 dir bit, four 2-bit opcodes adjusting four group bit-lengths
// (opcode 3 + 4-bit replacement, in group order), then 16 sign-extended
// residuals (even columns first, then odd). Lengths start at 7 for rows 0-1,
// 4 after. Output is the STORED array (caller applies the TR/BL swap).
// Divergences match io/srw.py: dir=1 on rows 0-1 predicts 128; values clamp.
int srw_decode(const uint8_t* data, int64_t len, const uint32_t* row_offsets,
               int64_t data_offset, uint16_t* out, int32_t h, int32_t w,
               int32_t bits) {
  if (w % 16 || bits < 8 || bits > 16) return -1;
  const int lim = (1 << bits) - 1;
  for (int32_t row = 0; row < h; ++row) {
    uint64_t bitbuf = 0;
    int vbits = 0;
    int64_t pos = data_offset + static_cast<int64_t>(row_offsets[row]);
    auto get = [&](int n) -> int {
      if (n == 0) return 0;
      while (vbits < n) {
        uint32_t word = 0;
        for (int k = 0; k < 4; ++k) {
          uint32_t byte = (pos + k) < len ? data[pos + k] : 0;
          word |= byte << (8 * k);  // little-endian u32
        }
        pos += 4;
        bitbuf = (bitbuf << 32) | word;
        vbits += 32;
      }
      int v = static_cast<int>((bitbuf >> (vbits - n)) & ((1u << n) - 1));
      vbits -= n;
      return v;
    };
    int lens[4] = {row < 2 ? 7 : 4, row < 2 ? 7 : 4, row < 2 ? 7 : 4,
                   row < 2 ? 7 : 4};
    for (int32_t col = 0; col < w; col += 16) {
      int dir = get(1);
      int ops[4];
      for (int g = 0; g < 4; ++g) ops[g] = get(2);
      for (int g = 0; g < 4; ++g) {
        switch (ops[g]) {
          case 3: lens[g] = get(4); break;
          case 2: lens[g]--; break;
          case 1: lens[g]++; break;
        }
        if (lens[g] < 0 || lens[g] > 16) return -2;
      }
      for (int c = 0; c < 16; c += 2) {
        int i = lens[((c & 1) << 1) | (c >> 3)];
        int v = get(i);
        int diff = (i && (v >> (i - 1)) & 1) ? v - (1 << i) : v;
        int64_t idx = static_cast<int64_t>(row) * w + col + c;
        int pred;
        if (dir) {
          pred = row >= 2 ? out[idx - 2 * static_cast<int64_t>(w)] : 128;
        } else {
          pred = col ? out[idx - 2] : 128;
        }
        int val = pred + diff;
        out[idx] = static_cast<uint16_t>(val < 0 ? 0 : (val > lim ? lim : val));
        if (c == 14) c = -1;  // evens done -> restart at the odd columns
      }
    }
  }
  return 0;
}

// --- fast PNG writer (stored-deflate blocks) --------------------------------
// The streamed develop's true host bottleneck is PIL's zlib PNG encode
// (seconds at 24 MP on the host). A PNG whose IDAT is a
// zlib stream of STORED deflate blocks needs no compression at all: just the
// filtered scanlines (filter byte 0), block headers, adler32 and per-chunk
// CRC32 — a single memcpy-speed pass (~20-40x faster, ~12% larger files).

static uint32_t png_crc_table[256];
static bool png_crc_ready = false;

static void png_crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    png_crc_table[i] = c;
  }
  png_crc_ready = true;
}

static uint32_t png_crc32(uint32_t crc, const uint8_t* p, int64_t n) {
  crc ^= 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; i++)
    crc = png_crc_table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

static void png_be32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v >> 24);
  p[1] = static_cast<uint8_t>(v >> 16);
  p[2] = static_cast<uint8_t>(v >> 8);
  p[3] = static_cast<uint8_t>(v);
}

// Required output capacity for png_encode_fast (host computes via this).
// sample_bytes: 1 for 8-bit, 2 for 16-bit samples.
int64_t png_encode_fast_bound(int32_t height, int32_t width, int32_t channels,
                              int32_t sample_bytes) {
  int64_t filtered =
      static_cast<int64_t>(height) *
      (1 + static_cast<int64_t>(width) * channels * sample_bytes);
  int64_t nblocks = (filtered + 65534) / 65535;
  return 8 + 25 + (12 + 2 + nblocks * 5 + filtered + 4) + 12 + 64;
}

// Encode interleaved pixels (channels = 3 RGB or 1 gray; sample_bytes = 1 for
// 8-bit, 2 for 16-bit with the samples ALREADY big-endian — PNG byte order)
// to a valid PNG. Returns bytes written, or negative on bad args / capacity.
int64_t png_encode_fast(const uint8_t* pixels, int32_t height, int32_t width,
                        int32_t channels, int32_t sample_bytes, uint8_t* out,
                        int64_t capacity) {
  if (height <= 0 || width <= 0 || (channels != 1 && channels != 3)) return -1;
  if (sample_bytes != 1 && sample_bytes != 2) return -1;
  if (capacity < png_encode_fast_bound(height, width, channels, sample_bytes))
    return -2;
  if (!png_crc_ready) png_crc_init();

  const int64_t row_bytes =
      static_cast<int64_t>(width) * channels * sample_bytes;
  const int64_t filtered = static_cast<int64_t>(height) * (1 + row_bytes);
  const int64_t nblocks = (filtered + 65534) / 65535;
  uint8_t* p = out;

  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  for (int i = 0; i < 8; i++) *p++ = sig[i];

  // IHDR
  png_be32(p, 13);
  p += 4;
  uint8_t* ihdr = p;
  p[0] = 'I'; p[1] = 'H'; p[2] = 'D'; p[3] = 'R';
  png_be32(p + 4, static_cast<uint32_t>(width));
  png_be32(p + 8, static_cast<uint32_t>(height));
  p[12] = static_cast<uint8_t>(8 * sample_bytes);  // bit depth
  p[13] = channels == 3 ? 2 : 0;                   // color type
  p[14] = 0; p[15] = 0; p[16] = 0;      // compression / filter / interlace
  p += 17;
  png_be32(p, png_crc32(0, ihdr, 17));
  p += 4;

  // IDAT: zlib header + stored blocks over the filtered scanline stream.
  // The stream is produced block-by-block straight into the output buffer
  // (no 72 MB intermediate): a virtual cursor walks rows + filter bytes.
  const int64_t idat_len = 2 + nblocks * 5 + filtered + 4;
  png_be32(p, static_cast<uint32_t>(idat_len));
  p += 4;
  uint8_t* idat_tag = p;
  p[0] = 'I'; p[1] = 'D'; p[2] = 'A'; p[3] = 'T';
  p += 4;
  *p++ = 0x78;  // zlib CMF
  *p++ = 0x01;  // FLG (no dict, fastest hint; (0x7801 % 31) == 0)

  uint32_t ad_a = 1, ad_b = 0;  // adler32 accumulators (mod 65521, deferred)
  int64_t ad_defer = 0;
  int64_t row = 0, col = -1;  // col -1 = the row's filter byte
  int64_t remaining = filtered;
  const uint8_t* src_row = pixels;
  while (remaining > 0) {
    int64_t blk = remaining < 65535 ? remaining : 65535;
    remaining -= blk;
    *p++ = remaining == 0 ? 1 : 0;  // BFINAL
    *p++ = static_cast<uint8_t>(blk & 0xFF);
    *p++ = static_cast<uint8_t>(blk >> 8);
    *p++ = static_cast<uint8_t>(~blk & 0xFF);
    *p++ = static_cast<uint8_t>((~blk >> 8) & 0xFF);
    // contiguous spans (whole row slices between filter bytes): memcpy +
    // blocked adler instead of a per-byte loop (~0.8 s -> memory-bound)
    int64_t left = blk;
    while (left > 0) {
      if (col < 0) {
        *p++ = 0;  // filter type: None
        ad_b += ad_a;  // v == 0: a unchanged, b += a
        if (++ad_defer >= 5552) {
          ad_a %= 65521;
          ad_b %= 65521;
          ad_defer = 0;
        }
        col = 0;
        left--;
        continue;
      }
      int64_t span = row_bytes - col;
      if (span > left) span = left;
      std::memcpy(p, src_row + col, static_cast<size_t>(span));
      const uint8_t* q = p;
      int64_t s = span;
      while (s > 0) {
        int64_t chunk = 5552 - ad_defer;
        if (chunk > s) chunk = s;
        for (int64_t i = 0; i < chunk; i++) {
          ad_a += q[i];
          ad_b += ad_a;
        }
        ad_defer += chunk;
        if (ad_defer >= 5552) {
          ad_a %= 65521;
          ad_b %= 65521;
          ad_defer = 0;
        }
        q += chunk;
        s -= chunk;
      }
      p += span;
      col += span;
      left -= span;
      if (col >= row_bytes) {
        col = -1;
        row++;
        src_row = pixels + row * row_bytes;
      }
    }
  }
  ad_a %= 65521;
  ad_b %= 65521;
  png_be32(p, (static_cast<uint32_t>(ad_b) << 16) | static_cast<uint32_t>(ad_a));
  p += 4;
  png_be32(p, png_crc32(0, idat_tag, 4 + idat_len));
  p += 4;

  // IEND
  png_be32(p, 0);
  p += 4;
  p[0] = 'I'; p[1] = 'E'; p[2] = 'N'; p[3] = 'D';
  png_be32(p + 4, png_crc32(0, p, 4));
  p += 8;

  return p - out;
}

}  // extern "C"
