// cegs_parser.cpp — native Kaldi NnetChainExample binary ark parser.
//
// From-scratch C++ implementation of the cegs format (see cegs_parser.h).
// Structure mirrors the byte-level format documented in the reference
// (ref: internal/parser/parser.go tag dispatch, matrix.go codecs,
// fst.go compact_acceptor/vector readers, docs/kaldi-egs-format.md) but is
// an independent implementation: a buffered reader over the file with a
// scanner for "key \0B" record markers, a tag dispatcher, and bit-faithful
// compressed-matrix decoders.

#include "cegs_parser.h"

#include <algorithm>
#include <cmath>
#include <stdexcept>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kFstMagic = 0x7eb2fdd6u;
constexpr int32_t kNoStateId = -1;

struct Reader {
  FILE *f = nullptr;
  std::vector<uint8_t> buf;
  size_t pos = 0, len = 0;
  bool eof_flag = false;

  explicit Reader(FILE *file) : f(file), buf(1 << 16) {}

  bool fill() {
    if (eof_flag) return false;
    len = fread(buf.data(), 1, buf.size(), f);
    pos = 0;
    if (len == 0) { eof_flag = true; return false; }
    return true;
  }
  // returns -1 at EOF
  int get() {
    if (pos >= len && !fill()) return -1;
    return buf[pos++];
  }
  bool read_bytes(void *dst, size_t n) {
    uint8_t *out = static_cast<uint8_t *>(dst);
    while (n > 0) {
      if (pos >= len && !fill()) return false;
      size_t take = std::min(n, len - pos);
      memcpy(out, buf.data() + pos, take);
      pos += take; out += take; n -= take;
    }
    return true;
  }
  bool read_i32(int32_t *v) { return read_bytes(v, 4); }
  bool read_u32(uint32_t *v) { return read_bytes(v, 4); }
  bool read_i64(int64_t *v) { return read_bytes(v, 8); }
  bool read_u64(uint64_t *v) { return read_bytes(v, 8); }
  bool read_f32(float *v) { return read_bytes(v, 4); }
};

struct IoBlock {
  std::string name;
  int rows = 0, cols = 0;
  int fmt = 0;  // 0=CM 1=CM2 2=CM3 3=FM 4=SM (matrix codec of the source ark)
  std::vector<float> data;
  std::vector<int32_t> indexes;  // triples
};

struct Example {
  std::string key;
  std::vector<IoBlock> inputs;
  std::string sup_name;
  int dw_fmt = 0;  // 0=none 1=DW 2=DW2
  float weight = 0;
  int num_sequences = 0, frames_per_seq = 0, label_dim = 0;
  bool end2end = false;
  std::vector<int32_t> sup_indexes;
  std::vector<float> deriv_weights;
  // flattened supervision FST
  int fst_num_states = 0, fst_start = 0;
  std::vector<int32_t> arc_src, arc_dst, arc_label;
  std::vector<float> arc_weight;
  std::vector<int32_t> final_states;
  std::vector<float> final_weights;
};

inline bool is_letter(int b) {
  return (b >= 'a' && b <= 'z') || (b >= 'A' && b <= 'Z');
}
inline bool is_key_char(int b) {
  return is_letter(b) || (b >= '0' && b <= '9') || b == '-' || b == '_' ||
         b == '.';
}

}  // namespace

struct CegsParser {
  FILE *file = nullptr;
  Reader *r = nullptr;
  Example ex;
  std::string error;
  int pending = -2;  // lookahead byte pushed back by the scanner, or -2

  ~CegsParser() {
    delete r;
    if (file) fclose(file);
  }

  int get() {
    if (pending != -2) { int b = pending; pending = -2; return b; }
    return r->get();
  }
  void unget(int b) { pending = b; }

  // ---- scalar helpers -----------------------------------------------------

  // Kaldi WriteBasicType framing: optional token-space, size byte, payload.
  bool read_basic_int(int32_t *out) {
    int b = get();
    if (b == ' ') b = get();
    if (b == 1) { int v = get(); if (v < 0) return false;
      *out = static_cast<int8_t>(v); return true; }
    if (b == 4) return r->read_i32(out);
    if (b == 8) { int64_t v; if (!r->read_i64(&v)) return false;
      *out = static_cast<int32_t>(v); return true; }
    return false;
  }
  bool read_basic_float(float *out) {
    int b = get();
    if (b == ' ') b = get();
    if (b != 4) return false;
    return r->read_f32(out);
  }

  // ---- scanning -----------------------------------------------------------

  bool find_example_start(std::string *key) {
    std::string k;
    bool in_key = false;
    for (;;) {
      int b = get();
      if (b < 0) return false;
      if (!in_key) {
        if (is_letter(b)) { in_key = true; k.assign(1, char(b)); }
        continue;
      }
      if (is_key_char(b)) { k.push_back(char(b)); continue; }
      if (b == ' ' && k.size() >= 3) {
        int b2 = get();
        if (b2 == 0) {
          int b3 = get();
          if (b3 == 'B') { *key = k; return true; }
        }
      }
      in_key = false;
      k.clear();
    }
  }

  bool try_read_tag(std::string *tag) {
    tag->clear();
    for (;;) {
      int b = get();
      if (b < 0) return false;
      if (b == '>') break;
      if (b == ' ') { unget(b); break; }
      if (!(is_key_char(b) || b == '/')) return false;
      tag->push_back(char(b));
      if (tag->size() > 30) return false;
    }
    return tag->size() >= 2;
  }

  std::string read_name() {
    int b = get();
    if (b != ' ') unget(b);
    std::string name;
    for (;;) {
      b = get();
      if (b < 0 || b == ' ') break;
      if (b == '<') { unget(b); break; }
      name.push_back(char(b));
    }
    return name;
  }

  // ---- index vectors ------------------------------------------------------

  bool read_index_vector(int count, std::vector<int32_t> *out) {
    if (count <= 0 || count > 1000000) return false;
    out->clear();
    out->reserve(size_t(count) * 3);
    int32_t n = 0, t = 0, x = 0;
    for (int i = 0; i < count; i++) {
      int b = get();
      if (b < 0) return false;
      int8_t c = static_cast<int8_t>(b);
      if (c == 127) {
        if (!read_basic_int(&n) || !read_basic_int(&t) || !read_basic_int(&x))
          return false;
      } else if (i == 0) {
        n = 0; t = c; x = 0;
      } else {
        t += c;
      }
      out->push_back(n); out->push_back(t); out->push_back(x);
    }
    return true;
  }

  // ---- matrices -----------------------------------------------------------

  bool read_global_header(float *gmin, float *grange, int32_t *rows,
                          int32_t *cols) {
    if (!r->read_f32(gmin) || !r->read_f32(grange) || !r->read_i32(rows) ||
        !r->read_i32(cols))
      return false;
    return *rows > 0 && *cols > 0 && *rows <= 100000 && *cols <= 10000;
  }

  static float u16_to_f(float gmin, float grange, uint16_t v) {
    const float inv65535 = 1.52590218966964e-05f;
    return gmin + grange * inv65535 * float(v);
  }
  static float char_to_f(float p0, float p25, float p75, float p100,
                         uint8_t v) {
    if (v <= 64) return p0 + (p25 - p0) * float(v) * (1.0f / 64.0f);
    if (v <= 192) return p25 + (p75 - p25) * float(v - 64) * (1.0f / 128.0f);
    // fp32 multiply, fp64 divide (Kaldi quirk; ref matrix.go:17-26)
    float m = (p100 - p75) * float(v - 192);
    return float(double(p75) + double(m) / 63.0);
  }

  bool read_cm(IoBlock *io) {
    float gmin, grange; int32_t rows, cols;
    if (!read_global_header(&gmin, &grange, &rows, &cols)) return false;
    std::vector<uint8_t> hdr(size_t(cols) * 8);
    if (!r->read_bytes(hdr.data(), hdr.size())) return false;
    std::vector<uint8_t> raw(size_t(rows) * cols);
    if (!r->read_bytes(raw.data(), raw.size())) return false;
    io->rows = rows; io->cols = cols;
    io->data.resize(size_t(rows) * cols);
    for (int c = 0; c < cols; c++) {
      const uint8_t *h = hdr.data() + size_t(c) * 8;
      uint16_t q[4];
      memcpy(q, h, 8);
      float p0 = u16_to_f(gmin, grange, q[0]);
      float p25 = u16_to_f(gmin, grange, q[1]);
      float p75 = u16_to_f(gmin, grange, q[2]);
      float p100 = u16_to_f(gmin, grange, q[3]);
      const uint8_t *col = raw.data() + size_t(c) * rows;  // column-major
      for (int row = 0; row < rows; row++)
        io->data[size_t(row) * cols + c] = char_to_f(p0, p25, p75, p100, col[row]);
    }
    return true;
  }

  bool read_cm2(IoBlock *io) {
    float gmin, grange; int32_t rows, cols;
    if (!read_global_header(&gmin, &grange, &rows, &cols)) return false;
    std::vector<uint16_t> raw(size_t(rows) * cols);
    if (!r->read_bytes(raw.data(), raw.size() * 2)) return false;
    io->rows = rows; io->cols = cols;
    io->data.resize(raw.size());
    float inc = grange / 65535.0f;
    for (size_t i = 0; i < raw.size(); i++)
      io->data[i] = gmin + float(raw[i]) * inc;
    return true;
  }

  bool read_cm3(IoBlock *io) {
    float gmin, grange; int32_t rows, cols;
    if (!read_global_header(&gmin, &grange, &rows, &cols)) return false;
    std::vector<uint8_t> raw(size_t(rows) * cols);
    if (!r->read_bytes(raw.data(), raw.size())) return false;
    io->rows = rows; io->cols = cols;
    io->data.resize(raw.size());
    float inc = grange / 255.0f;
    for (size_t i = 0; i < raw.size(); i++)
      io->data[i] = gmin + float(raw[i]) * inc;
    return true;
  }

  // WriteBasicType<int32/float32>, tolerating one optional leading space:
  // the reference's SM fixtures frame every basic type as ' '+size+payload
  // (sm_parse_test.go) while real Kaldi writes size+payload only — 0x20 is
  // not a valid size byte, so skipping it is unambiguous.
  bool read_basic_i32_sp(int32_t *v) {
    int b = get();
    if (b == ' ') b = get();
    if (b != 4) return false;
    return r->read_i32(v);
  }
  bool read_basic_f32_sp(float *v) {
    int b = get();
    if (b == ' ') b = get();
    if (b != 4) return false;
    return r->read_f32(v);
  }

  // SM: num_rows, then per row "SV" + dim + num_elems + (index,value) pairs
  // (ref: matrix.go:172-226).  Densified into row-major data like the
  // other codecs; duplicate indices accumulate.
  bool read_sm(IoBlock *io) {
    int32_t num_rows;
    if (!read_basic_i32_sp(&num_rows)) return false;
    // accept the same inputs as the Python reader
    // (io/matrix.py read_sparse_matrix: rows <= 10M, dim unbounded) so
    // use_native=true never diverges from the fallback; the densify
    // allocation below is guarded separately.
    if (num_rows < 0 || num_rows > 10000000) return false;
    std::vector<std::vector<std::pair<int32_t, float>>> rows(num_rows);
    int32_t cols = 0;
    for (int32_t i = 0; i < num_rows; i++) {
      int b1 = get(), b2 = get();
      if (b1 != 'S' || b2 != 'V') return false;
      int32_t dim, n;
      if (!read_basic_i32_sp(&dim) || !read_basic_i32_sp(&n)) return false;
      if (dim < 0 || n < 0 || n > dim) return false;
      cols = std::max(cols, dim);
      rows[i].reserve(n);
      for (int32_t k = 0; k < n; k++) {
        int32_t idx; float val;
        if (!read_basic_i32_sp(&idx) || !read_basic_f32_sp(&val))
          return false;
        if (idx < 0 || idx >= dim) return false;
        rows[i].emplace_back(idx, val);
      }
    }
    io->rows = num_rows; io->cols = cols;
    // densify guard only (not a format cap): corrupt sizes must fail
    // the parse, not attempt a multi-GB allocation.  500M floats = 2GB,
    // far above any real eg (frames x pdfs).
    if (size_t(num_rows) * size_t(cols) > 500000000u) return false;
    io->data.assign(size_t(num_rows) * cols, 0.0f);
    for (int32_t i = 0; i < num_rows; i++)
      for (auto &p : rows[i])
        io->data[size_t(i) * cols + p.first] += p.second;
    return true;
  }

  bool read_fm(IoBlock *io) {
    int b = get();
    if (b != 4) return false;
    int32_t rows, cols;
    if (!r->read_i32(&rows)) return false;
    b = get();
    if (b != 4) return false;
    if (!r->read_i32(&cols)) return false;
    // same sanity caps as the compressed-matrix header: corrupt size
    // fields must fail the parse, not attempt a multi-GB allocation
    if (rows <= 0 || cols <= 0 || rows > 100000 || cols > 10000) return false;
    io->rows = rows; io->cols = cols;
    io->data.resize(size_t(rows) * cols);
    return r->read_bytes(io->data.data(), io->data.size() * 4);
  }

  // ---- FSTs ---------------------------------------------------------------

  bool read_string(std::string *s) {
    uint32_t n;
    if (!r->read_u32(&n) || n > 256) return false;
    s->resize(n);
    return r->read_bytes(&(*s)[0], n);
  }

  bool read_fst() {
    uint32_t magic;
    if (!r->read_u32(&magic) || magic != kFstMagic) return false;
    std::string fst_type, arc_type;
    if (!read_string(&fst_type) || !read_string(&arc_type)) return false;
    if (arc_type != "standard") return false;
    int32_t version, flags; uint64_t props;
    int64_t start, num_states, num_arcs;
    if (!r->read_i32(&version) || !r->read_i32(&flags) ||
        !r->read_u64(&props) || !r->read_i64(&start) ||
        !r->read_i64(&num_states) || !r->read_i64(&num_arcs))
      return false;
    // corrupt counts must fail cleanly: negative num_states would index
    // offsets[-1] (heap OOB), huge ones would allocate gigabytes
    if (num_states < 0 || num_states > 10000000 || num_arcs < -1 ||
        num_arcs > 100000000 || start < kNoStateId ||
        start >= std::max<int64_t>(num_states, 1))
      return false;
    ex.fst_num_states = int(num_states);
    ex.fst_start = int(start);
    ex.arc_src.clear(); ex.arc_dst.clear(); ex.arc_label.clear();
    ex.arc_weight.clear(); ex.final_states.clear(); ex.final_weights.clear();

    if (fst_type == "compact_acceptor") {
      std::vector<uint32_t> offsets(num_states + 1);
      for (auto &o : offsets)
        if (!r->read_u32(&o)) return false;
      uint32_t ncompacts = offsets[num_states];
      if (ncompacts > 100000000u) return false;
      for (int64_t sdx = 0; sdx < num_states; sdx++)
        if (offsets[sdx] > offsets[sdx + 1]) return false;
      struct Compact { int32_t label; float weight; int32_t next; };
      std::vector<Compact> compacts(ncompacts);
      for (auto &c : compacts) {
        if (!r->read_i32(&c.label) || !r->read_f32(&c.weight) ||
            !r->read_i32(&c.next))
          return false;
      }
      for (int64_t s = 0; s < num_states; s++) {
        for (uint32_t i = offsets[s]; i < offsets[s + 1]; i++) {
          const Compact &c = compacts[i];
          if (c.next == kNoStateId) {
            ex.final_states.push_back(int32_t(s));
            ex.final_weights.push_back(c.weight);
          } else {
            ex.arc_src.push_back(int32_t(s));
            ex.arc_dst.push_back(c.next);
            ex.arc_label.push_back(c.label);
            ex.arc_weight.push_back(c.weight);
          }
        }
      }
      return true;
    }
    if (fst_type == "vector") {
      for (int64_t s = 0; s < num_states; s++) {
        float final_w;
        int64_t narcs;
        if (!r->read_f32(&final_w) || !r->read_i64(&narcs)) return false;
        if (narcs < 0 || narcs > 100000000) return false;
        if (!std::isinf(final_w)) {
          ex.final_states.push_back(int32_t(s));
          ex.final_weights.push_back(final_w);
        }
        for (int64_t a = 0; a < narcs; a++) {
          int32_t il, ol, next; float w;
          if (!r->read_i32(&il) || !r->read_i32(&ol) || !r->read_f32(&w) ||
              !r->read_i32(&next))
            return false;
          if (next < 0 || next >= num_states) return false;
          ex.arc_src.push_back(int32_t(s));
          ex.arc_dst.push_back(next);
          ex.arc_label.push_back(il);
          ex.arc_weight.push_back(w);
        }
      }
      return true;
    }
    return false;
  }

  // ---- deriv weights ------------------------------------------------------

  bool read_deriv_weights(bool dw2) {
    int b = get();
    if (b != ' ') unget(b);
    int b1 = get(), b2 = get();
    if (b1 != 'F' || b2 != 'V') return false;
    get();  // space after FV token
    int32_t size;
    if (dw2) {
      int sz = get();
      if (sz != 4) return false;
      if (!r->read_i32(&size) || size < 0 || size > 10000000) return false;
      ex.deriv_weights.resize(size);
      return r->read_bytes(ex.deriv_weights.data(), size_t(size) * 4);
    }
    // DW: raw int32 count, then bytes/255 (ref fst.go:243)
    if (!r->read_i32(&size) || size < 0 || size > 10000000) return false;
    std::vector<uint8_t> raw(size);
    if (!r->read_bytes(raw.data(), raw.size())) return false;
    ex.deriv_weights.resize(size);
    for (int i = 0; i < size; i++)
      ex.deriv_weights[i] = float(raw[i]) / 255.0f;
    return true;
  }

  // ---- example ------------------------------------------------------------

  bool parse_example() {
    ex = Example();
    std::string current_name;
    std::vector<int32_t> current_indexes;

    for (;;) {
      int b = get();
      if (b < 0) { error = "unexpected EOF in example"; return false; }

      if ((b == 'C' || b == 'F' || b == 'S') && !current_name.empty()) {
        int b2 = get();
        IoBlock io;
        bool got = false;
        if (b == 'C' && b2 == 'M') {
          int b3 = get();
          if (b3 == '2') { get(); io.fmt = 1; got = read_cm2(&io); }
          else if (b3 == '3') { get(); io.fmt = 2; got = read_cm3(&io); }
          else if (b3 == ' ') { io.fmt = 0; got = read_cm(&io); }
          else { unget(b3); continue; }
        } else if (b == 'F' && b2 == 'M') {
          int b3 = get();
          if (b3 == ' ') { io.fmt = 3; got = read_fm(&io); }
          else { unget(b3); continue; }
        } else if (b == 'S' && b2 == 'M') {
          int b3 = get();
          if (b3 == ' ') { io.fmt = 4; got = read_sm(&io); }
          else { unget(b3); continue; }
        } else {
          if (b2 >= 0) unget(b2);
          continue;
        }
        if (got) {
          io.name = current_name;
          io.indexes = std::move(current_indexes);
          ex.inputs.push_back(std::move(io));
          current_name.clear();
          current_indexes.clear();
        }
        continue;
      }

      if (b != '<') continue;
      std::string tag;
      if (!try_read_tag(&tag)) continue;

      if (tag == "NumInputs" || tag == "NumOutputs") {
        int32_t v;
        if (!read_basic_int(&v)) { error = "bad " + tag; return false; }
      } else if (tag == "NnetIo") {
        current_name = read_name();
      } else if (tag == "I1V") {
        int32_t count;
        if (!read_basic_int(&count) || count <= 0) {
          error = "bad I1V count"; return false;
        }
        std::vector<int32_t> idx;
        if (!read_index_vector(count, &idx)) {
          error = "index vector EOF"; return false;
        }
        if (!current_name.empty()) current_indexes = std::move(idx);
        else ex.sup_indexes = std::move(idx);
      } else if (tag == "/NnetIo") {
        current_name.clear();
      } else if (tag == "NnetChainSup") {
        ex.sup_name = read_name();
      } else if (tag == "Weight") {
        // a silently-discarded failure here desyncs the stream and zeroes
        // the field where the Python parser raises — fail the parse
        if (!read_basic_float(&ex.weight)) { error = "bad Weight"; return false; }
      } else if (tag == "NumSequences") {
        int32_t v;
        if (!read_basic_int(&v)) { error = "bad NumSequences"; return false; }
        ex.num_sequences = v;
      } else if (tag == "FramesPerSeq") {
        int32_t v;
        if (!read_basic_int(&v)) { error = "bad FramesPerSeq"; return false; }
        ex.frames_per_seq = v;
      } else if (tag == "LabelDim") {
        int32_t v;
        if (!read_basic_int(&v)) { error = "bad LabelDim"; return false; }
        ex.label_dim = v;
      } else if (tag == "End2End") {
        get();  // space
        int e = get();
        ex.end2end = (e == 'T');
        if (!ex.end2end && !read_fst()) {
          error = "failed to read supervision FST"; return false;
        }
      } else if (tag == "DW" || tag == "DW2") {
        ex.dw_fmt = (tag == "DW2") ? 2 : 1;
        if (!read_deriv_weights(tag == "DW2")) {
          error = "failed to read deriv weights"; return false;
        }
      } else if (tag == "/Nnet3ChainEg") {
        return true;
      }
    }
  }
};

// ---- C ABI -----------------------------------------------------------------

extern "C" {

CegsParser *cegs_open(const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  CegsParser *p = new CegsParser();
  p->file = f;
  p->r = new Reader(f);
  return p;
}

void cegs_close(CegsParser *p) { delete p; }

const char *cegs_last_error(CegsParser *p) {
  return p->error.empty() ? nullptr : p->error.c_str();
}

int cegs_next(CegsParser *p) {
  // exception barrier: corrupt size fields can throw bad_alloc /
  // length_error from vector::resize; unwinding through the C ABI into
  // ctypes is undefined behavior (in practice SIGABRT) — convert to -1
  try {
    std::string key;
    if (!p->find_example_start(&key)) return 0;  // EOF
    if (!p->parse_example()) return -1;
    p->ex.key = key;
    return 1;
  } catch (const std::exception &e) {
    p->error = std::string("native parse exception: ") + e.what();
    return -1;
  } catch (...) {
    p->error = "native parse exception";
    return -1;
  }
}

const char *cegs_sup_name(CegsParser *p) { return p->ex.sup_name.c_str(); }
int cegs_input_fmt(CegsParser *p, int i) { return p->ex.inputs[i].fmt; }
int cegs_dw_fmt(CegsParser *p) { return p->ex.dw_fmt; }

const char *cegs_key(CegsParser *p) { return p->ex.key.c_str(); }
int cegs_num_inputs(CegsParser *p) { return int(p->ex.inputs.size()); }
const char *cegs_input_name(CegsParser *p, int i) {
  return p->ex.inputs[i].name.c_str();
}
int cegs_input_rows(CegsParser *p, int i) { return p->ex.inputs[i].rows; }
int cegs_input_cols(CegsParser *p, int i) { return p->ex.inputs[i].cols; }
const float *cegs_input_data(CegsParser *p, int i) {
  return p->ex.inputs[i].data.data();
}
int cegs_input_num_indexes(CegsParser *p, int i) {
  return int(p->ex.inputs[i].indexes.size() / 3);
}
const int32_t *cegs_input_indexes(CegsParser *p, int i) {
  return p->ex.inputs[i].indexes.data();
}

float cegs_sup_weight(CegsParser *p) { return p->ex.weight; }
int cegs_sup_num_sequences(CegsParser *p) { return p->ex.num_sequences; }
int cegs_sup_frames_per_seq(CegsParser *p) { return p->ex.frames_per_seq; }
int cegs_sup_label_dim(CegsParser *p) { return p->ex.label_dim; }
int cegs_sup_end2end(CegsParser *p) { return p->ex.end2end ? 1 : 0; }
int cegs_sup_num_indexes(CegsParser *p) {
  return int(p->ex.sup_indexes.size() / 3);
}
const int32_t *cegs_sup_indexes(CegsParser *p) {
  return p->ex.sup_indexes.data();
}
int cegs_sup_num_deriv_weights(CegsParser *p) {
  return int(p->ex.deriv_weights.size());
}
const float *cegs_sup_deriv_weights(CegsParser *p) {
  return p->ex.deriv_weights.data();
}

// Packed per-example scalar metadata: ONE ctypes round trip instead of
// ~15 (each call costs ~1 us of ctypes dispatch; at 128-example batches
// the scalar getters were a measurable slice of the host loop).  Layout
// (int32): [0]=num_inputs [1]=fst_num_states [2]=fst_start
// [3]=num_arcs [4]=num_finals [5]=num_sequences [6]=frames_per_seq
// [7]=label_dim [8]=end2end [9]=dw_fmt [10]=sup_num_indexes
// [11]=num_deriv_weights [12]=bitcast(weight f32) then per input i
// (i < min(num_inputs, 4)): [13+4i]=rows [14+4i]=cols [15+4i]=fmt
// [16+4i]=num_indexes.  Returns the number of int32s written.
int cegs_meta(CegsParser *p, int32_t *out) {
  const Example &e = p->ex;
  out[0] = int32_t(e.inputs.size());
  out[1] = e.fst_num_states;
  out[2] = e.fst_start;
  out[3] = int32_t(e.arc_src.size());
  out[4] = int32_t(e.final_states.size());
  out[5] = e.num_sequences;
  out[6] = e.frames_per_seq;
  out[7] = e.label_dim;
  out[8] = e.end2end ? 1 : 0;
  out[9] = e.dw_fmt;
  out[10] = int32_t(e.sup_indexes.size() / 3);
  out[11] = int32_t(e.deriv_weights.size());
  memcpy(&out[12], &e.weight, sizeof(int32_t));
  int n = 13;
  int ni = int(e.inputs.size()) < 4 ? int(e.inputs.size()) : 4;
  for (int i = 0; i < ni; i++) {
    out[n++] = e.inputs[i].rows;
    out[n++] = e.inputs[i].cols;
    out[n++] = e.inputs[i].fmt;
    out[n++] = int32_t(e.inputs[i].indexes.size() / 3);
  }
  return n;
}

int cegs_fst_num_states(CegsParser *p) { return p->ex.fst_num_states; }
int cegs_fst_start(CegsParser *p) { return p->ex.fst_start; }
int cegs_fst_num_arcs(CegsParser *p) { return int(p->ex.arc_src.size()); }
const int32_t *cegs_fst_arc_src(CegsParser *p) { return p->ex.arc_src.data(); }
const int32_t *cegs_fst_arc_dst(CegsParser *p) { return p->ex.arc_dst.data(); }
const int32_t *cegs_fst_arc_label(CegsParser *p) {
  return p->ex.arc_label.data();
}
const float *cegs_fst_arc_weight(CegsParser *p) {
  return p->ex.arc_weight.data();
}
int cegs_fst_num_finals(CegsParser *p) {
  return int(p->ex.final_states.size());
}
const int32_t *cegs_fst_final_states(CegsParser *p) {
  return p->ex.final_states.data();
}
const float *cegs_fst_final_weights(CegsParser *p) {
  return p->ex.final_weights.data();
}

}  // extern "C"
