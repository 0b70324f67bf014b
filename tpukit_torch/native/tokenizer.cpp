// The port's native tokenizer (a copy of tpukit/native/tokenizer.cpp): the
// C++ twin of the piece splitting and vocab lookup of
// tpukit_torch/data.py:WordTokenizer (`_encode_one`, `__call__` with
// padding="max_length" and truncation), a multithreaded batch encoder
// behind a C ABI, loaded with ctypes (tpukit_torch/native/__init__.py).
//
// Piece splitting replicates the Python regex  ` ?[A-Za-z0-9']+| ?[^A-Za-z0-9\s]+|\s`
// (tpukit_torch/data.py:_PIECE_RE) with the same alternation semantics,
// and unknown pieces degrade to per-character encoding exactly like
// WordTokenizer._encode_one. tests/test_torch_native.py holds the ids and
// masks byte for byte to the Python encoder's and to tpukit's.

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id;
};

inline bool is_word(unsigned char c) {
  return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') ||
         (c >= '0' && c <= '9') || c == '\'';
}

inline bool is_space(unsigned char c) {
  // Python str.isspace() over the ASCII range the corpus uses
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' || c == '\f';
}

// Next piece starting at s[i]; returns its length (>= 1).
size_t next_piece(const char* s, size_t n, size_t i) {
  size_t j = i;
  bool leading_space = s[j] == ' ';
  size_t k = j + (leading_space ? 1 : 0);
  // alt 1: " ?[A-Za-z0-9']+"
  if (k < n && is_word(s[k])) {
    size_t e = k;
    while (e < n && is_word(s[e])) e++;
    return e - i;
  }
  // alt 2: " ?[^A-Za-z0-9\s]+"
  if (k < n && !is_word(s[k]) && !is_space(s[k])) {
    size_t e = k;
    while (e < n && !is_word(s[e]) && !is_space(s[e])) e++;
    return e - i;
  }
  // alt 3: single whitespace char (covers the bare space fallthrough)
  return 1;
}

void encode_one(const Tokenizer& tok, const char* text, size_t len,
                int32_t max_len, int32_t pad_id, int32_t* ids, int32_t* mask) {
  int32_t count = 0;
  std::string piece;
  for (size_t i = 0; i < len && count < max_len;) {
    size_t plen = next_piece(text, len, i);
    piece.assign(text + i, plen);
    auto it = tok.vocab.find(piece);
    if (it != tok.vocab.end()) {
      ids[count++] = it->second;
    } else {
      // unknown piece -> per-character fallback (data.py:_encode_one).
      // UTF-8 continuation bytes are skipped so a multibyte codepoint
      // yields ONE unk, matching Python's per-codepoint loop.
      for (size_t c = 0; c < plen && count < max_len; ++c) {
        if ((static_cast<unsigned char>(piece[c]) & 0xC0) == 0x80) continue;
        auto cit = tok.vocab.find(std::string(1, piece[c]));
        ids[count++] = cit != tok.vocab.end() ? cit->second : tok.unk_id;
      }
    }
    i += plen;
  }
  for (int32_t p = 0; p < count; ++p) mask[p] = 1;
  for (int32_t p = count; p < max_len; ++p) {
    ids[p] = pad_id;
    mask[p] = 0;
  }
}

}  // namespace

extern "C" {

// vocab_blob: n_tokens pieces separated by '\0'; token id == position.
void* tpukit_tok_create(const char* vocab_blob, int64_t blob_len,
                        int32_t n_tokens, int32_t unk_id) {
  auto* tok = new Tokenizer();
  tok->unk_id = unk_id;
  tok->vocab.reserve(static_cast<size_t>(n_tokens) * 2);
  const char* p = vocab_blob;
  const char* end = vocab_blob + blob_len;
  for (int32_t id = 0; id < n_tokens && p < end; ++id) {
    size_t len = strnlen(p, end - p);
    tok->vocab.emplace(std::string(p, len), id);
    p += len + 1;
  }
  return tok;
}

void tpukit_tok_destroy(void* handle) { delete static_cast<Tokenizer*>(handle); }

// texts: concatenated UTF-8; offsets: n+1 byte offsets into it.
// out_ids/out_mask: [n, max_len] row-major int32.
void tpukit_tok_encode_batch(void* handle, const char* texts,
                             const int64_t* offsets, int32_t n,
                             int32_t max_len, int32_t pad_id,
                             int32_t* out_ids, int32_t* out_mask,
                             int32_t n_threads) {
  const auto& tok = *static_cast<Tokenizer*>(handle);
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t r = lo; r < hi; ++r) {
      encode_one(tok, texts + offsets[r],
                 static_cast<size_t>(offsets[r + 1] - offsets[r]), max_len,
                 pad_id, out_ids + static_cast<int64_t>(r) * max_len,
                 out_mask + static_cast<int64_t>(r) * max_len);
    }
  };
  if (n_threads == 1 || n < 2 * n_threads) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int32_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int32_t lo = t * chunk;
    int32_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
