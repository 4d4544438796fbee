// Native WordPiece tokenizer (ASCII fast path).
//
// The port's copy of native/wordpiece.cc (same C ABI), built by
// mmt_tpu_torch/_build.py:build_host at first use and bound by
// mmt_tpu_torch/tokenization.py.  Implements the ASCII subset of BERT
// basic tokenization (lower-casing, control-char stripping, punctuation
// splitting) plus greedy longest-match-first WordPiece with "##"
// continuations, identical to the Python path of
// mmt_tpu_torch/tokenization.py for ASCII input without NUL (the Python
// wrapper routes any other text to its full-Unicode path).
//
// One difference from native/wordpiece.cc: a control character other
// than \t, \n and \r is dropped, as the Python path's _clean drops it,
// not treated as a word break (native/wordpiece.cc splits "a\x01b" into
// "a", "b" where the Python path reads "ab").
//
// One immutable vocab set per handle, safe for concurrent use from
// loader threads; ctypes releases the GIL for each call.
//
// C ABI (ctypes-friendly):
//   void* wp_create(const char* vocab_file, int do_lower_case);
//   int   wp_tokenize(void* handle, const char* text,
//                     char* out, int out_cap);   // '\x01'-joined tokens
//   void  wp_destroy(void* handle);

#include <cctype>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

struct WordPiece {
  std::unordered_set<std::string> vocab;
  bool lower = true;
  static constexpr int kMaxChars = 100;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Greedy longest-match-first subword split; appends pieces to out.
bool wordpiece_split(const WordPiece& wp, const std::string& token,
                     std::vector<std::string>* out) {
  if (static_cast<int>(token.size()) > WordPiece::kMaxChars) {
    out->push_back("[UNK]");
    return true;
  }
  std::vector<std::string> pieces;
  size_t start = 0;
  const size_t n = token.size();
  while (start < n) {
    size_t end = n;
    bool found = false;
    std::string cur;
    while (start < end) {
      std::string piece = token.substr(start, end - start);
      if (start > 0) piece = "##" + piece;
      if (wp.vocab.count(piece)) {
        cur = std::move(piece);
        found = true;
        break;
      }
      --end;
    }
    if (!found) {
      out->push_back("[UNK]");
      return true;
    }
    pieces.push_back(std::move(cur));
    start = end;
  }
  for (auto& p : pieces) out->push_back(std::move(p));
  return true;
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_file, int do_lower_case) {
  std::ifstream in(vocab_file);
  if (!in.good()) return nullptr;
  auto* wp = new WordPiece;
  wp->lower = do_lower_case != 0;
  std::string line;
  while (std::getline(in, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    wp->vocab.insert(line);
  }
  return wp;
}

void wp_destroy(void* handle) {
  delete static_cast<WordPiece*>(handle);
}

int wp_tokenize(void* handle, const char* text, char* out, int out_cap) {
  const auto* wp = static_cast<const WordPiece*>(handle);
  if (!wp || !text || !out) return -1;

  // Basic tokenization: split on whitespace, drop control characters,
  // isolate punctuation, lower-case.  ASCII only: other bytes return -2.
  std::vector<std::string> words;
  std::string cur;
  for (const char* p = text; *p; ++p) {
    unsigned char c = static_cast<unsigned char>(*p);
    if (c >= 128) return -2;  // non-ASCII: caller must fall back
    // BERT's whitespace in ASCII is ' ', \t, \n, \r; every other
    // control character (0-31, 127) is removed without a break.
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      if (!cur.empty()) { words.push_back(cur); cur.clear(); }
      continue;
    }
    if (std::iscntrl(c)) continue;
    if (is_ascii_punct(c)) {
      if (!cur.empty()) { words.push_back(cur); cur.clear(); }
      words.emplace_back(1, static_cast<char>(c));
      continue;
    }
    cur.push_back(wp->lower ? static_cast<char>(std::tolower(c))
                            : static_cast<char>(c));
  }
  if (!cur.empty()) words.push_back(cur);

  std::vector<std::string> pieces;
  pieces.reserve(words.size() * 2);
  for (const auto& w : words) wordpiece_split(*wp, w, &pieces);

  // Join with '\x01'.
  int pos = 0;
  for (size_t i = 0; i < pieces.size(); ++i) {
    int need = static_cast<int>(pieces[i].size()) + (i ? 1 : 0);
    if (pos + need + 1 > out_cap) return -1;
    if (i) out[pos++] = '\x01';
    std::memcpy(out + pos, pieces[i].data(), pieces[i].size());
    pos += static_cast<int>(pieces[i].size());
  }
  out[pos] = '\0';
  return pos;
}

}  // extern "C"
