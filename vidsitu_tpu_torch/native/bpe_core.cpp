// Byte-level BPE encode core (C ABI, loaded via ctypes).
//
// The reference tokenizes with HuggingFace's Rust-backed
// GPT2TokenizerFast / RobertaTokenizerFast (vidsitu_code/dat_loader.py:21,
// 84-102); this is the TPU-framework's native equivalent of that hot
// path: GPT-2 pre-tokenization (contractions / letter runs / number runs
// / symbol runs / whitespace with lookahead, with \p{L}, \p{N}, \s
// matched via tables generated from Python's regex module), the byte ->
// printable-unicode remap, and the ranked BPE merge loop. The Python
// ByteLevelBPE (tokenization/bpe.py) delegates here when the shared
// library is available and is the reference/fallback implementation.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC bpe_core.cpp -o libbpe_core.so

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

// The build layer (native/__init__.py) regenerates the unicode tables
// from the RUNTIME regex module's Unicode DB when possible and points
// the override macro at the fresh header — the committed header is the
// no-regex fallback only. Keeps C++ and Python pre-tokenization
// parity-by-construction across regex/Unicode upgrades.
#ifdef VIDSITU_UNICODE_TABLES_OVERRIDE
#include VIDSITU_UNICODE_TABLES_OVERRIDE
#else
#include "unicode_tables.h"
#endif

namespace {

bool in_ranges(uint32_t cp, const uint32_t (*ranges)[2], size_t n) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (cp < ranges[mid][0]) {
      hi = mid;
    } else if (cp > ranges[mid][1]) {
      lo = mid + 1;
    } else {
      return true;
    }
  }
  return false;
}

bool is_letter(uint32_t cp) {
  return in_ranges(cp, kLetterRanges, kLetterRanges_len);
}
bool is_number(uint32_t cp) {
  return in_ranges(cp, kNumberRanges, kNumberRanges_len);
}
bool is_space(uint32_t cp) {
  return in_ranges(cp, kSpaceRanges, kSpaceRanges_len);
}

// UTF-8 decode one codepoint; returns bytes consumed (0 on error).
int utf8_decode(const unsigned char* s, size_t len, uint32_t* cp) {
  if (len == 0) return 0;
  unsigned char c = s[0];
  if (c < 0x80) {
    *cp = c;
    return 1;
  }
  int n;
  uint32_t v;
  if ((c & 0xE0) == 0xC0) {
    n = 2;
    v = c & 0x1F;
  } else if ((c & 0xF0) == 0xE0) {
    n = 3;
    v = c & 0x0F;
  } else if ((c & 0xF8) == 0xF0) {
    n = 4;
    v = c & 0x07;
  } else {
    return 0;
  }
  if ((size_t)n > len) return 0;
  for (int i = 1; i < n; i++) {
    if ((s[i] & 0xC0) != 0x80) return 0;
    v = (v << 6) | (s[i] & 0x3F);
  }
  *cp = v;
  return n;
}

// GPT-2's byte -> printable codepoint map (bytes_to_unicode).
void byte_unicode_map(uint32_t out[256]) {
  bool direct[256] = {false};
  for (int b = '!'; b <= '~'; b++) direct[b] = true;
  for (int b = 0xA1; b <= 0xAC; b++) direct[b] = true;
  for (int b = 0xAE; b <= 0xFF; b++) direct[b] = true;
  int n = 0;
  for (int b = 0; b < 256; b++) {
    if (direct[b]) {
      out[b] = (uint32_t)b;
    } else {
      out[b] = 256 + n;
      n++;
    }
  }
}

// UTF-8 encode (codepoints here are < 0x800).
void utf8_append(std::string* s, uint32_t cp) {
  if (cp < 0x80) {
    s->push_back((char)cp);
  } else if (cp < 0x800) {
    s->push_back((char)(0xC0 | (cp >> 6)));
    s->push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    s->push_back((char)(0xE0 | (cp >> 12)));
    s->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    s->push_back((char)(0x80 | (cp & 0x3F)));
  }
}

struct Bpe {
  // vocab token string (byte-encoded form, UTF-8) -> id
  std::unordered_map<std::string, int32_t> vocab;
  // merge (sym_a, sym_b) -> rank; symbols are vocab-token strings interned
  // as ids in `sym` below
  std::unordered_map<std::string, int32_t> sym_ids;
  std::vector<std::string> sym;
  std::unordered_map<int64_t, std::pair<int32_t, int32_t>> merges;  // rank, merged sym
  // per-byte symbol for the 256 byte-encoded single chars (-1 if absent)
  int32_t byte_sym[256];
  std::string byte_str[256];  // UTF-8 of the mapped codepoint
  // encode() is called concurrently from the data loader's thread pool
  // (ctypes releases the GIL), so the memoization cache is mutex-guarded;
  // everything else is read-only after bpe_create.
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::mutex cache_mu;

  int32_t intern(const std::string& s) {
    auto it = sym_ids.find(s);
    if (it != sym_ids.end()) return it->second;
    int32_t id = (int32_t)sym.size();
    sym.push_back(s);
    sym_ids.emplace(s, id);
    return id;
  }
};

int64_t pack(int32_t a, int32_t b) {
  return ((int64_t)a << 32) | (uint32_t)b;
}

// Apply the ranked merge loop to the byte-encoded pre-token; append the
// resulting vocab ids. Returns false when a final piece is missing from
// the vocab (a non-closed vocab/merges pair) — the Python core raises
// KeyError there, and silently dropping ids would change model inputs
// depending on whether a C++ toolchain was available.
bool bpe_word(Bpe* h, const std::string& token,
              const std::vector<int32_t>& start_syms,
              std::vector<int32_t>* out) {
  {
    std::lock_guard<std::mutex> lock(h->cache_mu);
    auto cit = h->cache.find(token);
    if (cit != h->cache.end()) {
      out->insert(out->end(), cit->second.begin(), cit->second.end());
      return true;
    }
  }
  std::vector<int32_t> word = start_syms;
  while (word.size() > 1) {
    int best_rank = INT32_MAX;
    int best_i = -1;
    int32_t best_merged = -1;
    for (size_t i = 0; i + 1 < word.size(); i++) {
      auto it = h->merges.find(pack(word[i], word[i + 1]));
      if (it != h->merges.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_i = (int)i;
        best_merged = it->second.second;
      }
    }
    if (best_i < 0) break;
    // merge ALL (non-overlapping, left-to-right) occurrences of the pair
    int32_t a = word[best_i], b = word[best_i + 1];
    std::vector<int32_t> nw;
    nw.reserve(word.size());
    size_t i = 0;
    while (i < word.size()) {
      if (i + 1 < word.size() && word[i] == a && word[i + 1] == b) {
        nw.push_back(best_merged);
        i += 2;
      } else {
        nw.push_back(word[i]);
        i += 1;
      }
    }
    word.swap(nw);
  }
  std::vector<int32_t> ids;
  ids.reserve(word.size());
  for (int32_t s : word) {
    auto it = h->vocab.find(h->sym[s]);
    if (it == h->vocab.end()) return false;  // non-closed vocab
    ids.push_back(it->second);
  }
  {
    std::lock_guard<std::mutex> lock(h->cache_mu);
    h->cache.emplace(token, ids);
  }
  out->insert(out->end(), ids.begin(), ids.end());
  return true;
}

}  // namespace

extern "C" {

// vocab_buf: "token\tid\n" lines (token = byte-encoded UTF-8 form);
// merges_buf: "a b\n" lines in rank order.
void* bpe_create(const char* vocab_buf, const char* merges_buf) {
  Bpe* h = new Bpe();
  {
    const char* p = vocab_buf;
    while (*p) {
      const char* tab = strchr(p, '\t');
      if (!tab) break;
      const char* nl = strchr(tab + 1, '\n');
      if (!nl) break;
      std::string tok(p, tab - p);
      int32_t id = (int32_t)strtol(tab + 1, nullptr, 10);
      h->vocab.emplace(std::move(tok), id);
      p = nl + 1;
    }
  }
  {
    const char* p = merges_buf;
    int32_t rank = 0;
    while (*p) {
      const char* sp = strchr(p, ' ');
      if (!sp) break;
      const char* nl = strchr(sp + 1, '\n');
      if (!nl) break;
      std::string a(p, sp - p);
      std::string b(sp + 1, nl - sp - 1);
      int32_t sa = h->intern(a);
      int32_t sb = h->intern(b);
      int32_t sm = h->intern(a + b);
      h->merges.emplace(pack(sa, sb), std::make_pair(rank, sm));
      rank++;
      p = nl + 1;
    }
  }
  uint32_t bmap[256];
  byte_unicode_map(bmap);
  for (int b = 0; b < 256; b++) {
    std::string s;
    utf8_append(&s, bmap[b]);
    h->byte_str[b] = s;
    h->byte_sym[b] = h->intern(s);
  }
  return h;
}

void bpe_destroy(void* handle) { delete (Bpe*)handle; }

// GPT-2 pre-tokenize + BPE-encode UTF-8 `text` into `out` (capacity
// `out_cap`); returns the id count, -1 if out_cap is too small, or -2
// when a piece is missing from the vocab (non-closed vocab/merges —
// the Python path raises KeyError; the wrapper mirrors that).
int32_t bpe_encode(void* handle, const char* text, int32_t text_len,
                   int32_t* out, int32_t out_cap) {
  Bpe* h = (Bpe*)handle;
  const unsigned char* s = (const unsigned char*)text;
  size_t len = (size_t)text_len;

  // decode codepoints once (cp, byte offset, byte length)
  std::vector<uint32_t> cps;
  std::vector<uint32_t> offs;
  std::vector<uint8_t> lens;
  size_t pos = 0;
  while (pos < len) {
    uint32_t cp;
    int n = utf8_decode(s + pos, len - pos, &cp);
    if (n == 0) {  // invalid byte: treat as latin-1 char (lossy guard)
      cp = s[pos];
      n = 1;
    }
    cps.push_back(cp);
    offs.push_back((uint32_t)pos);
    lens.push_back((uint8_t)n);
    pos += (size_t)n;
  }
  size_t nc = cps.size();

  std::vector<int32_t> ids;
  std::vector<int32_t> word_syms;
  std::string token_bytes;
  bool vocab_ok = true;

  auto emit_span = [&](size_t c0, size_t c1) {
    // byte-encode the span and run the merge loop
    token_bytes.clear();
    word_syms.clear();
    size_t b0 = offs[c0];
    size_t b1 = (c1 < nc) ? offs[c1] : len;
    for (size_t b = b0; b < b1; b++) {
      token_bytes += h->byte_str[s[b]];
      word_syms.push_back(h->byte_sym[s[b]]);
    }
    if (!bpe_word(h, token_bytes, word_syms, &ids)) vocab_ok = false;
  };

  // GPT-2 pattern, alternatives in order:
  //   's 't 're 've 'm 'll 'd | ?\p{L}+ | ?\p{N}+ | ?[^\s\p{L}\p{N}]+ |
  //   \s+(?!\S) | \s+
  size_t i = 0;
  while (i < nc) {
    // contractions (ASCII, case-sensitive)
    if (cps[i] == '\'' && i + 1 < nc) {
      uint32_t c1 = cps[i + 1];
      uint32_t c2 = (i + 2 < nc) ? cps[i + 2] : 0;
      size_t take = 0;
      if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') take = 2;
      if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') ||
          (c1 == 'l' && c2 == 'l'))
        take = 3;
      if (take) {
        emit_span(i, i + take);
        i += take;
        continue;
      }
    }
    size_t start = i;
    size_t j = i;
    bool led_space = false;
    if (cps[j] == ' ' && j + 1 < nc) {  // optional leading single space
      led_space = true;
      j++;
    }
    if (j < nc && is_letter(cps[j])) {
      while (j < nc && is_letter(cps[j])) j++;
      emit_span(start, j);
      i = j;
      continue;
    }
    if (j < nc && is_number(cps[j])) {
      while (j < nc && is_number(cps[j])) j++;
      emit_span(start, j);
      i = j;
      continue;
    }
    if (j < nc && !is_space(cps[j]) && !is_letter(cps[j]) &&
        !is_number(cps[j])) {
      while (j < nc && !is_space(cps[j]) && !is_letter(cps[j]) &&
             !is_number(cps[j]))
        j++;
      emit_span(start, j);
      i = j;
      continue;
    }
    if (led_space) j = start;  // the space wasn't followed by a taker
    // whitespace runs: \s+(?!\S) then \s+
    if (is_space(cps[j])) {
      size_t k = j;
      while (k < nc && is_space(cps[k])) k++;
      if (k < nc && k - j > 1) {
        // followed by non-space: leave the last space char for the
        // next token's optional leading space
        emit_span(j, k - 1);
        i = k - 1;
      } else if (k < nc && k - j == 1) {
        // single space before non-space: \s+(?!\S) fails, \s+ takes it
        // ... unless the next alternative consumed it above (it did not
        // reach here in that case)
        emit_span(j, k);
        i = k;
      } else {
        emit_span(j, k);  // trailing whitespace run
        i = k;
      }
      continue;
    }
    i++;  // unreachable guard
  }

  if (!vocab_ok) return -2;
  if ((int32_t)ids.size() > out_cap) return -1;
  memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return (int32_t)ids.size();
}

}  // extern "C"
