// Copied from swat_tpu/retrieval/indexer/caption_index.cpp; the port keeps its own copy, permanently.
// Caption inverted index — C++ engine for swat_tpu_torch.retrieval.stringmatch.
//
// Replaces the reference's SQLite FTS5 caption tables
// (reference retrieval/laion_parser.py:67-79,157-167) with an in-memory
// inverted index over a newline-separated caption corpus.  Tokenization is
// lowercase [0-9a-z]+ runs (ASCII subset of FTS5 unicode61), matching the
// python engine exactly so both produce identical retrieved pools.
//
// C ABI (ctypes):
//   void*   idx_build_file(const char* path)         // newline-separated
//   void*   idx_build_buffer(const char* buf, long n)
//   long    idx_num_captions(void* h)
//   long    idx_query(void* h, const char* query, int phrase,
//                     long* out, long cap)            // AND of tokens
//   void    idx_free(void* h)
//
// Build: make -C swat_tpu_torch/retrieval/indexer

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <fstream>
#include <sstream>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Index {
  std::vector<std::vector<int32_t>> caption_tokens;  // token ids per caption
  std::unordered_map<std::string, int32_t> vocab;
  std::vector<std::vector<int64_t>> postings;  // token id -> caption ids
};

// Memory-mapped flat index (format v2): tokens sorted lexicographically so
// lookup is a binary search over the blob — no hash rebuild at load time,
// and the OS pages postings in lazily (cold "load" is one mmap syscall;
// a 400M-caption shard set opens instantly).
struct FlatIndex {
  void* map = nullptr;
  size_t len = 0;
  int64_t n_captions = 0, n_tokens = 0;
  const int64_t* cap_off = nullptr;   // [n_captions+1] counts into cap_tok
  const int32_t* cap_tok = nullptr;   // flattened per-caption token ids
  const int64_t* vocab_off = nullptr; // [n_tokens+1] byte offsets
  const char* vocab_blob = nullptr;
  const int64_t* post_off = nullptr;  // [n_tokens+1] counts into postings
  const int64_t* postings = nullptr;
  ~FlatIndex() { if (map) munmap(map, len); }
};

struct Handle {
  Index* mem = nullptr;
  FlatIndex* flat = nullptr;
};

// unicode61(remove_diacritics=1) tokenization, EXACT: the per-codepoint
// classification tables in unicode61_table.h are extracted from sqlite's
// executed behavior (scripts/gen_unicode61_table.py reads FTS5's own
// tokens back through fts5vocab for every codepoint).  Token chars are
// alphanumerics of any script, combining marks are dropped mid-token,
// precomposed Latin folds to its base (u-umlaut -> u) while o-slash /
// ae / eszett / l-stroke / non-Latin keep identity, case lowers.
#include "unicode61_table.h"

static inline bool u61_in(uint32_t cp, const U61Range* r, size_t n) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    const size_t m = (lo + hi) / 2;
    if (r[m].hi < cp) lo = m + 1; else hi = m;
  }
  return lo < n && r[lo].lo <= cp && cp <= r[lo].hi;
}

static inline const U61Fold* u61_fold(uint32_t cp) {
  size_t lo = 0, hi = sizeof(kU61Folds) / sizeof(kU61Folds[0]);
  while (lo < hi) {
    const size_t m = (lo + hi) / 2;
    if (kU61Folds[m].cp < cp) lo = m + 1; else hi = m;
  }
  if (lo < sizeof(kU61Folds) / sizeof(kU61Folds[0]) &&
      kU61Folds[lo].cp == cp) return &kU61Folds[lo];
  return nullptr;
}

static inline void u61_emit(uint32_t cp, std::string* out) {
  if (cp < 0x80) { out->push_back(static_cast<char>(cp)); return; }
  if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

inline void tokenize(const std::string& text, std::vector<std::string>* out) {
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) { out->push_back(cur); cur.clear(); }
  };
  const unsigned char* p =
      reinterpret_cast<const unsigned char*>(text.data());
  const size_t n = text.size();
  size_t i = 0;
  while (i < n) {
    const unsigned char c = p[i];
    if (c < 0x80) {                                   // ASCII fast path
      if (std::isalnum(c)) cur.push_back(static_cast<char>(std::tolower(c)));
      else flush();
      ++i;
      continue;
    }
    // UTF-8 decode; malformed bytes act as separators
    uint32_t cp = 0;
    size_t len = 0;
    if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; len = 2; }
    else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; len = 3; }
    else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; len = 4; }
    if (len == 0 || i + len > n) { flush(); ++i; continue; }
    bool ok = true;
    for (size_t k = 1; k < len; ++k) {
      if ((p[i + k] & 0xC0) != 0x80) { ok = false; break; }
      cp = (cp << 6) | (p[i + k] & 0x3F);
    }
    if (!ok) { flush(); ++i; continue; }
    i += len;
    if (const U61Fold* f = u61_fold(cp)) {            // non-identity fold
      u61_emit(f->to[0], &cur);
      if (f->to[1]) u61_emit(f->to[1], &cur);
    } else if (u61_in(cp, kU61Identity,
                      sizeof(kU61Identity) / sizeof(kU61Identity[0]))) {
      u61_emit(cp, &cur);                             // identity token char
    } else if (u61_in(cp, kU61Transparent,
                      sizeof(kU61Transparent) /
                      sizeof(kU61Transparent[0]))) {
      // transparent: dropped, token continues
    } else {
      flush();                                        // separator
    }
  }
  flush();
}

// caption normalization: quotes removed, '-'/'_' -> space (the tokenizer
// already splits on them, and quote removal merges "don't" -> "dont" the
// same way the python engine's normalize_caption + tokenize does)
inline std::string normalize(const std::string& text) {
  std::string out;
  out.reserve(text.size());
  for (char c : text) {
    if (c == '"' || c == '\'') continue;
    if (c == '-' || c == '_') { out.push_back(' '); continue; }
    out.push_back(c);
  }
  return out;
}

Index* build(std::istream& in) {
  auto* idx = new Index();
  std::string line;
  std::vector<std::string> toks;
  while (std::getline(in, line)) {
    toks.clear();
    tokenize(normalize(line), &toks);
    std::vector<int32_t> ids;
    ids.reserve(toks.size());
    const int64_t cap_id = static_cast<int64_t>(idx->caption_tokens.size());
    for (const auto& t : toks) {
      auto it = idx->vocab.find(t);
      int32_t tid;
      if (it == idx->vocab.end()) {
        tid = static_cast<int32_t>(idx->vocab.size());
        idx->vocab.emplace(t, tid);
        idx->postings.emplace_back();
      } else {
        tid = it->second;
      }
      ids.push_back(tid);
      auto& plist = idx->postings[tid];
      if (plist.empty() || plist.back() != cap_id) plist.push_back(cap_id);
    }
    idx->caption_tokens.push_back(std::move(ids));
  }
  return idx;
}

bool contains_phrase(const std::vector<int32_t>& hay,
                     const std::vector<int32_t>& needle) {
  if (needle.size() > hay.size()) return false;
  for (size_t i = 0; i + needle.size() <= hay.size(); ++i) {
    bool ok = true;
    for (size_t j = 0; j < needle.size(); ++j) {
      if (hay[i + j] != needle[j]) { ok = false; break; }
    }
    if (ok) return true;
  }
  return false;
}

}  // namespace

extern "C" {

void* idx_build_file(const char* path) {
  std::ifstream in(path);
  if (!in.good()) return nullptr;
  auto* handle = new Handle();
  handle->mem = build(in);
  return handle;
}

void* idx_build_buffer(const char* buf, long n) {
  std::string s(buf, static_cast<size_t>(n));
  std::istringstream in(s);
  auto* handle = new Handle();
  handle->mem = build(in);
  return handle;
}

long idx_num_captions(void* h) {
  auto* handle = static_cast<Handle*>(h);
  if (handle->flat) return static_cast<long>(handle->flat->n_captions);
  return static_cast<long>(handle->mem->caption_tokens.size());
}

namespace {

// binary search a token in the sorted vocab blob; -1 if absent
int64_t flat_find(const FlatIndex& f, const std::string& tok) {
  int64_t lo = 0, hi = f.n_tokens - 1;
  while (lo <= hi) {
    int64_t mid = (lo + hi) / 2;
    const char* s = f.vocab_blob + f.vocab_off[mid];
    size_t len = size_t(f.vocab_off[mid + 1] - f.vocab_off[mid]);
    int c = std::memcmp(s, tok.data(), std::min(len, tok.size()));
    if (c == 0) c = (len < tok.size()) ? -1 : (len > tok.size() ? 1 : 0);
    if (c == 0) return mid;
    if (c < 0) lo = mid + 1; else hi = mid - 1;
  }
  return -1;
}

long flat_query(const FlatIndex& f, const std::vector<std::string>& toks,
                int phrase, long* out, long cap) {
  std::vector<int32_t> tids;
  std::vector<std::pair<const int64_t*, int64_t>> lists;
  for (const auto& t : toks) {
    int64_t pos = flat_find(f, t);
    if (pos < 0) return 0;
    tids.push_back(static_cast<int32_t>(pos));
    lists.emplace_back(f.postings + f.post_off[pos],
                       f.post_off[pos + 1] - f.post_off[pos]);
  }
  std::sort(lists.begin(), lists.end(),
            [](const auto& a, const auto& b) { return a.second < b.second; });
  std::vector<int64_t> result(lists[0].first, lists[0].first + lists[0].second);
  std::vector<int64_t> tmp;
  for (size_t i = 1; i < lists.size() && !result.empty(); ++i) {
    tmp.clear();
    std::set_intersection(result.begin(), result.end(), lists[i].first,
                          lists[i].first + lists[i].second,
                          std::back_inserter(tmp));
    result.swap(tmp);
  }
  long n = 0;
  for (int64_t cid : result) {
    if (phrase && toks.size() > 1) {
      const int32_t* hay = f.cap_tok + f.cap_off[cid];
      int64_t hn = f.cap_off[cid + 1] - f.cap_off[cid];
      bool ok = false;
      for (int64_t i = 0; i + int64_t(tids.size()) <= hn && !ok; ++i) {
        ok = true;
        for (size_t j = 0; j < tids.size(); ++j)
          if (hay[i + j] != tids[j]) { ok = false; break; }
      }
      if (!ok) continue;
    }
    if (n < cap) out[n] = cid;
    ++n;
  }
  return n;
}

}  // namespace

long idx_query(void* h, const char* query, int phrase, long* out, long cap) {
  auto* handle = static_cast<Handle*>(h);
  std::vector<std::string> toks;
  tokenize(normalize(query), &toks);
  if (toks.empty()) return 0;
  if (handle->flat) return flat_query(*handle->flat, toks, phrase, out, cap);
  auto* idx = handle->mem;

  std::vector<int32_t> tids;
  std::vector<const std::vector<int64_t>*> lists;
  for (const auto& t : toks) {
    auto it = idx->vocab.find(t);
    if (it == idx->vocab.end()) return 0;
    tids.push_back(it->second);
    lists.push_back(&idx->postings[it->second]);
  }
  // intersect starting from the rarest list
  std::sort(lists.begin(), lists.end(),
            [](const auto* a, const auto* b) { return a->size() < b->size(); });
  std::vector<int64_t> result(*lists[0]);
  std::vector<int64_t> tmp;
  for (size_t i = 1; i < lists.size() && !result.empty(); ++i) {
    tmp.clear();
    std::set_intersection(result.begin(), result.end(), lists[i]->begin(),
                          lists[i]->end(), std::back_inserter(tmp));
    result.swap(tmp);
  }
  long n = 0;
  for (int64_t cid : result) {
    if (phrase && toks.size() > 1 &&
        !contains_phrase(idx->caption_tokens[cid], tids)) {
      continue;
    }
    if (n < cap) out[n] = cid;
    ++n;
  }
  return n;
}

void idx_free(void* h) {
  auto* handle = static_cast<Handle*>(h);
  delete handle->mem;
  delete handle->flat;
  delete handle;
}

// --- persistence -----------------------------------------------------------
// v2 (current): flat memory-mappable layout, tokens sorted so queries
// binary-search the blob directly — load is one mmap() regardless of size.
// v1 (legacy): length-prefixed vectors + hash rebuild; still readable.

static constexpr uint64_t kMagic = 0x53574154494458ULL;   // v1 "SWATIDX"
static constexpr uint64_t kMagic2 = 0x5357415449445832ULL; // v2 "SWATIDX2"

namespace {

inline uint64_t pad8(uint64_t n) { return (n + 7) & ~uint64_t(7); }

void put_raw(std::ofstream& out, const void* p, size_t n) {
  out.write(reinterpret_cast<const char*>(p), n);
  static const char zeros[8] = {0};
  if (n % 8) out.write(zeros, 8 - n % 8);
}

}  // namespace

long idx_save(void* h, const char* path) {
  auto* handle = static_cast<Handle*>(h);
  if (!handle->mem) return -2;  // mmap'd (v2) handle: read-only, on disk
  auto* idx = handle->mem;
  const int64_t n_cap = int64_t(idx->caption_tokens.size());
  const int64_t n_tok = int64_t(idx->vocab.size());

  // sort tokens; remap old id -> sorted position
  std::vector<const std::string*> by_id(n_tok);
  for (const auto& kv : idx->vocab) by_id[kv.second] = &kv.first;
  std::vector<int32_t> order(n_tok);
  for (int32_t i = 0; i < n_tok; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return *by_id[a] < *by_id[b];
  });
  std::vector<int32_t> remap(n_tok);
  for (int32_t pos = 0; pos < n_tok; ++pos) remap[order[pos]] = pos;

  std::ofstream out(path, std::ios::binary);
  if (!out.good()) return -1;
  auto put64 = [&](int64_t v) { out.write(reinterpret_cast<char*>(&v), 8); };
  put64(int64_t(kMagic2));
  put64(n_cap);
  put64(n_tok);

  // caption token lists (remapped ids), offsets then flat array
  std::vector<int64_t> cap_off(n_cap + 1, 0);
  for (int64_t i = 0; i < n_cap; ++i)
    cap_off[i + 1] = cap_off[i] + int64_t(idx->caption_tokens[i].size());
  put_raw(out, cap_off.data(), cap_off.size() * 8);
  {
    std::vector<int32_t> flat;
    flat.reserve(size_t(cap_off[n_cap]));
    for (const auto& toks : idx->caption_tokens)
      for (int32_t t : toks) flat.push_back(remap[t]);
    put_raw(out, flat.data(), flat.size() * 4);
  }

  // sorted vocab blob
  std::vector<int64_t> voc_off(n_tok + 1, 0);
  for (int64_t i = 0; i < n_tok; ++i)
    voc_off[i + 1] = voc_off[i] + int64_t(by_id[order[i]]->size());
  put_raw(out, voc_off.data(), voc_off.size() * 8);
  {
    std::string blob;
    blob.reserve(size_t(voc_off[n_tok]));
    for (int64_t i = 0; i < n_tok; ++i) blob += *by_id[order[i]];
    put_raw(out, blob.data(), blob.size());
  }

  // postings in sorted-token order
  std::vector<int64_t> post_off(n_tok + 1, 0);
  for (int64_t i = 0; i < n_tok; ++i)
    post_off[i + 1] = post_off[i] + int64_t(idx->postings[order[i]].size());
  put_raw(out, post_off.data(), post_off.size() * 8);
  for (int64_t i = 0; i < n_tok; ++i)
    put_raw(out, idx->postings[order[i]].data(),
            idx->postings[order[i]].size() * 8);
  return out.good() ? 0 : -1;
}

namespace {

void* load_v1(std::ifstream& in) {
  auto get64 = [&]() {
    uint64_t v = 0;
    in.read(reinterpret_cast<char*>(&v), 8);
    return v;
  };
  auto* idx = new Index();
  const uint64_t n_cap = get64();
  const uint64_t n_tok = get64();
  idx->caption_tokens.resize(n_cap);
  for (auto& toks : idx->caption_tokens) {
    toks.resize(get64());
    in.read(reinterpret_cast<char*>(toks.data()),
            toks.size() * sizeof(int32_t));
  }
  idx->postings.resize(n_tok);
  for (uint64_t t = 0; t < n_tok; ++t) {
    std::string s(get64(), '\0');
    in.read(s.data(), s.size());
    idx->vocab.emplace(std::move(s), static_cast<int32_t>(t));
  }
  for (auto& plist : idx->postings) {
    plist.resize(get64());
    in.read(reinterpret_cast<char*>(plist.data()),
            plist.size() * sizeof(int64_t));
  }
  if (!in.good()) {
    delete idx;
    return nullptr;
  }
  auto* handle = new Handle();
  handle->mem = idx;
  return handle;
}

}  // namespace

void* idx_load(const char* path) {
  // peek magic
  uint64_t magic = 0;
  {
    std::ifstream in(path, std::ios::binary);
    if (!in.good()) return nullptr;
    in.read(reinterpret_cast<char*>(&magic), 8);
    if (magic == kMagic) return load_v1(in);
    if (magic != kMagic2) return nullptr;
  }
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* map = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_SHARED, fd, 0);
  close(fd);  // mapping keeps the file alive
  if (map == MAP_FAILED) return nullptr;

  auto* f = new FlatIndex();
  f->map = map;
  f->len = size_t(st.st_size);
  const char* p = static_cast<const char*>(map);
  auto read64 = [&]() { int64_t v; std::memcpy(&v, p, 8); p += 8; return v; };
  read64();  // magic
  f->n_captions = read64();
  f->n_tokens = read64();
  f->cap_off = reinterpret_cast<const int64_t*>(p);
  p += pad8(uint64_t(f->n_captions + 1) * 8);
  f->cap_tok = reinterpret_cast<const int32_t*>(p);
  p += pad8(uint64_t(f->cap_off[f->n_captions]) * 4);
  f->vocab_off = reinterpret_cast<const int64_t*>(p);
  p += pad8(uint64_t(f->n_tokens + 1) * 8);
  f->vocab_blob = p;
  p += pad8(uint64_t(f->vocab_off[f->n_tokens]));
  f->post_off = reinterpret_cast<const int64_t*>(p);
  p += pad8(uint64_t(f->n_tokens + 1) * 8);
  f->postings = reinterpret_cast<const int64_t*>(p);

  auto* handle = new Handle();
  handle->flat = f;
  return handle;
}

}  // extern "C"
