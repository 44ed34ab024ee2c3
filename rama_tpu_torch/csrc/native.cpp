// rama_tpu_torch's native host library: the port's own copy of
// native/rama_native.cpp (same C interface, same results), built by
// rama_tpu_torch/native.py with the host C++ compiler and loaded through
// ctypes. Three host-side parts of the serving and loading paths:
//
//   1. BPE encode — the reference's merge loop rescans every pair per merge
//      (O(n^2), bpe.rs:61-94). This one keeps the same greedy
//      best-score-first semantics with a max-heap over candidate merges and
//      a doubly-linked token list: O(n log n). Ties break on the leftmost
//      position, matching the reference's first-strictly-greater scan. It
//      trims only " \t\r\n" and reads the text up to its first NUL byte
//      (the Python encoder trims every Unicode space and reads it all:
//      ROADMAP.md section 3).
//   2. Batched blocked transpose — checkpoint load converts (out, in)
//      row-major tensors to the (in, out) compute layout; for a 7B this is
//      the dominant load cost in Python. Blocked + threaded here.
//   3. Paged KV page allocator — free stack of fixed-size cache pages with
//      per-slot page tables (the engine's page tables; the plain version is
//      runtime/paged.py's PageAllocator).
//
// A plain C ABI consumed via ctypes: no PyTorch headers, no CUDA.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. BPE tokenizer
// ---------------------------------------------------------------------------

struct Tokenizer {
  std::vector<std::string> vocab;
  std::vector<float> scores;
  std::unordered_map<std::string, int32_t> lookup;
  uint32_t max_token_length = 0;
};

// Parse llama2.c tokenizer.bin: u32 max_token_len, then vocab_size records
// of (f32 score, i32 len, bytes). First id wins on duplicate strings is NOT
// the rust behavior — its HashMap insert overwrites, so LAST id wins there;
// but encode() only ever looks up merged strings whose ids resolve the same
// way because scores drive selection. We match the reference: last id wins.
Tokenizer* tokenizer_create(const char* path, int32_t vocab_size) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* t = new Tokenizer();
  if (fread(&t->max_token_length, 4, 1, f) != 1) { fclose(f); delete t; return nullptr; }
  t->vocab.reserve(vocab_size);
  t->scores.reserve(vocab_size);
  for (int32_t i = 0; i < vocab_size; i++) {
    float score; int32_t len;
    if (fread(&score, 4, 1, f) != 1 || fread(&len, 4, 1, f) != 1 || len < 0) {
      fclose(f); delete t; return nullptr;
    }
    std::string s(len, '\0');
    if (len && fread(s.data(), 1, len, f) != (size_t)len) { fclose(f); delete t; return nullptr; }
    t->vocab.push_back(s);
    t->scores.push_back(score);
    t->lookup[s] = i;
  }
  fclose(f);
  return t;
}

void tokenizer_free(Tokenizer* t) { delete t; }

// Greedy best-score merge, identical result to bpe.rs:50-96.
// Returns the number of tokens written to out (capacity out_cap), or -1 if
// an input character is out-of-vocabulary (strict=1), skipping it otherwise.
int32_t tokenizer_encode(Tokenizer* t, const char* utf8, int32_t strict,
                         int32_t* out, int32_t out_cap) {
  // 1. trim whitespace, drop '\n', map utf-8 characters to ids
  std::string s(utf8);
  size_t b = s.find_first_not_of(" \t\r\n");
  size_t e = s.find_last_not_of(" \t\r\n");
  if (b == std::string::npos) return 0;
  s = s.substr(b, e - b + 1);

  std::vector<int32_t> ids;
  for (size_t i = 0; i < s.size();) {
    unsigned char c = s[i];
    size_t n = c < 0x80 ? 1 : (c >> 5) == 0x6 ? 2 : (c >> 4) == 0xE ? 3 : 4;
    std::string ch = s.substr(i, n);
    i += n;
    if (ch == "\n") continue;
    auto it = t->lookup.find(ch);
    if (it == t->lookup.end()) {
      if (strict) return -1;
      continue;
    }
    ids.push_back(it->second);
  }

  // 2. linked list over tokens + max-heap of candidate merges
  size_t n = ids.size();
  std::vector<int32_t> prev(n), next(n);
  std::vector<char> alive(n, 1);
  for (size_t i = 0; i < n; i++) { prev[i] = (int32_t)i - 1; next[i] = (int32_t)i + 1; }
  if (n) next[n - 1] = -1;

  struct Cand { float score; int32_t pos; int32_t id; int32_t left_tok; int32_t right_tok; };
  struct Cmp {
    bool operator()(const Cand& a, const Cand& b) const {
      if (a.score != b.score) return a.score < b.score;   // max score first
      return a.pos > b.pos;                               // then leftmost
    }
  };
  std::priority_queue<Cand, std::vector<Cand>, Cmp> heap;

  auto push_pair = [&](int32_t i) {
    int32_t j = next[i];
    if (i < 0 || j < 0) return;
    const std::string merged = t->vocab[ids[i]] + t->vocab[ids[j]];
    auto it = t->lookup.find(merged);
    if (it != t->lookup.end())
      heap.push({t->scores[it->second], i, it->second, ids[i], ids[j]});
  };
  for (size_t i = 0; i + 1 < n; i++) push_pair((int32_t)i);

  while (!heap.empty()) {
    Cand c = heap.top(); heap.pop();
    int32_t i = c.pos, j = next[i];
    // stale if either side merged away or token values changed
    if (!alive[i] || j < 0 || !alive[j] || ids[i] != c.left_tok || ids[j] != c.right_tok)
      continue;
    ids[i] = c.id;          // merge into the left slot (bpe.rs:92-93)
    alive[j] = 0;
    next[i] = next[j];
    if (next[j] >= 0) prev[next[j]] = i;
    push_pair(prev[i] >= 0 ? prev[i] : -1);
    push_pair(i);
  }

  int32_t count = 0;
  for (int32_t i = 0; i >= 0 && i < (int32_t)n; i = next[i]) {
    if (!alive[i]) continue;
    if (count < out_cap) out[count] = ids[i];
    count++;
  }
  return count;
}

}  // extern "C" (templates below must have C++ linkage)

// ---------------------------------------------------------------------------
// 2. Batched blocked transpose: (L, R, C) -> (L, C, R), threaded over L/tiles
// ---------------------------------------------------------------------------

template <typename T>
static void transpose_one(const T* src, T* dst, int64_t r, int64_t c) {
  constexpr int64_t B = 64;
  for (int64_t i0 = 0; i0 < r; i0 += B)
    for (int64_t j0 = 0; j0 < c; j0 += B) {
      int64_t imax = std::min(i0 + B, r), jmax = std::min(j0 + B, c);
      for (int64_t i = i0; i < imax; i++)
        for (int64_t j = j0; j < jmax; j++)
          dst[j * r + i] = src[i * c + j];
    }
}

template <typename T>
static void transpose_batched(const T* src, T* dst, int64_t l, int64_t r, int64_t c,
                              int32_t n_threads) {
  std::atomic<int64_t> counter{0};
  auto worker = [&]() {
    int64_t k;
    while ((k = counter.fetch_add(1)) < l)
      transpose_one(src + k * r * c, dst + k * r * c, r, c);
  };
  std::vector<std::thread> ts;
  int32_t nt = std::max(1, n_threads);
  for (int32_t i = 0; i < nt; i++) ts.emplace_back(worker);
  for (auto& th : ts) th.join();
}

extern "C" {

void transpose_f32(const float* src, float* dst, int64_t l, int64_t r, int64_t c,
                   int32_t n_threads) {
  transpose_batched(src, dst, l, r, c, n_threads);
}

void transpose_i8(const int8_t* src, int8_t* dst, int64_t l, int64_t r, int64_t c,
                  int32_t n_threads) {
  transpose_batched(src, dst, l, r, c, n_threads);
}

// ---------------------------------------------------------------------------
// 3. Paged KV block allocator
// ---------------------------------------------------------------------------

struct PageAllocator {
  int32_t num_pages;
  int32_t page_size;
  std::vector<int32_t> free_list;       // stack of free page ids
  std::vector<std::vector<int32_t>> tables;  // per-slot page tables
};

PageAllocator* pages_create(int32_t num_pages, int32_t page_size, int32_t max_slots) {
  auto* a = new PageAllocator();
  a->num_pages = num_pages;
  a->page_size = page_size;
  a->free_list.reserve(num_pages);
  for (int32_t i = num_pages - 1; i >= 0; i--) a->free_list.push_back(i);
  a->tables.resize(max_slots);
  return a;
}

void pages_free(PageAllocator* a) { delete a; }

int32_t pages_available(PageAllocator* a) { return (int32_t)a->free_list.size(); }

// Grow slot `slot` to cover at least `seq_len` positions.
// Returns the new page count, or -1 if out of pages (nothing changes).
int32_t pages_reserve(PageAllocator* a, int32_t slot, int32_t seq_len) {
  auto& table = a->tables[slot];
  int32_t need = (seq_len + a->page_size - 1) / a->page_size;
  int32_t have = (int32_t)table.size();
  if (need <= have) return have;
  if ((int32_t)a->free_list.size() < need - have) return -1;
  for (int32_t i = have; i < need; i++) {
    table.push_back(a->free_list.back());
    a->free_list.pop_back();
  }
  return need;
}

// Release all pages of a slot (request finished).
void pages_release(PageAllocator* a, int32_t slot) {
  auto& table = a->tables[slot];
  for (int32_t p : table) a->free_list.push_back(p);
  table.clear();
}

// Copy the slot's page table into out (capacity cap); returns count.
int32_t pages_table(PageAllocator* a, int32_t slot, int32_t* out, int32_t cap) {
  auto& table = a->tables[slot];
  int32_t n = (int32_t)table.size();
  for (int32_t i = 0; i < std::min(n, cap); i++) out[i] = table[i];
  return n;
}

}  // extern "C"
