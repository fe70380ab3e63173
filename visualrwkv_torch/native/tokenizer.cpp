// Fast byte-trie tokenizer (greedy longest match) for the host data path.
//
// The RWKV World tokenizer is the hot host-side loop of dataset preprocessing
// (reference keeps it in pure Python, tokenizer/rwkv_tokenizer.py). This is a
// from-scratch C++ trie with a C ABI consumed via ctypes
// (visualrwkv_torch/native/fast_tokenizer.py).
//
// The vocab is loaded from a binary sidecar written by the Python tokenizer:
//   repeated records: int32 id, int32 len, len raw bytes.
//
// Build: g++ -O3 -shared -fPIC tokenizer.cpp -o libworldtok.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Node {
  std::unordered_map<uint8_t, int32_t> children;
  int32_t token_id = -1;  // -1: not a token end
};

struct Trie {
  std::vector<Node> nodes;
  std::vector<std::string> id_to_token;

  Trie() { nodes.emplace_back(); }

  void insert(const uint8_t* bytes, int32_t len, int32_t id) {
    int32_t cur = 0;
    for (int32_t i = 0; i < len; ++i) {
      auto it = nodes[cur].children.find(bytes[i]);
      if (it == nodes[cur].children.end()) {
        nodes[cur].children.emplace(bytes[i], (int32_t)nodes.size());
        cur = (int32_t)nodes.size();
        nodes.emplace_back();
      } else {
        cur = it->second;
      }
    }
    nodes[cur].token_id = id;
  }
};

}  // namespace

extern "C" {

void* tok_create(const char* binary_vocab_path) {
  FILE* f = fopen(binary_vocab_path, "rb");
  if (!f) return nullptr;
  Trie* trie = new Trie();
  int32_t max_id = 0;
  std::vector<std::pair<int32_t, std::string>> entries;
  for (;;) {
    int32_t id = 0, len = 0;
    if (fread(&id, 4, 1, f) != 1) break;
    if (fread(&len, 4, 1, f) != 1 || len < 0 || len > 1 << 20) {
      fclose(f);
      delete trie;
      return nullptr;
    }
    std::string tok(len, '\0');
    if (len && fread(&tok[0], 1, len, f) != (size_t)len) {
      fclose(f);
      delete trie;
      return nullptr;
    }
    trie->insert(reinterpret_cast<const uint8_t*>(tok.data()), len, id);
    if (id > max_id) max_id = id;
    entries.emplace_back(id, std::move(tok));
  }
  fclose(f);
  trie->id_to_token.resize(max_id + 1);
  for (auto& e : entries) trie->id_to_token[e.first] = e.second;
  return trie;
}

void tok_destroy(void* handle) { delete static_cast<Trie*>(handle); }

// Greedy longest-match encode. Returns number of tokens written, or -1 if
// out_capacity was insufficient, or -2 on an unencodable byte.
int32_t tok_encode(void* handle, const uint8_t* text, int32_t n,
                   int32_t* out, int32_t out_capacity) {
  const Trie* trie = static_cast<const Trie*>(handle);
  int32_t count = 0;
  int32_t i = 0;
  while (i < n) {
    int32_t cur = 0;
    int32_t best_id = -1;
    int32_t best_end = i;
    for (int32_t j = i; j < n; ++j) {
      const auto& children = trie->nodes[cur].children;
      auto it = children.find(text[j]);
      if (it == children.end()) break;
      cur = it->second;
      if (trie->nodes[cur].token_id >= 0) {
        best_id = trie->nodes[cur].token_id;
        best_end = j + 1;
      }
    }
    if (best_id < 0) return -2;
    if (count >= out_capacity) return -1;
    out[count++] = best_id;
    i = best_end;
  }
  return count;
}

// Decode ids into the output buffer; returns bytes written or -1 if the
// buffer is too small, -2 on an unknown id.
int32_t tok_decode(void* handle, const int32_t* ids, int32_t n,
                   uint8_t* out, int32_t out_capacity) {
  const Trie* trie = static_cast<const Trie*>(handle);
  int32_t written = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t id = ids[i];
    if (id < 0 || id >= (int32_t)trie->id_to_token.size()) return -2;
    const std::string& tok = trie->id_to_token[id];
    if (written + (int32_t)tok.size() > out_capacity) return -1;
    memcpy(out + written, tok.data(), tok.size());
    written += (int32_t)tok.size();
  }
  return written;
}

}  // extern "C"
