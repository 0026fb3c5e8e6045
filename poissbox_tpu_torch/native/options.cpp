// Native runtime-options database of the PyTorch port: the PETSc
// options-DB C-layer counterpart, a copy of the JAX package's with the
// same semantics.
//
// The reference's entire configuration system is PETSc's native string-keyed
// options database (reference src/poissbox.f90:201,223,231,235,295;
// README.md:42-49). This is an insertion-ordered string store with
// PETSc-style CLI parsing (`-key value`, `-key=value`, value-less boolean
// flags, negative numbers as values). Exposed through a C ABI for ctypes;
// parse semantics are held to the Python implementation
// (poissbox_tpu_torch/config.py) by tests/test_torch_native.py.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct OptionsDb {
  std::vector<std::pair<std::string, std::string>> entries;

  int find(const std::string& key) const {
    for (size_t i = 0; i < entries.size(); ++i)
      if (entries[i].first == key) return int(i);
    return -1;
  }

  void set(const std::string& key, const std::string& val) {
    int i = find(key);
    if (i >= 0)
      entries[size_t(i)].second = val;
    else
      entries.emplace_back(key, val);
  }
};

std::string strip_dashes(const char* tok) {
  const char* p = tok;
  while (*p == '-') ++p;
  return std::string(p);
}

// A token starting with '-' is a flag unless it parses as a number
// (so `-ksp_shift -1.5e-3` works) — config.py `_looks_like_flag`.
bool looks_like_flag(const char* tok) {
  if (tok[0] != '-' || tok[1] == '\0') return false;
  char* end = nullptr;
  std::strtod(tok, &end);
  return !(end && *end == '\0');
}

}  // namespace

extern "C" {

void* pb_options_create() { return new OptionsDb(); }

void pb_options_destroy(void* db) { delete static_cast<OptionsDb*>(db); }

// Parse argv PETSc-style. Value-less boolean flags are stored as "\x01true"
// (a marker no CLI string can produce); stray positionals are ignored.
int pb_options_parse(void* dbp, int64_t argc, const char** argv) {
  if (!dbp) return -1;
  auto* db = static_cast<OptionsDb*>(dbp);
  int64_t i = 0;
  while (i < argc) {
    const char* tok = argv[i];
    if (!looks_like_flag(tok)) {
      ++i;
      continue;
    }
    std::string key = strip_dashes(tok);
    size_t eq = key.find('=');
    if (eq != std::string::npos) {
      db->set(key.substr(0, eq), key.substr(eq + 1));
      ++i;
    } else if (i + 1 < argc && !looks_like_flag(argv[i + 1])) {
      db->set(key, argv[i + 1]);
      i += 2;
    } else {
      db->set(key, "\x01true");
      ++i;
    }
  }
  return 0;
}

int pb_options_set(void* dbp, const char* key, const char* val) {
  if (!dbp || !key || !val) return -1;
  static_cast<OptionsDb*>(dbp)->set(strip_dashes(key), val);
  return 0;
}

int pb_options_has(void* dbp, const char* key) {
  if (!dbp || !key) return 0;
  return static_cast<OptionsDb*>(dbp)->find(strip_dashes(key)) >= 0;
}

// Copy the value for `key` into buf (NUL-terminated). Returns the value
// length, or -1 if absent. If buflen is too small nothing is copied (call
// again with a larger buffer).
int64_t pb_options_get(void* dbp, const char* key, char* buf, int64_t buflen) {
  if (!dbp || !key) return -1;
  auto* db = static_cast<OptionsDb*>(dbp);
  int i = db->find(strip_dashes(key));
  if (i < 0) return -1;
  const std::string& v = db->entries[size_t(i)].second;
  int64_t need = int64_t(v.size());
  if (buf && buflen > need) {
    std::memcpy(buf, v.data(), size_t(need));
    buf[need] = '\0';
  }
  return need;
}

int64_t pb_options_count(void* dbp) {
  return dbp ? int64_t(static_cast<OptionsDb*>(dbp)->entries.size()) : -1;
}

// Key at index `i` (insertion order), same copy semantics as
// pb_options_get.
int64_t pb_options_key_at(void* dbp, int64_t i, char* buf, int64_t buflen) {
  if (!dbp) return -1;
  auto* db = static_cast<OptionsDb*>(dbp);
  if (i < 0 || size_t(i) >= db->entries.size()) return -1;
  const std::string& k = db->entries[size_t(i)].first;
  int64_t need = int64_t(k.size());
  if (buf && buflen > need) {
    std::memcpy(buf, k.data(), size_t(need));
    buf[need] = '\0';
  }
  return need;
}

}  // extern "C"
