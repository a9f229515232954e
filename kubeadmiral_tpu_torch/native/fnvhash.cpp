// Native hot-path hashing for the host-side control plane.
//
// The schedulers' dedupe gate hashes a canonical JSON trigger per
// federated object every reconcile tick (reference:
// pkg/controllers/scheduler/schedulingtriggers.go:106-148 uses Go's
// hash/fnv), and the replica planner tie-breaks clusters with FNV-1 over
// cluster+key pairs (reference: pkg/controllers/util/planner/
// planner.go:184-198).  At the 100k-object scale those byte loops are
// the control plane's hottest host-side code; this library provides the
// exact Go-compatible bit patterns at native speed, loaded via ctypes
// with a pure-Python fallback (kubeadmiral_tpu_torch/utils/hashing.py).
//
// Built with g++ -O3 -shared -fPIC at first use by native/__init__.py.

#include <cstddef>
#include <cstdint>

namespace {
constexpr uint32_t kOffset = 2166136261u;
constexpr uint32_t kPrime = 16777619u;
}  // namespace

extern "C" {

// FNV-1 32-bit (multiply, then xor) — Go fnv.New32().
uint32_t kadm_fnv32(const uint8_t* data, size_t len) {
  uint32_t h = kOffset;
  for (size_t i = 0; i < len; ++i) {
    h = (h * kPrime) ^ data[i];
  }
  return h;
}

// FNV-1a 32-bit (xor, then multiply) — Go fnv.New32a().
uint32_t kadm_fnv32a(const uint8_t* data, size_t len) {
  uint32_t h = kOffset;
  for (size_t i = 0; i < len; ++i) {
    h = (h ^ data[i]) * kPrime;
  }
  return h;
}

// FNV-1 of prefixes[i] + suffix for n prefixes packed back to back in
// buf; offsets has n+1 entries delimiting each prefix.
void kadm_fnv32_batch(const uint8_t* buf, const uint64_t* offsets, size_t n,
                      const uint8_t* suffix, size_t suffix_len,
                      uint32_t* out) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t h = kOffset;
    for (uint64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
      h = (h * kPrime) ^ buf[j];
    }
    for (size_t j = 0; j < suffix_len; ++j) {
      h = (h * kPrime) ^ suffix[j];
    }
    out[i] = h;
  }
}

// Continue n FNV-1 states over the same extra bytes (streaming property:
// fnv32(a+b) == extend(fnv32(a), b)); states are updated in place.
void kadm_fnv32_extend_batch(uint32_t* states, size_t n, const uint8_t* data,
                             size_t len) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t h = states[i];
    for (size_t j = 0; j < len; ++j) {
      h = (h * kPrime) ^ data[j];
    }
    states[i] = h;
  }
}

}  // extern "C"
