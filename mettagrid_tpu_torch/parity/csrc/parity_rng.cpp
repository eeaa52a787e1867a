// Bit-exact reference RNG for episode-signature parity.
//
// The reference engine uses a single std::mt19937 for agent-order shuffles,
// event max_targets shuffles, and query order_by=random
// (cpp/bindings/mettagrid_c.cpp:51-52,960; src/.../handler/event.cpp:43;
// core/query_system.cpp:79). Reproducing its exact draw sequence requires
// libstdc++'s std::shuffle + std::uniform_int_distribution semantics, so
// this module wraps them directly — compiled with the same toolchain, the
// sequences are identical by construction.
//
// C ABI (ctypes-friendly):
//   void* mt_new(uint32_t seed);
//   void  mt_free(void* rng);
//   uint32_t mt_next(void* rng);
//   uint64_t mt_uniform_int(void* rng, uint64_t a, uint64_t b);  // inclusive
//   void  mt_shuffle(void* rng, int64_t* data, int64_t n);       // std::shuffle
//   void  mt_skip(void* rng, uint64_t n);

#include <algorithm>
#include <cstdint>
#include <random>

extern "C" {

void* mt_new(uint32_t seed) {
  return new std::mt19937(seed);
}

void mt_free(void* rng) {
  delete static_cast<std::mt19937*>(rng);
}

uint32_t mt_next(void* rng) {
  return (*static_cast<std::mt19937*>(rng))();
}

uint64_t mt_uniform_int(void* rng, uint64_t a, uint64_t b) {
  std::uniform_int_distribution<uint64_t> dist(a, b);
  return dist(*static_cast<std::mt19937*>(rng));
}

void mt_shuffle(void* rng, int64_t* data, int64_t n) {
  std::shuffle(data, data + n, *static_cast<std::mt19937*>(rng));
}

void mt_skip(void* rng, uint64_t n) {
  auto* g = static_cast<std::mt19937*>(rng);
  g->discard(n);
}

}  // extern "C"
