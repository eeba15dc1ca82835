// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), written out by hand: the counter-based generator of the fused
// plant kernel. A 128-bit counter and a 64-bit key give four 32-bit words;
// the stream depends on the counter and the key alone, never on the launch
// grid, so ops/fused_plant.py::philox_words reproduces it in integer tensor
// arithmetic.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace wt {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;  // golden ratio
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;  // sqrt(3) - 1

// out = Philox4x32-10(counter (c0, c1, c2, c3), key (k0, k1)).
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// The 76 words one plant's instruments consume in step ``step``: nineteen
// blocks with counter (step, plant, block, 0) under the key ``seed``.
constexpr int kWordsPerStep = 76;
constexpr int kPhiloxBlocksPerStep = kWordsPerStep / 4;

__device__ __forceinline__ void plant_step_words(unsigned long long seed,
                                                 uint32_t step,
                                                 uint32_t plant,
                                                 uint32_t words[kWordsPerStep]) {
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll 1
  for (int block = 0; block < kPhiloxBlocksPerStep; ++block) {
    philox4x32_10(step, plant, static_cast<uint32_t>(block), 0u, k0, k1,
                  words + 4 * block);
  }
}

// The words of one sensor in step ``step``: the sensor's words are
// ``n_words`` (at most 11) consecutive words of the plant's 76, which lie in
// ``n_blocks`` (at most 4) consecutive blocks from ``block`` on, starting
// ``skip`` words into the first. Only those blocks are generated, with the
// counters plant_step_words gives them, and the words are shifted down by
// ``skip`` with selects so that they stay in registers: ``out[k]`` is word
// ``4 * block + skip + k`` of the plant's step (k < n_words; the rest are
// left unspecified).
constexpr int kMaxSensorWords = 11;
constexpr int kMaxSensorBlocks = 4;

__device__ __forceinline__ void sensor_step_words(
    unsigned long long seed, uint32_t step, uint32_t plant, int block,
    int n_blocks, int skip, uint32_t out[kMaxSensorWords]) {
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  uint32_t raw[4 * kMaxSensorBlocks] = {};
#pragma unroll
  for (int j = 0; j < kMaxSensorBlocks; ++j) {
    if (j < n_blocks) {
      philox4x32_10(step, plant, static_cast<uint32_t>(block + j), 0u, k0,
                    k1, raw + 4 * j);
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxSensorWords; ++k) {
    out[k] = skip == 0   ? raw[k]
             : skip == 1 ? raw[k + 1]
             : skip == 2 ? raw[k + 2]
                         : raw[k + 3];
  }
}

}  // namespace wt
