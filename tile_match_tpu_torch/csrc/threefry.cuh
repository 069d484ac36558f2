// JAX's partitionable threefry-2x32, per cell: the refill colours of the
// cascades, equal bit for bit to tile_match_tpu_torch/random.py (and to
// jax.random with jax_threefry_partitionable on).
#pragma once

#include "block.cuh"

namespace tmt {

TMT_DEV uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// Threefry-2x32, 20 rounds, JAX's key schedule; (x0, x1) in and out.
TMT_DEV void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// JAX's randint multiplier for span K: (2^16 mod K)^2 mod K.
TMT_HOST_DEV uint32_t randint_mult(uint32_t K) {
  const uint32_t m = 65536u % K;
  return (m * m) % K;
}

// The refill draw of one trip: jax.random.randint(fold_in(sub, t), (R, C),
// 1, K + 1).  The folded key and its two halves are the same for every cell
// of the trip, so they are hashed once (three hashes); each cell then takes
// two more, at its own flat index.  (The combination branch draws
// randint(kd, (R, C), 1, K + 1) with kd its own key's split: the halves of
// split(kd).)
struct RefillKeys {
  uint32_t a0, a1, b0, b1;
};

// jax.random.split(key) (tile_match_tpu_torch/random.py `split`): key
// (k0, k1) gives the two keys (a0, a1) and (b0, b1), word for word.
TMT_DEV RefillKeys split(uint32_t k0, uint32_t k1) {
  RefillKeys k;
  k.a0 = 0;
  k.a1 = 0;
  threefry2x32(k0, k1, k.a0, k.a1);  // first key
  k.b0 = 0;
  k.b1 = 1;
  threefry2x32(k0, k1, k.b0, k.b1);  // second key
  return k;
}

TMT_DEV RefillKeys refill_keys(uint32_t s0, uint32_t s1, uint32_t t) {
  uint32_t f0 = 0, f1 = t;
  threefry2x32(s0, s1, f0, f1);  // fold_in
  return split(f0, f1);
}

// 32 bits of the draw with key (k0, k1) at the cell's counter.
TMT_DEV uint32_t draw_word(uint32_t k0, uint32_t k1, uint32_t cell) {
  uint32_t x0 = 0, x1 = cell;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// jax.random.randint's offset in [0, K) from the words of the two keys: JAX's
// unsigned double-width remainder, every product wrapped to 32 bits.
TMT_DEV uint32_t randint_offset(uint32_t hi, uint32_t lo, uint32_t K, uint32_t mult) {
  return ((hi % K) * mult + lo % K) % K;
}

// A colour in 1..K from the words of the two keys.
TMT_DEV int colour_from(uint32_t hi, uint32_t lo, uint32_t K, uint32_t mult) {
  return 1 + static_cast<int>(randint_offset(hi, lo, K, mult));
}

// Colour of flat cell `cell`.
TMT_DEV int refill_colour(const RefillKeys& k, uint32_t cell, uint32_t K, uint32_t mult) {
  return colour_from(draw_word(k.a0, k.a1, cell), draw_word(k.b0, k.b1, cell), K, mult);
}

}  // namespace tmt
