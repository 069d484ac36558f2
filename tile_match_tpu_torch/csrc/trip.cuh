// The phases a cascade trip of K1 (cascade.cu) and K2 (cascade_sp.cu) share,
// written on the executors of block.cuh: line detection and the union of
// the detected lines from row and column bit masks, stable gravity and the
// threefry refill.
//
// Detection follows `_union_mask_tile` of tile_match_tpu/ops/
// pallas_cascade.py: run lengths of every cell, the lowest row anchoring a
// line, the primary cells (horizontal runs in that row, vertical runs whose
// bottom cell is in it), the extension chains through them (same colour,
// not primary) and the candidates (a primary cell whose chain is >= 3
// long); the union is the primary cells and every cell a candidate's chain
// covers.  Every length is a count of set bits: a run of one colour along a
// row is a run of set bits of `eh` ("same colour as the right neighbour")
// in row-major order, along a column one of `ev` in column-major order; the
// zero bit at the end of every row or column stops each count there.
#pragma once

#include "block.cuh"
#include "threefry.cuh"

namespace tmt {

// A 16-byte aligned carve of shared memory; with a null base it only counts.
struct Arena {
  unsigned char* base;
  size_t used;
  template <class T>
  TMT_HOST_DEV T* take(size_t count) {
    const size_t off = (used + 15) & ~static_cast<size_t>(15);
    used = off + count * sizeof(T);
    return base ? reinterpret_cast<T*>(base + off) : nullptr;
  }
};

// The board's geometry and the masks of one trip's detection (each
// mask_words(n) words), and the run lengths they give.  Row-major index
// i = r * C + c; column-major j = c * R + r.
//
// With kR and kC > 0 the board is R = kR by C = kC, fixed at compile time:
// index arithmetic is by constants, and a board of at most 32 by 32 takes
// the one-window bit helpers.  With kR = kC = 0, R and C are run-time values
// and a row or column index is a multiply-high by a reciprocal (`div_by`).
template <int kR, int kC>
struct Lines {
  static constexpr bool kFixed = kR > 0 && kC > 0;
  static constexpr bool kNarrow = kFixed && kR <= 32 && kC <= 32;
  int R_, C_;
  uint32_t inv_r, inv_c;  // reciprocal(R), reciprocal(C)
  uint32_t *eh, *ev;  // same colour (> 0) as the right neighbour (rm) / the one below (cm)
  uint32_t *t3;       // first cells of horizontal runs of 3 (rm)
  uint32_t *vb;       // bottoms of vertical runs of 3 or more (cm)
  uint32_t *mh, *mv, *p;     // members of a horizontal / vertical primary line, primary (rm)
  uint32_t *pc;              // primary (cm)
  uint32_t *el, *er;         // extension chain bits, leftwards / rightwards (rm)
  uint32_t *elv, *erv;       // the same upwards / downwards (cm)
  uint32_t *ch, *cv, *cvc;   // horizontal / vertical candidates (rm), vertical candidates (cm)

  // the geometry alone (a board program that detects no lines)
  TMT_HOST_DEV void shape(int R, int C) {
    R_ = R;
    C_ = C;
    inv_r = reciprocal(R);
    inv_c = reciprocal(C);
  }
  TMT_HOST_DEV void carve(Arena& a, int R, int C) {
    shape(R, C);
    const int w = mask_words(R * C);
    uint32_t** m[15] = {&eh, &ev, &t3, &vb, &mh, &mv, &p, &pc, &el, &er, &elv, &erv, &ch, &cv, &cvc};
    for (int q = 0; q < 15; ++q) *m[q] = a.take<uint32_t>(w);
  }
  TMT_DEV int R() const { return kFixed ? kR : R_; }
  TMT_DEV int C() const { return kFixed ? kC : C_; }
  TMT_DEV int n() const { return R() * C(); }
  TMT_DEV int row(int i) const { return kFixed ? i / kC : div_by(i, C_, inv_c); }
  TMT_DEV int col(int i) const { return kFixed ? i % kC : i - row(i) * C_; }
  TMT_DEV int cm(int i) const {
    const int r = row(i);
    return (i - r * C()) * R() + r;
  }
  TMT_DEV int rm(int j) const {
    const int c = kFixed ? j / kR : div_by(j, R_, inv_r);
    return (j - c * R()) * C() + c;
  }

  // bit helpers: within one row or one column
  TMT_DEV int up(const uint32_t* m, int q) const { return kNarrow ? ones_up32(m, q) : ones_up(m, q); }
  TMT_DEV int down(const uint32_t* m, int q) const {
    return kNarrow ? ones_down32(m, q) : ones_down(m, q);
  }
  TMT_DEV int popc(const uint32_t* a, int lo, int hi) const {
    return kNarrow ? tmt::popc(range32(a, lo, hi)) : range_popc(a, lo, hi);
  }
  TMT_DEV bool any(const uint32_t* a, int lo, int hi, const uint32_t* b = nullptr) const {
    if (kNarrow) return (range32(a, lo, hi) & (b ? range32(b, lo, hi) : ~0u)) != 0;
    return range_any(a, lo, hi, b);
  }
  TMT_DEV int first(const uint32_t* a, int lo, int hi) const {
    if (kNarrow) {
      const uint32_t v = range32(a, lo, hi);
      return v ? lo + ctz(v) : -1;
    }
    return range_first(a, lo, hi);
  }

  // colour-run cells left, right, above and below of cell i
  TMT_DEV int lc(int i) const { return down(eh, i - 1); }
  TMT_DEV int rc(int i) const { return up(eh, i); }
  TMT_DEV int uc(int i) const { return down(ev, cm(i) - 1); }
  TMT_DEV int dc(int i) const { return up(ev, cm(i)); }
  TMT_DEV int hl(int i) const { return lc(i) + rc(i) + 1; }
  TMT_DEV int vl(int i) const { return uc(i) + dc(i) + 1; }
  // extension-chain cells on each side of cell i
  TMT_DEV int le(int i) const { return down(el, i - 1); }
  TMT_DEV int re(int i) const { return up(er, i); }
  TMT_DEV int ue(int i) const { return down(elv, cm(i) - 1); }
  TMT_DEV int de(int i) const { return up(erv, cm(i)); }
  TMT_DEV int hext(int i) const { return 1 + le(i) + re(i); }
  TMT_DEV int vext(int i) const { return 1 + ue(i) + de(i); }

  // Is cell i covered by a horizontal / vertical candidate's chain?  A
  // primary cell only by its own; any other cell by the candidate at the
  // far end of its own chain, if that candidate continues the colour.
  TMT_DEV void cover(const int* x, int i, bool& cov_h, bool& cov_v) const {
    if (bit(p, i)) {
      cov_h = bit(ch, i);
      cov_v = bit(cv, i);
      return;
    }
    cov_h = cov_v = false;
    if (x[i] <= 0) return;
    const int r = row(i), c = col(i), j = cm(i);
    if (any(ch, i - c, i - c + C())) {  // a candidate in the row
      const int l = le(i), rr = re(i);
      cov_h = (l < c && bit(eh, i - l - 1) && bit(ch, i - l - 1)) ||
              (c + rr + 1 < C() && bit(eh, i + rr) && bit(ch, i + rr + 1));
    }
    if (any(cvc, j - r, j - r + R())) {  // a candidate in the column
      const int u = down(elv, j - 1), d = up(erv, j);
      cov_v = (u < r && bit(ev, j - u - 1) && bit(cvc, j - u - 1)) ||
              (r + d + 1 < R() && bit(ev, j + d) && bit(cvc, j + d + 1));
    }
  }
};

// The geometry a kernel library runs: one board shape fixed at compile time
// when it is built with TMT_ROWS and TMT_COLS (the build makes one library
// for each board shape of at most 32 by 32 that runs), and every shape at
// run time otherwise.
#if defined(TMT_ROWS) && defined(TMT_COLS)
using Geometry = Lines<TMT_ROWS, TMT_COLS>;
#else
using Geometry = Lines<0, 0>;
#endif

// Does the library's geometry take an R x C board?
TMT_HOST_DEV bool takes(int R, int C) {
#if defined(TMT_ROWS) && defined(TMT_COLS)
  return R == TMT_ROWS && C == TMT_COLS;
#else
  return R >= 1 && C >= 1;
#endif
}

TMT_HOST_DEV int max_int(int a, int b) { return a > b ? a : b; }

// bits 32 q + 1 .. 32 q + 32 of mask m: each bit's next neighbour
TMT_DEV uint32_t next_bits(const uint32_t* m, int q) { return (m[q] >> 1) | (m[q + 1] << 31); }

// Builds eh, ev, t3 and vb for the board x; returns the lowest row that
// anchors a line (a horizontal run of 3 or more, or the bottom of a vertical
// one), -1 if the board holds no >= 3 run.  A triple is two neighbouring set
// bits of eh (ev): every row and column ends in a clear bit.
template <class W, class Ln>
TMT_DEV int line_masks(const W& w, const Ln& L, const int* x) {
  const int R = L.R(), C = L.C(), n = L.n(), nw = mask_words(n);
  uint32_t* const m[2] = {L.eh, L.ev};
  w.ballots(n, m, [&](int q) {  // q: cell q (eh), column-major index q (ev)
    const int i = L.rm(q);
    return (x[q] > 0 && L.col(q) + 1 < C && x[q + 1] == x[q] ? 1 : 0) |
           (x[i] > 0 && L.row(i) + 1 < R && x[i + C] == x[i] ? 2 : 0);
  });
  int lowest = -1;
  w.each_of(nw, [&](int q) {
    const bool pad = q + 1 == nw;
    const uint32_t e = L.ev[q], e1 = q > 0 ? L.ev[q - 1] : 0u;
    const uint32_t t = pad ? 0u : L.eh[q] & next_bits(L.eh, q);
    // no same colour below, and the two above the same
    const uint32_t b = pad ? 0u : ~e & ((e << 1) | (e1 >> 31)) & ((e << 2) | (e1 >> 30));
    L.t3[q] = t;
    L.vb[q] = b;
    if (t) lowest = ::tmt::max_int(lowest, L.row(32 * q + 31 - clz(t)));
    for (uint32_t v = b; v; v &= v - 1) lowest = ::tmt::max_int(lowest, L.row(L.rm(32 * q + ctz(v))));
  });
  return w.lanes_max(lowest);
}

// Builds the other masks of L from those of line_masks, whose lowest
// anchoring row is sr0.
template <class W, class Ln>
TMT_DEV void detect(const W& w, const Ln& L, int sr0) {
  const int R = L.R(), n = L.n(), nw = mask_words(n);
  // primary: the horizontal runs of row sr0, the vertical runs whose
  // bottom is in row sr0
  auto member = [&](int i, bool& mh, bool& mv) {
    const int r = L.row(i), j0 = L.col(i) * R + sr0;
    mh = r == sr0 && (bit(L.t3, i) || (i >= 1 && bit(L.t3, i - 1)) || (i >= 2 && bit(L.t3, i - 2)));
    mv = r <= sr0 && bit(L.vb, j0) && sr0 - L.down(L.ev, j0 - 1) <= r;
  };
  {
    uint32_t* const m[4] = {L.mh, L.mv, L.p, L.pc};
    w.ballots(n, m, [&](int q) {  // q: cell q (mh, mv, p), column-major index q (pc)
      bool mh, mv, mh_c, mv_c;
      member(q, mh, mv);
      member(L.rm(q), mh_c, mv_c);
      return (mh ? 1 : 0) | (mv ? 2 : 0) | (mh || mv ? 4 : 0) | (mh_c || mv_c ? 8 : 0);
    });
  }
  // a chain steps to a same-colour neighbour that is not primary
  w.each_of(nw, [&](int q) {
    const bool pad = q + 1 == nw;
    L.el[q] = L.eh[q] & ~L.p[q];
    L.er[q] = pad ? 0u : L.eh[q] & ~next_bits(L.p, q);
    L.elv[q] = L.ev[q] & ~L.pc[q];
    L.erv[q] = pad ? 0u : L.ev[q] & ~next_bits(L.pc, q);
  });
  {
    uint32_t* const m[3] = {L.ch, L.cv, L.cvc};
    w.ballots(n, m, [&](int q) {  // q: cell q (ch, cv), column-major index q (cvc)
      const int i = L.rm(q);
      return (bit(L.p, q) && L.hext(q) >= 3 ? 1 : 0) | (bit(L.p, q) && L.vext(q) >= 3 ? 2 : 0) |
             (bit(L.pc, q) && L.vext(i) >= 3 ? 4 : 0);
    });
  }
}

// Stable gravity into x (and k) of the board that make(i) writes into y (and
// yk) cell by cell, returning whether cell i is empty there: per column, an
// empty cell lands at the number of empties above it, a tile moves down by
// the number below it — counts of the column's bits of the column-major
// empty mask `emp`.
template <class W, class Ln, class Make>
TMT_DEV void gravity(const W& w, const Ln& L, const int* y, const int* yk, int* x, int* k,
                     uint32_t* emp, Make make) {
  const int R = L.R(), C = L.C();
  w.ballot(L.n(), emp, [&](int j) { return make(L.rm(j)); });
  w.each([&](int i) {
    const int r = L.row(i), c = L.col(i), j = c * R + r;
    const int dest = bit(emp, j) ? L.popc(emp, c * R, j) : r + L.popc(emp, j + 1, c * R + R);
    x[dest * C + c] = y[i];
    if (k != nullptr) k[dest * C + c] = yk[i];
  });
}

// The refill keys of 32 consecutive trips, hashed at once, lane l taking
// trip base + l: three hashes of latency per 32 trips of a board instead of
// three a trip.  `words` holds 4 a trip (the split's two keys); `base` is
// the first trip held, -1 for none.
struct KeyRing {
  uint32_t* words;
  int base;

  template <class W>
  TMT_DEV const uint32_t* of(const W& w, uint32_t s0, uint32_t s1, int t) {
    if (base < 0 || t < base || t >= base + 32) {
      base = t;
      w.each_of(32, [&](int l) {
        const RefillKeys k = refill_keys(s0, s1, static_cast<uint32_t>(t + l));
        words[4 * l] = k.a0;
        words[4 * l + 1] = k.a1;
        words[4 * l + 2] = k.b0;
        words[4 * l + 3] = k.b1;
      });
    }
    return words + 4 * (t - base);
  }
};

// Refills the empty cells of x (and k) with the draw whose four key words
// (RefillKeys' order) `key_of()` gives, asked only when a cell is empty.
// The empty cells are compacted into q first.  On the card each empty cell
// takes its two words from a pair of lanes, the first key's in the even
// lane and the second key's in the odd one: the j-th empty cell goes to
// threads 2j and 2j + 1 (mod the board's threads), and the hashes run on
// full lanes.
template <class W, class KeyOf>
TMT_DEV void refill_from(const W& w, int n, int* x, int* k, uint16_t* q, KeyOf key_of, uint32_t K,
                         uint32_t mult) {
  const int m = w.compact(n, q, [&](int i) { return x[i] == 0 && (k == nullptr || k[i] == 0); });
  if (m == 0) return;
  const uint32_t* key = key_of();
#ifdef __CUDACC__
  const uint32_t half = static_cast<uint32_t>(w.tid) & 1u;
  const uint32_t k0 = key[2 * half], k1 = key[2 * half + 1];
  for (int base = 0; base < 2 * m; base += W::kThreads) {
    const int e = base + w.tid;
    const int i = e < 2 * m ? q[e >> 1] : 0;
    const uint32_t word = draw_word(k0, k1, static_cast<uint32_t>(i));
    const uint32_t other = __shfl_xor_sync(kFull, word, 1);
    if (e < 2 * m && half == 0) {
      x[i] = colour_from(word, other, K, mult);
      if (k != nullptr) k[i] = 1;
    }
  }
  w.sync();
#else
  const RefillKeys keys{key[0], key[1], key[2], key[3]};
  w.each_of(m, [&](int e) {
    const int i = q[e];
    x[i] = refill_colour(keys, static_cast<uint32_t>(i), K, mult);
    if (k != nullptr) k[i] = 1;
  });
#endif
}

// The same with trip t's draw (sub key (s0, s1)).
template <class W>
TMT_DEV void refill(const W& w, int n, int* x, int* k, uint16_t* q, KeyRing& ring, uint32_t s0,
                    uint32_t s1, int t, uint32_t K, uint32_t mult) {
  refill_from(w, n, x, k, q, [&] { return ring.of(w, s0, s1, t); }, K, mult);
}

}  // namespace tmt
