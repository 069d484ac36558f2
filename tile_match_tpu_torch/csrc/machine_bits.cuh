// The activation stack machine of the specials on cell bit planes, for one
// board on one warp: K5's (combination.cu, the combination branch).  K4
// (trip_sp.cu) keeps the machine of machine.cuh, whose semantics this one
// shares bit for bit: ops/activate.py's `machine_step` and `run_machine`
// (see machine.cuh for the frame ops and the caps).
//
// The board inside the machine is three bit planes over its cells in
// row-major order: live (colour != 0), normal (kind 1) and special (kind
// not 0 or 1), of the cells not deleted yet; a deletion clears a cell's
// bit in all three.  Every region the machine scans lists its cells in
// row-major order (a laser's row or column, a 3x3 or 5x5 box, the whole
// board for a cookie or a mask scan), so "the region's next special at or
// after idx" is the lowest set bit of region & special & [idx, n): one
// vote over the lanes' words, a find-first-set and one shuffle that also
// carries the special's kind (the kinds are planes too); "delete the
// region's normals before it" is an AND-NOT on each lane's words.  A
// region's words come from (op, cell) by shifts: a span of rows and, on
// boards up to 32 wide, a band of columns cut from a periodic pattern,
// with no division a cell.  The colours are read
// through a plane for each colour, made once from the board: a cookie's
// entry counts each colour's live cells and deletes its colour's normals,
// and a mask scan finds its colour's specials, by ANDs and population
// counts of the words; `settle` writes colour 0 and kind 0 into the
// deleted cells once the stack has drained.
//
// Word q holds cells 32 q .. 32 q + 31.  On the card lane l holds words l,
// l + 32, ... in registers, NW a lane (NW = 1 up to 1,024 cells: every
// board of at most 32 by 32); the top frame sits in registers, the same in
// every lane, and the frames below it in a stack of 16-byte frames in
// shared memory (device memory for a board too large for a block), which
// every lane writes alike.  Compiled as plain C++ (TMT_HOST_BUILD), one
// thread holds every word and the votes loop over the 32 lanes.
#pragma once

#include <type_traits>

#include "machine.cuh"

namespace tmt {

// bits [0, s) of a word, s in [0, 32] (one funnel shift on the card)
TMT_DEV uint32_t low_mask(int s) {
#ifdef __CUDACC__
  return __funnelshift_lc(~0u, 0u, static_cast<unsigned>(s));
#else
  return s >= 32 ? ~0u : (1u << s) - 1u;
#endif
}

// bits [lo, hi) of the cells of word q, as a word
TMT_DEV uint32_t span(int lo, int hi, int q) {
  const int a = lo - 32 * q, b = hi - 32 * q;
  return low_mask(b > 0 ? b : 0) & ~low_mask(a > 0 ? a : 0);
}

// A bit plane over the board's cells: on the card the NW words of one lane
// (word lane + 32 s in w[s]), on the host every word (word q in w[q]).
template <int NW>
struct Plane {
#ifdef __CUDACC__
  uint32_t w[NW];
#else
  uint32_t w[32 * NW];
#endif
};

// The warp's view of a board's planes: n cells in nw words.
template <int NW>
struct BitWarp {
  int n, nw;
  int lane;
#ifdef __CUDACC__
  static constexpr int kSlots = NW;
  TMT_DEV int word(int s) const { return lane + 32 * s; }
#else
  static constexpr int kSlots = 32 * NW;
  TMT_DEV int word(int s) const { return s; }
#endif

  // f(s, q) for each word q of the board that this lane holds, in slot s
  template <class F>
  TMT_DEV void words(F f) const {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (word(s) < nw) f(s, word(s));
  }
  // word q of plane p, in every lane (q the same in every lane)
  TMT_DEV uint32_t word_at(const Plane<NW>& p, int q) const {
#ifdef __CUDACC__
    uint32_t v = 0;
#pragma unroll
    for (int s = 0; s < NW; ++s)
      if (s == (q >> 5)) v = p.w[s];
    return __shfl_sync(kFull, v, q & 31);
#else
    return p.w[q];
#endif
  }
  // word q of plane p := v, or &= ~v (v and q the same in every lane)
  TMT_DEV void set(Plane<NW>& p, int q, uint32_t v) const {
    words([&](int s, int qq) {
      if (qq == q) p.w[s] = v;
    });
  }
  TMT_DEV void clear(Plane<NW>& p, int q, uint32_t v) const {
    words([&](int s, int qq) {
      if (qq == q) p.w[s] &= ~v;
    });
  }
  // bit l: f(32 q + l), for the cells of word q
  template <class F>
  TMT_DEV uint32_t vote_word(int q, F f) const {
#ifdef __CUDACC__
    const int i = 32 * q + lane;
    return __ballot_sync(kFull, i < n && f(i));
#else
    uint32_t v = 0;
    for (int l = 0; l < 32; ++l)
      if (32 * q + l < n && f(32 * q + l)) v |= 1u << l;
    return v;
#endif
  }
  // f(i, l) for cell i = 32 q + l of word q, the lanes in parallel
  template <class F>
  TMT_DEV void cells_of(int q, F f) const {
#ifdef __CUDACC__
    if (32 * q + lane < n) f(32 * q + lane, lane);
#else
    for (int l = 0; l < 32 && 32 * q + l < n; ++l) f(32 * q + l, l);
#endif
  }
  // the lowest cell of the board whose bit the words f(s, q) set, or -1,
  // with tag(s, bit) of that cell's slot and bit in `tag_out` (tags < 32)
  template <class F, class T>
  TMT_DEV int first(F f, T tag, int& tag_out) const {
#ifdef __CUDACC__
#pragma unroll
    for (int s = 0; s < NW; ++s) {
      if (32 * s >= nw) break;
      const uint32_t v = word(s) < nw ? f(s, word(s)) : 0u;
      const unsigned hit = __ballot_sync(kFull, v != 0);
      if (hit) {
        const int bit = v ? ctz(v) : 0;
        const int got = __shfl_sync(kFull, bit | static_cast<int>(tag(s, bit)) << 5, ctz(hit));
        tag_out = got >> 5;
        return 32 * (ctz(hit) + 32 * s) + (got & 31);
      }
    }
    return -1;
#else
    for (int q = 0; q < nw; ++q) {
      const uint32_t v = f(q, q);
      if (v) {
        tag_out = static_cast<int>(tag(q, ctz(v)));
        return 32 * q + ctz(v);
      }
    }
    return -1;
#endif
  }
  template <class F>
  TMT_DEV bool any(F f) const {
    uint32_t v = 0;
    words([&](int s, int q) { v |= f(s, q); });
#ifdef __CUDACC__
    return __any_sync(kFull, v != 0) != 0;
#else
    return v != 0;
#endif
  }
  template <class F>
  TMT_DEV int sum(F f) const {
    int v = 0;
    words([&](int s, int q) { v += f(s, q); });
#ifdef __CUDACC__
    return static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(v)));
#else
    return v;
#endif
  }
};

// Calls f(std::integral_constant<int, NW>) with the fewest words a lane
// that hold nw words: one for every board of at most 32 by 32 (the only
// case a library of one such shape compiles), up to 64 for 65,535 cells.
template <class Ln, class F>
auto with_words(int nw, F f) {
  if constexpr (Ln::kNarrow) {
    return f(std::integral_constant<int, 1>{});
  } else {
    if (nw <= 32) return f(std::integral_constant<int, 1>{});
    if (nw <= 64) return f(std::integral_constant<int, 2>{});
    if (nw <= 128) return f(std::integral_constant<int, 4>{});
    if (nw <= 256) return f(std::integral_constant<int, 8>{});
    if (nw <= 512) return f(std::integral_constant<int, 16>{});
    return f(std::integral_constant<int, 64>{});
  }
}

// the special kinds of codes 0-3 (vertical laser, horizontal laser, bomb,
// cookie), a byte each
constexpr uint32_t kKindBytes = static_cast<uint8_t>(kKindV) | static_cast<uint8_t>(kKindH) << 8 |
                                static_cast<uint8_t>(kKindBomb) << 16 |
                                static_cast<uint32_t>(static_cast<uint8_t>(kKindCookie)) << 24;

// A frame below the top, 16 bytes (one shared-memory access): op * 2 +
// counted, cell, scan index (-1: not entered), colour.
struct alignas(16) Frame {
  int op_cnt, cell, idx, col;
};

template <int NW, class W, class Ln>
struct BitMachine {
  const W& w;  // the warp executor (block.cuh)
  const BitWarp<NW>& b;
  const Ln& L;
  int *x, *k;         // the board: read for a child's kind, deleted cells written by `settle`
  uint32_t* colours;  // (K + 1) nw words: the cells of colour c from word c nw (c = 1..K)
  Frame* stack;       // the frames below the top
  int K, SM;
  // live (colour != 0), special (kind not 0 or 1), normal (kind 1) and
  // kind > 1, of the cells not deleted yet
  Plane<NW> live{}, spec{}, norm{}, gt1{};
  // the specials' kinds, as the board was (a special keeps its kind until
  // it is deleted): code bit 0 and bit 1 (vertical laser 0, horizontal 1,
  // bomb 2, cookie 3), and any other kind
  Plane<NW> kb0{}, kb1{}, kodd{};
  // the same in every lane: the top frame and the counts
  int op = 0, cell = 0, idx = -1, col = 0, cnt = 0, r = 0, c = 0;
  int sp = 0, act = 0, ovf = 0, caps = 0;

  // The planes of the board x / k, and its colour planes (a colour's cells
  // do not change colour while the machine runs: its plane & live are the
  // colour's live cells); ends at a barrier.
  TMT_DEV void load() {
    const int nw = b.nw;
    w.each_of((K + 1) * nw, [&](int j) { colours[j] = 0; });
    for (int q = 0; q < nw; ++q) {
      b.set(live, q, b.vote_word(q, [&](int i) { return x[i] != 0; }));
      b.set(spec, q, b.vote_word(q, [&](int i) { return is_special(k[i]); }));
      b.set(norm, q, b.vote_word(q, [&](int i) { return k[i] == kKindNormal; }));
      b.set(gt1, q, b.vote_word(q, [&](int i) { return k[i] > 1; }));
      b.set(kb0, q, b.vote_word(q, [&](int i) { return k[i] == kKindH || k[i] == kKindCookie; }));
      b.set(kb1, q, b.vote_word(q, [&](int i) { return k[i] == kKindBomb || k[i] == kKindCookie; }));
      b.set(kodd, q, b.vote_word(q, [&](int i) {
        return is_special(k[i]) && k[i] != kKindV && k[i] != kKindH && k[i] != kKindBomb &&
               k[i] != kKindCookie;
      }));
#ifdef __CUDACC__
      const int i = 32 * q + b.lane, cc = i < b.n ? x[i] : 0;
      const unsigned peers = __match_any_sync(kFull, cc);  // the word's cells of colour cc
      if (cc >= 1 && cc <= K && b.lane == ctz(peers)) colours[cc * nw + q] = peers;
#else
      b.cells_of(q, [&](int i, int l) {
        if (x[i] >= 1 && x[i] <= K) colours[x[i] * nw + q] |= 1u << l;
      });
#endif
    }
    w.sync();
  }

  TMT_DEV void top(int op_, int cell_, int cnt_, int idx_, int col_) {
    op = op_;
    cell = cell_;
    cnt = cnt_ > 0;
    idx = idx_;
    col = col_;
    r = L.row(cell);
    c = L.col(cell);
  }
  // every lane stores the same frame
  TMT_DEV void save(int at) const { stack[at] = Frame{op * 2 + cnt, cell, idx, col}; }
  TMT_DEV void restore(int at) {
    const Frame f = stack[at];
    top(f.op_cnt >> 1, f.cell, f.op_cnt & 1, f.idx, f.col);
  }

  // Pushes a frame; a full stack drops it and sets ovf.
  TMT_DEV void push(int op_, int cell_, int cnt_, int idx_ = -1, int col_ = 0) {
    if (sp >= SM) {
      ovf = 1;
      return;
    }
    if (sp > 0) save(sp - 1);
    top(op_, cell_, cnt_, idx_, col_);
    ++sp;
  }
  TMT_DEV void pop() {
    if (--sp > 0) {
      w.sync();  // every lane's store of the frame has landed
      restore(sp - 1);
    }
  }

  // The most common colour of the live cells, the lowest of equals: on the
  // card lane l counts colours l + 1, l + 33, ... over the live plane's
  // words.
  TMT_DEV int most_common() const {
    int best = -1, colour = K + 1;  // this lane's colours, in order
#ifdef __CUDACC__
    for (int base = 1; base <= K; base += 32) {
      const int v = base + b.lane;
      int count = 0;
      for (int q = 0; q < b.nw; ++q) {
        const uint32_t lw = b.word_at(live, q);
        if (v <= K) count += popc(colours[v * b.nw + q] & lw);
      }
      if (v <= K && count > best) {
        best = count;
        colour = v;
      }
    }
#else
    for (int v = 1; v <= K; ++v) {
      int count = 0;
      for (int q = 0; q < b.nw; ++q) count += popc(colours[v * b.nw + q] & live.w[q]);
      if (count > best) {
        best = count;
        colour = v;
      }
    }
#endif
    const int most = w.lanes_max(best);
    return w.lanes_min(best == most ? colour : K + 1);
  }

  // A laser's line or a bomb's box: a region of fixed cells.  The other
  // ops scan the board for the specials of their colour.
  TMT_HOST_DEV static bool boxed(int o) {
    return o == kKindV || o == kKindH || o == kKindBomb || o == kOpBomb2;
  }

  // The top frame's region (a boxed op) in word q.
  TMT_DEV uint32_t region(int q) const {
    const int R = L.R(), C = L.C();
    if (op == kKindH) return span(r * C, r * C + C, q);
    const int rad = op == kKindV ? 0 : op == kKindBomb ? 1 : 2;
    const int r0 = op == kKindV ? 0 : r - rad < 0 ? 0 : r - rad;
    const int r1 = op == kKindV ? R - 1 : r + rad > R - 1 ? R - 1 : r + rad;
    const int c0 = c - rad < 0 ? 0 : c - rad, c1 = c + rad > C - 1 ? C - 1 : c + rad;
    if constexpr (Ln::kNarrow) {
      // rows r0..r1, and the word's bits j whose column (32 q + j) mod C
      // lies in c0..c1: bit j + d of the pattern with bits t C .. t C + w - 1
      // (w = c1 - c0 + 1 <= C), d = (32 q - c0) mod C < 32
      uint64_t comb = 0;
      for (int t = 0; t < 64; t += C) comb |= 1ull << t;
      const int p = L.col(32 * q), d = p >= c0 ? p - c0 : p - c0 + C;
      const uint64_t band = (comb * ((1ull << (c1 - c0 + 1)) - 1ull)) >> d;
      return static_cast<uint32_t>(band) & span(r0 * C, (r1 + 1) * C, q);
    } else {
      uint32_t m = 0;
      if (span(r0 * C + c0, r1 * C + c1 + 1, q) != 0)
        for (int rr = r0; rr <= r1; ++rr) m |= span(rr * C + c0, rr * C + c1 + 1, q);
      return m;
    }
  }

  // The lowest cell of the board whose bit the words f(s, q) set, or -1;
  // a special, whose kind goes to `kind`: one vote finds the lowest lane
  // with a candidate, which hands over its lowest bit and that cell's kind
  // code in one shuffle.
  template <class F>
  TMT_DEV int first_special(F f, int& kind) const {
    const int at = b.first(f, [&](int s, int bit) {
      return ((kb0.w[s] >> bit) & 1u) | ((kb1.w[s] >> bit) & 1u) << 1 | ((kodd.w[s] >> bit) & 1u) << 2;
    }, kind);
    // codes 0-3: the kinds' bytes, sign-extended (no branch); 4: another kind
    if (at >= 0) kind = kind < 4 ? static_cast<int8_t>(kKindBytes >> (8 * kind)) : k[at];
    return at;
  }

  // One micro-step on the top frame (sp > 0).
  TMT_DEV void step() {
    const bool real = op == kKindV || op == kKindH || op == kKindBomb || op == kKindCookie;
    if (real && idx < 0) {  // entry
      if (!b.any([&](int s, int) { return live.w[s]; })) {  // an empty board: return at once
        pop();
        return;
      }
      const uint32_t own = 1u << (cell & 31);
      b.clear(live, cell >> 5, own);
      b.clear(spec, cell >> 5, own);
      b.clear(norm, cell >> 5, own);
      b.clear(gt1, cell >> 5, own);
      act += cnt;
      if (op == kKindCookie) {  // the most common colour; its normals go
        col = most_common();
        b.words([&](int s, int q) {
          const uint32_t gone = norm.w[s] & colours[col * b.nw + q];
          live.w[s] &= ~gone;
          norm.w[s] &= ~gone;
        });
      }
      idx = 0;
    }
    // scan the region from idx: delete its normals up to the next special
    // (a cookie and a mask scan delete nothing), then push that special, or
    // pop when none is left
    const int from = idx < 0 ? 0 : idx, n = b.n;
    int found, kind = 0;
    if (!boxed(op)) {  // the cells of colour col and kind > 1
      if (col >= 1 && col <= K) {
        found = first_special([&](int s, int q) { return gt1.w[s] & colours[col * b.nw + q] & span(from, n, q); },
                              kind);
      } else {  // a colour without a plane: the cells' own
        found = first_special([&](int s, int q) {
          for (uint32_t v = gt1.w[s] & span(from, n, q); v; v &= v - 1)
            if (x[32 * q + ctz(v)] == col) return v & (~v + 1u);
          return 0u;
        }, kind);
      }
    } else {
      Plane<NW> reg;
      b.words([&](int s, int q) { reg.w[s] = region(q) & span(from, n, q); });
      found = first_special([&](int s, int) { return reg.w[s] & spec.w[s]; }, kind);
      b.words([&](int s, int q) {
        const uint32_t gone = reg.w[s] & ~spec.w[s] & (found < 0 ? ~0u : span(0, found, q));
        live.w[s] &= ~gone;
        norm.w[s] &= ~gone;
      });
    }
    if (found < 0) {
      pop();
      return;
    }
    idx = found + 1;
    if (sp >= SM) {  // the child's push is dropped
      caps |= kCapStack;
      ovf = 1;
      return;
    }
    save(sp - 1);
    top(kind, found, real ? 1 : 0, -1, 0);
    ++sp;
  }

  // Micro-steps until the stack drains, or `budget` of them (< 0: no
  // budget); frames left set kCapSteps and ovf.
  TMT_DEV void run(int budget) {
    for (int steps = 0; sp > 0 && (budget < 0 || steps < budget); ++steps) step();
    if (sp > 0) {
      caps |= kCapSteps;
      ovf = 1;
    }
  }

  // Writes colour 0 and kind 0 into the deleted cells of x / k; ends at a
  // barrier.
  TMT_DEV void settle() {
    for (int q = 0; q < b.nw; ++q) {
      const uint32_t kept = b.word_at(live, q) | b.word_at(spec, q) | b.word_at(norm, q);
      b.cells_of(q, [&](int i, int l) {
        if (!((kept >> l) & 1u)) {
          x[i] = 0;
          k[i] = 0;
        }
      });
    }
    w.sync();
  }

  // Cells of nonzero kind.
  TMT_DEV int kinds() const {
    return b.sum([&](int s, int) { return popc(spec.w[s] | norm.w[s]); });
  }
};

}  // namespace tmt
