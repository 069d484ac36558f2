// The activation stack machine of the specials, for one board on one warp:
// shared by K4 (trip_sp.cu, the full-machinery trip) and K5
// (combination.cu, the combination branch).
//
// Its semantics are ops/activate.py's `machine_step` and `run_machine`:
// each board has a stack of frames, and one micro-step either enters the
// top frame (a real special deletes its own cell and is counted; a cookie
// picks the most common colour and deletes its normals) and then scans,
// or scans: it deletes the region's normals up to the region's next
// special in row-major order and pushes that special's frame, or pops when
// none is left.  The frame ops are the kinds of the real specials (a
// vertical or horizontal laser, a bomb, a cookie) and the combination
// branch's two: OP_MASKSCAN (the specials of one colour in row-major
// order, nothing deleted, children uncounted) and OP_BOMB2 (the 5x5 sweep,
// no entry, children uncounted).  A push onto a full stack of `stack_max`
// frames is dropped and sets `ovf` (kCapStack when a micro-step pushed it);
// the combination's run stops after `activation_steps_max` micro-steps
// (kCapSteps, and `ovf`, when frames are left).
//
// The design: the decisions are serial and the work is the warp's.  Every
// lane keeps the same copy of the scalars (stack pointer, counts, the
// board's cells of nonzero colour) and takes the same decisions, from the
// stack in shared memory (or device memory, for a board too large for a
// block), which lane 0 writes; a region's scan is one vote a chunk of 32
// region cells (a laser of up to 32 cells, a 3x3 or 5x5 box: one; a
// cookie or mask scan: one a 32 cells of the board): each lane tests one
// cell of the region at or after the frame's scan index for "special",
// the lowest set bit is the next special, and the lanes before it delete
// their normals at once.  A cookie's colour is a reduction over the
// colour counts and its normals go by the lanes striding over the board.
// The colour counts follow the deletions by a warp reduction per chunk
// (lanes that deleted the same colour add once), the board's live cells
// by a vote; the empty-board test is that count.  Deletion order within a
// micro-step does not change the result: only the set of cells deleted
// and the special found do, so the machine equals the serial one bit for
// bit.
//
// Compiled as plain C++ (TMT_HOST_BUILD), a vote or a deletion loops over
// the 32 lanes of a chunk, and the executor's loops run the rest.
#pragma once

#include "trip.cuh"

namespace tmt {

// tile kinds (config.py) and the frame ops
constexpr int kKindNormal = 1, kKindV = 2, kKindH = 3, kKindBomb = 4, kKindCookie = -1;
constexpr int kOpMaskscan = 5, kOpBomb2 = 6;
// cap bits: a micro-step's push was dropped; the step budget ran out
constexpr int kCapStack = 8, kCapSteps = 16;

TMT_HOST_DEV bool is_special(int kd) { return kd != 0 && kd != kKindNormal; }

// The stack of one board, SM frames: op, cell (flat row-major), scan index
// (-1: not entered yet), colour (cookie, mask scan), counted.
struct Frames {
  int *op, *cell, *idx, *col, *cnt;

  TMT_HOST_DEV void carve(Arena& a, int SM) {
    int** f[5] = {&op, &cell, &idx, &col, &cnt};
    for (auto p : f) *p = a.take<int>(SM);
  }
};

// bit l: f(l), for the 32 lanes of a chunk
template <class W, class F>
TMT_DEV uint32_t vote(const W& w, F f) {
#ifdef __CUDACC__
  return __ballot_sync(kFull, f(w.lane()));
#else
  uint32_t v = 0;
  for (int l = 0; l < 32; ++l)
    if (f(l)) v |= 1u << l;
  return v;
#endif
}

template <class W, class Ln>
struct Machine {
  const W& w;
  const Ln& L;
  int *x, *k;    // the board: colour, kind
  int* ccount;   // cells of each colour 1..K
  Frames f;
  int K, SM;
  // the same in every lane
  int alive = 0;  // cells of nonzero colour
  int sp = 0, act = 0, ovf = 0, caps = 0;

  // Counts the board's colours (alive, ccount); ends at a barrier.
  TMT_DEV void count_colours() {
    alive = w.count([&](int i) { return x[i] != 0; });
    w.each_of(K + 1, [&](int v) { ccount[v] = 0; });
#ifdef __CUDACC__
    const int n = L.n();
    for (int base = 0; base < n; base += 32) {
      const int i = base + w.lane();
      tally(i < n ? x[i] : 0, 1);
    }
#else
    for (int i = 0; i < L.n(); ++i)
      if (x[i] >= 1 && x[i] <= K) ++ccount[x[i]];
#endif
  }

#ifdef __CUDACC__
  // ccount[c] += delta for each lane's colour c (0: none): the lanes that
  // hold one colour add once; ends at a barrier
  TMT_DEV void tally(int c, int delta) {
    const int d = c >= 1 && c <= K ? c : 0;
    const unsigned peers = __match_any_sync(kFull, d);
    if (d != 0 && w.lane() == ctz(peers)) ccount[d] += delta * popc(peers);
    __syncwarp();
  }
#endif

  // Each lane deletes cell cell_of(lane) (-1: none; the cells distinct);
  // ends at a barrier.
  template <class F>
  TMT_DEV void erase(F cell_of) {
#ifdef __CUDACC__
    const int i = cell_of(w.lane());
    int c = 0;
    if (i >= 0) {
      c = x[i];
      x[i] = 0;
      k[i] = 0;
    }
    alive -= popc(__ballot_sync(kFull, c != 0));
    tally(c, -1);
#else
    for (int l = 0; l < 32; ++l) {
      const int i = cell_of(l);
      if (i < 0) continue;
      const int c = x[i];
      alive -= c != 0;
      if (c >= 1 && c <= K) --ccount[c];
      x[i] = 0;
      k[i] = 0;
    }
#endif
  }

  // Deletes the n distinct cells of a list, 32 at a time.
  TMT_DEV void erase_list(const int* cells, int n) {
    for (int base = 0; base < n; base += 32)
      erase([&](int l) { return base + l < n ? cells[base + l] : -1; });
  }

  // Pushes a frame (lane 0 writes it); a full stack drops it and sets ovf.
  // Ends at a barrier.
  TMT_DEV void push(int op, int cell, int counted, int idx = -1, int col = 0) {
    if (sp < SM) {
      if (w.leader()) {
        f.op[sp] = op;
        f.cell[sp] = cell;
        f.idx[sp] = idx;
        f.col[sp] = col;
        f.cnt[sp] = counted;
      }
      ++sp;
    } else {
      ovf = 1;
    }
    w.sync();
  }

  // The most common colour on the board, the lowest of equals.
  TMT_DEV int most_common() {
    int best = -1, colour = K + 1;  // this lane's colours, in order
    w.each_of(K, [&](int v) {
      if (ccount[v + 1] > best) {
        best = ccount[v + 1];
        colour = v + 1;
      }
    });
    const int top = w.lanes_max(best);
    return w.lanes_min(best == top ? colour : K + 1);
  }

  // A laser's line or a bomb's box: a region of fixed cells.  The other
  // ops scan the board for the specials of their colour.
  TMT_HOST_DEV static bool boxed(int op) {
    return op == kKindV || op == kKindH || op == kKindBomb || op == kOpBomb2;
  }

  // Region position p of frame (op, r, c), or -1 when p lies outside the
  // board; regions list their cells in row-major order.
  TMT_DEV int region_cell(int op, int r, int c, int p) const {
    const int R = L.R(), C = L.C();
    int rr, cc;
    if (op == kKindV) {
      rr = p;
      cc = c;
    } else if (op == kKindH) {
      rr = r;
      cc = p;
    } else if (op == kKindBomb) {
      rr = r - 1 + p / 3;
      cc = c - 1 + p % 3;
    } else if (op == kOpBomb2) {
      rr = r - 2 + p / 5;
      cc = c - 2 + p % 5;
    } else {  // a scan of the board
      return p;
    }
    return rr >= 0 && rr < R && cc >= 0 && cc < C ? rr * C + cc : -1;
  }

  TMT_DEV int region_size(int op) const {
    return op == kKindV   ? L.R()
           : op == kKindH ? L.C()
           : op == kKindBomb ? 9
           : op == kOpBomb2  ? 25
                             : L.n();
  }

  // One micro-step on the top frame (sp > 0).
  TMT_DEV void step() {
    const int top = sp - 1;
    const int op = f.op[top], cell = f.cell[top];
    int idx = f.idx[top], fcol = f.col[top];
    const bool real = op == kKindV || op == kKindH || op == kKindBomb || op == kKindCookie;
    w.sync();  // every lane has read the frame before lane 0 rewrites it
    if (real && idx < 0) {  // entry
      if (alive == 0) {  // an empty board: return at once
        --sp;
        return;
      }
      erase([&](int l) { return l == 0 ? cell : -1; });
      act += f.cnt[top] > 0;
      if (op == kKindCookie) {  // the most common colour; its normals go
        fcol = most_common();
        int gone = 0;
        w.each_of(L.n(), [&](int i) {
          if (x[i] == fcol && k[i] == kKindNormal) {
            x[i] = 0;
            k[i] = 0;
            ++gone;
          }
        });
        gone = w.lanes_sum(gone);
        alive -= gone;
        if (w.leader()) {
          ccount[fcol] -= gone;
          f.col[top] = fcol;
        }
      }
      idx = 0;
    }
    // scan the region from idx: delete its normals up to the next special
    // (a cookie and a mask scan delete nothing), then push that special,
    // or pop when none is left
    const bool scan_only = op == kKindCookie || op == kOpMaskscan, box = boxed(op);
    const int r = L.row(cell), c = L.col(cell), P = region_size(op);
    auto pending = [&](int p) {  // the region's cell at p, if at or after idx
      if (p < 0 || p >= P) return -1;
      const int i = region_cell(op, r, c, p);
      if (i < 0 || i < idx) return -1;
      return box || (x[i] == fcol && k[i] > 1) ? i : -1;
    };
    int found = -1;
    for (int base = box ? 0 : idx & ~31; base < P && found < 0; base += 32) {
      const uint32_t hit = vote(w, [&](int l) {
        const int i = pending(base + l);
        return i >= 0 && is_special(k[i]);
      });
      const int stop = hit ? ctz(hit) : 32;
      if (!scan_only)
        erase([&](int l) {
          const int i = l < stop ? pending(base + l) : -1;
          return i >= 0 && !is_special(k[i]) ? i : -1;
        });
      if (hit) found = region_cell(op, r, c, base + stop);
    }
    if (found < 0) {
      --sp;
      w.sync();
      return;
    }
    if (w.leader()) f.idx[top] = found + 1;
    if (sp >= SM) caps |= kCapStack;
    push(k[found], found, real ? 1 : 0);
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
};

}  // namespace tmt
