// One full-machinery trip of the specials cascade for Hopper (sm_90a), one
// warp per board.
//
// Replaces the XLA program `engine.specials_cascade_trip_grid` of
// tile_match_tpu/engine.py:173 (run on the frozen boards of each round by
// `fused_specials_cascade`, tile_match_tpu/envs/fused.py:278-361); no
// Pallas kernel computed it.  Its plain PyTorch version is
// `engine.specials_cascade_trip` in tile_match_tpu_torch/engine.py; the
// outputs of the two are equal bit for bit, all six.
//
// What it computes, per board, as the JAX package does (their order, their
// caps, and their overflow behaviour):
//   1. the detected lines as an ordered list (ops/lines.py
//      `get_colour_lines`): the primary lines of the lowest anchoring row
//      by column, the vertical before the horizontal one, then the >= 3
//      extension segments through the primary cells, in order of the first
//      primary cell that generates them, horizontal before vertical; lines
//      beyond `lines_max` are dropped (cap bit kCapLines);
//   2. the greedy classification (ops/classify.py `process_colour_lines`):
//      the lines that share no cell classify alone, level by level of
//      their cookie splits; the sharing lines run the pop machine (cookie,
//      laser, bomb with its partner, normal; cookie remainders appended
//      while the queue has room, else kCapQueue); the two streams merge by
//      (level, root key); more than `matches_max` matches set kCapEmit;
//   3. resolution (ops/resolve.py `resolve_colour_matches`): creation
//      positions in match order before any deletion (`_creation_pos`),
//      then match by match the deletions and, for every special met, the
//      activation stack machine (csrc/machine.cuh, ops/activate.py
//      `machine_step`: entry, the scan of the region up to its next
//      special, push or pop; a push onto a full stack of `stack_max`
//      frames is dropped, kCapStack); then the new specials;
//   4. eliminations (empty cells after resolution), stable gravity of
//      both channels and the refill with randint(fold_in(sub, trips),
//      (R, C), 1, K + 1), JAX's threefry (csrc/threefry.cuh).
// A trip has no step budget: `activation_steps_max` caps the combination
// branch's machine only (ops/activate.py `run_machine`, K5).
//
// What bounds it on the card: not memory (a 10x10 board is 800 bytes in
// and ~820 out) and not arithmetic, but the chain of dependent steps of
// one board: the classification and the activation machine are a greedy
// order, one decision after another, each reading the board as the last
// left it.  A launch lasts as long as its longest board.  The design:
//   - one warp per board (`Warp`, csrc/block.cuh); detection (the cell bit
//     masks of csrc/trip.cuh), the eliminations, gravity and the refill
//     run on the whole warp; the ordered line list and the classification
//     run on lane 0, as the greedy serial program they are, reading the
//     detection masks for run lengths;
//   - resolution runs on the whole warp: every lane takes the same
//     decisions (the next match's first special, push, pop) and the lanes
//     share the work: a match's cells are deleted 32 at a time, and the
//     activation machine (csrc/machine.cuh, shared with K5) scans a
//     region with one vote a 32 cells and deletes its normals at once;
//     the creation cells and the new specials stay on lane 0;
//   - the board's scratch (line queue, matches, stack of `stack_max`
//     frames) sized from the config's caps, in shared memory when it fits
//     the block's opt-in limit and in a device buffer the wrapper hands in
//     when not;
//   - colour counts kept as cells are deleted, so that a cookie's colour
//     choice and the empty-board test cost K and 1, not R*C;
//   - the board's shape fixed at compile time for boards up to 32 by 32
//     (one library a shape, as K1-K3), read at run time above.
//
// Limits: at most 65,535 cells a board (16-bit cell indices of the refill).
#define TMT_NO_UNROLL

#include "machine.cuh"

namespace tmt {

constexpr int kBig = 1 << 30;  // ops/runs.py BIG
// which cap fired (the debug-checks sites of the JAX package; the
// activation stack's is machine.cuh's kCapStack)
constexpr int kCapLines = 1, kCapQueue = 2, kCapEmit = 4;
// match codes (config.py)
constexpr int kMatchNormal = 1, kMatchVLaser = 2, kMatchHLaser = 3, kMatchBomb = 4,
              kMatchCookie = 5;

struct TripConfig {
  int R, C, K, LM, SM;  // lines_max, stack_max
  bool cookie, v_laser, h_laser, bomb;
  TMT_HOST_DEV int lmax() const { return R > C ? R : C; }  // line_len_max
  TMT_HOST_DEV int cm() const { return lmax() + 3; }       // match_coords_max
  TMT_HOST_DEV int lm2() const { return 2 * LM; }          // queue slots = matches_max
  // levels of cookie splits a line can take
  TMT_HOST_DEV int levels() const { return cookie ? 1 + (lmax() > 3 ? (lmax() - 3) / 5 : 0) : 1; }
};

// Scratch of one board.  Cells are flat row-major indices.
template <class Ln>
struct TripSmem {
  Ln L;
  int *x, *k, *y, *yk;  // the board; the board before gravity
  int *cnt, *mark;      // per cell: lines through it; stamps
  uint8_t* taken;       // per cell: a creation position
  uint16_t* q;          // compacted empty cells
  uint32_t *keys, *emp;
  int* ccount;          // cells of each colour 1..K
  // line queue, lm2 slots of lmax cells
  int *lq, *ll, *lo, *mlo, *lroot, *llev;
  uint8_t* shared;
  // the pop machine's emissions, lm2 of cm cells
  int *mc, *mlen, *mt, *mcol, *mkey;
  // the merge: keys and sources of every emission
  int *ek, *ei;
  // the matches, lm2 of cm cells, and their creation cells
  int *cells, *len, *type, *col, *qcell;
  // the activation stack, SM frames
  Frames frames;
  // the serial part's results for the warp: matches, cap bits, lines, created
  int* meta;

  TMT_HOST_DEV size_t carve(unsigned char* base, const TripConfig& cf) {
    const int n = cf.R * cf.C, w = mask_words(n), LM2 = cf.lm2(), CM = cf.cm();
    Arena a{base, 0};
    L.carve(a, cf.R, cf.C);
    int** cell[6] = {&x, &k, &y, &yk, &cnt, &mark};
    for (auto p : cell) *p = a.take<int>(n);
    taken = a.take<uint8_t>(n);
    q = a.take<uint16_t>(n);
    keys = a.take<uint32_t>(4 * 32);
    emp = a.take<uint32_t>(w);
    ccount = a.take<int>(cf.K + 1);
    lq = a.take<int>(static_cast<size_t>(LM2) * cf.lmax());
    int** slot[10] = {&ll, &lo, &mlo, &lroot, &llev, &mlen, &mt, &mcol, &mkey, &qcell};
    for (auto p : slot) *p = a.take<int>(LM2);
    shared = a.take<uint8_t>(LM2);
    mc = a.take<int>(static_cast<size_t>(LM2) * CM);
    const int ne = cf.levels() * LM2 + LM2;
    ek = a.take<int>(ne);
    ei = a.take<int>(ne);
    cells = a.take<int>(static_cast<size_t>(LM2) * CM);
    int** match[3] = {&len, &type, &col};
    for (auto p : match) *p = a.take<int>(LM2);
    frames.carve(a, cf.SM);
    meta = a.take<int>(4);
    return (a.used + 15) & ~static_cast<size_t>(15);
  }
};

template <class Ln>
TMT_HOST_DEV size_t trip_bytes(const TripConfig& cf) {
  TripSmem<Ln> s;
  return s.carve(nullptr, cf);
}

struct TripResult {
  int act, created, ovf, caps, lines;
};

TMT_DEV int iabs(int v) { return v < 0 ? -v : v; }

// The serial parts of a trip, on lane 0: lines, classification, and the
// creation cells and new specials of resolution.
template <class Ln>
struct Serial {
  TripSmem<Ln>& s;
  const TripConfig& cf;
  int gen;  // the stamp of the current use of s.mark

  TMT_DEV int row(int i) const { return s.L.row(i); }
  TMT_DEV int col(int i) const { return s.L.col(i); }

  // ---- 1. the ordered line list -------------------------------------------
  // The primary lines in slot order: f(first cell, step, length).
  template <class F>
  TMT_DEV void primaries(int sr0, F f) {
    const Ln& L = s.L;
    const int R = L.R(), C = L.C();
    for (int c = 0; c < C; ++c) {
      const int j0 = c * R + sr0;
      if (bit(L.vb, j0)) {  // a vertical run whose bottom is (sr0, c)
        const int top = sr0 - L.down(L.ev, j0 - 1);
        f(top * C + c, C, sr0 - top + 1);
      }
      const int i = sr0 * C + c;  // a horizontal run of 3 or more starting at c
      if (bit(L.t3, i) && (c == 0 || !bit(L.eh, i - 1))) f(i, 1, 1 + L.up(L.eh, i));
    }
  }

  // Returns the lines stored (at most lines_max); `total` counts them all.
  TMT_DEV int lines(int sr0, int& total) {
    const Ln& L = s.L;
    const int C = L.C(), LX = cf.lmax();
    int nl = 0;
    total = 0;
    auto add = [&](int start, int step, int n) {
      if (nl < cf.LM) {
        for (int j = 0; j < n; ++j) s.lq[nl * LX + j] = start + j * step;
        s.ll[nl] = n;
        ++nl;
      }
      ++total;
    };
    if (sr0 < 0) return 0;
    primaries(sr0, add);
    // each primary cell, at its first place in the primary list, adds its
    // horizontal then its vertical extension segment
    const int g = ++gen;
    primaries(sr0, [&](int start, int step, int n) {
      for (int j = 0; j < n; ++j) {
        const int i = start + j * step;
        if (s.mark[i] == g) continue;
        s.mark[i] = g;
        const int he = L.hext(i), ve = L.vext(i);
        if (he >= 3) add(i - L.le(i), 1, he);
        if (ve >= 3) add(i - L.ue(i) * C, C, ve);
      }
    });
    return nl;
  }

  // ---- 2. classification ---------------------------------------------------
  TMT_DEV int laser_type(const int* line) const {
    const bool is_h = row(line[0]) == row(line[1]);
    return is_h && cf.h_laser ? kMatchHLaser : (cf.v_laser ? kMatchVLaser : kMatchNormal);
  }

  // The pop machine over the sharing lines; returns the emissions.
  TMT_DEV int machine(int& caps) {
    const int LX = cf.lmax(), LM2 = cf.lm2(), CM = cf.cm(), MM = LM2;
    const int KSPAN = (cf.R + 2) * cf.LM;
    int mcount = 0, atail = cf.LM, next_order = KSPAN;
    for (int t = 0; t < LM2; ++t) {
      s.mlo[t] = s.shared[t] ? s.lo[t] : kBig;
      s.lroot[t] = s.mlo[t];
      s.llev[t] = 0;
    }
    while (true) {
      int sel = -1, best = kBig;
      for (int t = 0; t < LM2; ++t)
        if (s.mlo[t] < best) {
          best = s.mlo[t];
          sel = t;
        }
      if (sel < 0) return mcount;
      const int n = s.ll[sel];
      const int* line = s.lq + sel * LX;
      const int root = s.lroot[sel], lev = s.llev[sel];
      s.mlo[sel] = kBig;
      s.ll[sel] = 0;
      const bool cookie_case = cf.cookie && n >= 5;
      const bool laser_case = !cookie_case && n == 4;
      // the partner: the first queued line, by order key, sharing a cell
      int partner = -1;
      if (cf.bomb) {
        const int g = ++gen;
        for (int j = 0; j < n; ++j) s.mark[line[j]] = g;
        int pbest = kBig;
        for (int t = 0; t < LM2; ++t) {
          if (s.mlo[t] >= pbest || s.ll[t] <= 0) continue;
          const int* p = s.lq + t * LX;
          bool hit = false;
          for (int j = 0; j < s.ll[t] && !hit; ++j) hit = s.mark[p[j]] == g;
          if (hit) {
            pbest = s.mlo[t];
            partner = t;
          }
        }
      }
      const bool bomb_case = !cookie_case && !laser_case && partner >= 0 && n >= 3;
      const bool normal_case = !cookie_case && !laser_case && !bomb_case && n >= 3;
      const bool emit = cookie_case || laser_case || bomb_case || normal_case;

      // a cookie's remainder re-queued after every queued line
      const int rem = n - 5;
      if (cookie_case && rem > 2) {
        if (atail >= LM2) {
          caps |= kCapQueue;
        } else {
          for (int j = 0; j < rem; ++j) s.lq[atail * LX + j] = line[5 + j];
          s.ll[atail] = rem;
          s.mlo[atail] = next_order;
          s.lroot[atail] = root;
          s.llev[atail] = lev + 1;
          ++atail;
          ++next_order;
        }
      }
      if (!emit) continue;
      const int slot = mcount < MM - 1 ? mcount : MM - 1;
      int* out = s.mc + slot * CM;
      const int keep = cookie_case ? (n < 5 ? n : 5) : n;
      for (int j = 0; j < keep; ++j) out[j] = line[j];
      int out_len = keep;
      int out_type = cookie_case ? kMatchCookie : (laser_case ? laser_type(line) : kMatchNormal);
      if (bomb_case) {
        // the partner's three cells closest to the first shared cell of
        // the line (Manhattan, ties to the earlier), those not in the line
        // added to the bomb
        int* p = s.lq + partner * LX;
        const int plen = s.ll[partner];
        const int g = ++gen;
        for (int j = 0; j < plen; ++j) s.mark[p[j]] = g;
        int sj = 0;
        while (s.mark[line[sj]] != g) ++sj;
        const int sr = row(line[sj]), sc = col(line[sj]);
        int sel3[3];
        for (int t = 0; t < 3; ++t) {
          int bk = -1;
          long long bkey = 0;
          for (int kk = 0; kk < LX; ++kk) {
            if ((t > 0 && sel3[0] == kk) || (t > 1 && sel3[1] == kk)) continue;
            long long key = kBig;
            if (kk < plen) {
              const int d = iabs(row(p[kk]) - sr) + iabs(col(p[kk]) - sc);
              key = static_cast<long long>(d) * LX + kk;
            }
            if (bk < 0 || key < bkey) {
              bk = kk;
              bkey = key;
            }
          }
          sel3[t] = bk;
        }
        for (int t = 0; t < 3; ++t) {
          if (sel3[t] >= plen) continue;
          const int cell = p[sel3[t]];
          bool in_line = false;
          for (int j = 0; j < n && !in_line; ++j) in_line = line[j] == cell;
          if (in_line) continue;
          out[out_len < CM - 1 ? out_len : CM - 1] = cell;
          ++out_len;
        }
        out_type = kMatchBomb;
        if (plen < 6) {  // the partner is used up
          s.mlo[partner] = kBig;
          s.ll[partner] = 0;
        } else {  // it loses the three cells
          int m = 0;
          for (int kk = 0; kk < plen; ++kk)
            if (kk != sel3[0] && kk != sel3[1] && kk != sel3[2]) p[m++] = p[kk];
          s.ll[partner] = plen - 3;
        }
      }
      s.mlen[slot] = out_len;
      s.mt[slot] = out_type;
      s.mcol[slot] = cookie_case ? 0 : s.x[line[0]];
      s.mkey[slot] = lev * KSPAN + root;
      ++mcount;
    }
  }

  // Classifies the nl lines; returns the matches' count (unclamped, as the
  // JAX package's) and writes the first matches_max of them.
  TMT_DEV int classify(int nl, int& caps) {
    const int n = cf.R * cf.C, LX = cf.lmax(), LM2 = cf.lm2(), CM = cf.cm(), MM = LM2;
    const int KSPAN = (cf.R + 2) * cf.LM, NL = cf.levels();
    for (int t = 0; t < LM2; ++t) {
      s.lo[t] = t < nl ? row(s.lq[t * LX]) * cf.LM + t : kBig;
      if (t >= nl) s.ll[t] = 0;
      s.shared[t] = 0;
    }
    if (cf.bomb) {  // a line shares when one of its cells lies on another line
      for (int i = 0; i < n; ++i) s.cnt[i] = 0;
      for (int t = 0; t < nl; ++t)
        for (int j = 0; j < s.ll[t]; ++j) ++s.cnt[s.lq[t * LX + j]];
      for (int t = 0; t < nl; ++t)
        for (int j = 0; j < s.ll[t] && !s.shared[t]; ++j) s.shared[t] = s.cnt[s.lq[t * LX + j]] >= 2;
    }
    const int mcount = cf.bomb ? machine(caps) : 0;

    // every emission by (key, place in the JAX package's concatenation)
    int E = 0;
    for (int t = 0; t < nl; ++t) {
      if (s.shared[t]) continue;
      int len = s.ll[t];
      for (int lv = 0; lv < NL; ++lv) {
        s.ek[E] = lv * KSPAN + s.lo[t];
        s.ei[E] = lv * LM2 + t;
        ++E;
        const bool ck = cf.cookie && len >= 5;
        len -= 5;
        if (!(ck && len > 2)) break;
      }
    }
    for (int m = 0; m < mcount; ++m) {
      s.ek[E] = s.mkey[m];
      s.ei[E] = NL * LM2 + m;
      ++E;
    }
    for (int a = 1; a < E; ++a) {  // insertion sort: stable in (key, place)
      const int key = s.ek[a], src = s.ei[a];
      int b = a - 1;
      while (b >= 0 && (s.ek[b] > key || (s.ek[b] == key && s.ei[b] > src))) {
        s.ek[b + 1] = s.ek[b];
        s.ei[b + 1] = s.ei[b];
        --b;
      }
      s.ek[b + 1] = key;
      s.ei[b + 1] = src;
    }
    if (E > MM) caps |= kCapEmit;
    const int M = E < MM ? E : MM;
    for (int r = 0; r < M; ++r) {
      int* out = s.cells + r * CM;
      const int src = s.ei[r];
      if (src >= NL * LM2) {
        const int m = src - NL * LM2;
        s.len[r] = s.mlen[m];
        s.type[r] = s.mt[m];
        s.col[r] = s.mcol[m];
        for (int j = 0; j < s.mlen[m]; ++j) out[j] = s.mc[m * CM + j];
      } else {
        const int lv = src / LM2, t = src - lv * LM2;
        const int* line = s.lq + t * LX;
        const int len = s.ll[t] - 5 * lv;
        const bool ck = cf.cookie && len >= 5;
        const int keep = ck ? 5 : len;
        s.len[r] = keep;
        s.type[r] = ck ? kMatchCookie : (len == 4 ? laser_type(line) : kMatchNormal);
        s.col[r] = ck ? 0 : s.x[line[0]];
        for (int j = 0; j < keep; ++j) out[j] = line[5 * lv + j];
      }
    }
    return E;
  }

  // ---- 3. resolution (its serial parts) -------------------------------------
  // One special match's creation cell (`_creation_pos`).
  TMT_DEV int creation_cell(int m) {
    const int* c = s.cells + m * cf.cm();
    const int n = s.len[m], C = cf.C, CM = cf.cm();
    if (s.type[m] != kMatchBomb) {  // the (lower) middle of the free cells
      int nv = 0;
      for (int j = 0; j < n; ++j) nv += !s.taken[c[j]];
      const int pick = nv % 2 == 0 ? nv / 2 - 1 : nv / 2;
      for (int j = 0, cum = 0; j < n; ++j)
        if (!s.taken[c[j]] && cum++ == pick) return c[j];
      return c[0];
    }
    // the (mode row, mode column) corner if free, else the free cell
    // closest to it by squared distance, ties to the earliest
    int bx = -1, by = -1, cx = 0, cy = 0;
    for (int j = 0; j < n; ++j) {
      int nx = 0, ny = 0;
      for (int i = 0; i < n; ++i) {
        nx += row(c[i]) == row(c[j]);
        ny += col(c[i]) == col(c[j]);
      }
      if (nx > bx) {
        bx = nx;
        cx = row(c[j]);
      }
      if (ny > by) {
        by = ny;
        cy = col(c[j]);
      }
    }
    int best = -1;
    long long bkey = 0;
    for (int j = 0; j < n; ++j) {
      if (s.taken[c[j]]) continue;
      if (row(c[j]) == cx && col(c[j]) == cy) return cx * C + cy;
      const int dr = row(c[j]) - cx, dc = col(c[j]) - cy;
      const long long key = static_cast<long long>(dr * dr + dc * dc) * CM + j;
      if (best < 0 || key < bkey) {
        best = j;
        bkey = key;
      }
    }
    return best < 0 ? c[0] : c[best];
  }

  // 1. the creation cells of the special matches, before any deletion
  TMT_DEV void creations(int M) {
    for (int m = 0; m < M; ++m) {
      s.qcell[m] = -1;
      if (s.type[m] == kMatchNormal || s.type[m] == 0) continue;
      const int cell = creation_cell(m);
      s.taken[cell] = 1;
      s.qcell[m] = cell;
    }
  }

  // 3. the new specials; cells that two matches picked take the sums.
  // Returns their number.
  TMT_DEV int new_specials(int M) {
    const int g = ++gen;
    int created = 0;
    for (int mm = 0; mm < M; ++mm) {
      const int cell = s.qcell[mm];
      if (cell < 0) continue;
      ++created;
      const int kd = s.type[mm] == kMatchCookie ? kKindCookie : s.type[mm];
      if (s.mark[cell] != g) {
        s.mark[cell] = g;
        s.x[cell] = 0;
        s.k[cell] = 0;
      }
      s.x[cell] += s.col[mm];
      s.k[cell] += kd;
    }
    return created;
  }

  // Lines and classification; the matches' count, the cap bits and the
  // lines detected go to s.meta.
  TMT_DEV void matches(int sr0) {
    int total = 0;
    const int nl = lines(sr0, total);
    int caps = total > cf.LM ? kCapLines : 0;
    s.meta[0] = classify(nl, caps);
    s.meta[1] = caps;
    s.meta[2] = total;
  }
};

// 2. of resolution, on the whole warp: match by match, delete up to the
// first special and run the activation machine (machine.cuh) from it.
// Leaves the resolved board in s.x / s.k.
template <class W, class Ln>
TMT_DEV void resolve(const W& w, TripSmem<Ln>& s, const TripConfig& cf, Serial<Ln>& ser,
                     TripResult& res) {
  const int count = s.meta[0], CM = cf.cm(), M = count < cf.lm2() ? count : cf.lm2();
  w.each([&](int i) { s.taken[i] = 0; });
  w.each_of(1, [&](int) { ser.creations(M); });
  Machine<W, Ln> mc{w, s.L, s.x, s.k, s.ccount, s.frames, cf.K, cf.SM};
  mc.count_colours();
  int m = 0;
  while (mc.sp > 0 || m < count) {
    if (mc.sp > 0) {
      mc.step();
      continue;
    }
    // every lane finds the same first special of the matches from m on
    int ms = -1, fs = 0;
    for (int mm = m; mm < M && ms < 0; ++mm)
      for (int j = 0; j < s.len[mm]; ++j)
        if (is_special(s.k[s.cells[mm * CM + j]])) {
          ms = mm;
          fs = j;
          break;
        }
    const int upto = ms < 0 ? M : ms;
    for (int mm = m; mm < upto; ++mm) mc.erase_list(s.cells + mm * CM, s.len[mm]);
    if (ms < 0) {
      m = count;
      continue;
    }
    mc.erase_list(s.cells + ms * CM, fs);
    const int cell = s.cells[ms * CM + fs];
    mc.push(s.k[cell], cell, 1);
    m = ms;
  }
  res.act = mc.act;
  res.ovf |= mc.ovf;
  res.caps |= mc.caps;
  w.each_of(1, [&](int) { s.meta[3] = ser.new_specials(M); });
  res.created = s.meta[3];
}

// One trip of board s.x / s.k (t: the board's trips so far; (s0, s1): its
// sub key).  Leaves the board after refill in s.x / s.k; returns the
// eliminations.
template <class W, class Ln>
TMT_DEV int trip_program(const W& w, TripSmem<Ln>& s, const TripConfig& cf, uint32_t s0,
                         uint32_t s1, int t, TripResult& res) {
  const Ln& L = s.L;
  const int n = L.n();
  w.each([&](int i) { s.mark[i] = 0; });
  const int sr0 = line_masks(w, L, s.x);
  if (sr0 >= 0) detect(w, L, sr0);
  Serial<Ln> ser{s, cf, 0};
  w.each_of(1, [&](int) { ser.matches(sr0); });
  res.caps = s.meta[1];
  res.lines = s.meta[2];
  res.ovf = res.caps != 0;
  resolve(w, s, cf, ser, res);
  const int elim = n - w.count([&](int i) { return s.k[i] != 0; });
  gravity(w, L, s.y, s.yk, s.x, s.k, s.emp, [&](int i) {
    s.y[i] = s.x[i];
    s.yk[i] = s.k[i];
    return s.x[i] == 0 && s.k[i] == 0;
  });
  KeyRing ring{s.keys, -1};
  refill(w, n, s.x, s.k, s.q, ring, s0, s1, t, static_cast<uint32_t>(cf.K),
         randint_mult(static_cast<uint32_t>(cf.K)));
  return elim;
}

TMT_HOST_DEV bool trip_takes(const TripConfig& cf) {
  return takes(cf.R, cf.C) && cf.R * cf.C <= 65535 && cf.K >= 1 && cf.K <= 65535 && cf.LM >= 1 &&
         cf.SM >= 1;
}

}  // namespace tmt

// Scratch of one board, in bytes.
extern "C" long long tmt_specials_trip_smem(int R, int C, int K, int LM, int SM) {
  const tmt::TripConfig cf{R, C, K, LM, SM, true, true, true, true};
  return static_cast<long long>(tmt::trip_bytes<tmt::Geometry>(cf));
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

struct TripOut {
  int *colour, *kind, *elim, *act, *created;
  bool* ovf;
  int *caps, *lines;
};

template <class Ln>
__global__ void __launch_bounds__(32)
    specials_trip_kernel(const int* __restrict__ colour_in, const int* __restrict__ kind_in,
                         const long long* __restrict__ sub_keys, const int* __restrict__ trips,
                         TripOut out, unsigned char* scratch, size_t scratch_bytes,
                         tmt::TripConfig cf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t b = blockIdx.x;
  tmt::TripSmem<Ln> s;
  s.carve(scratch != nullptr ? scratch + b * scratch_bytes : smem, cf);
  const int n = s.L.n();
  const tmt::Warp w{n, static_cast<int>(threadIdx.x)};
  w.each([&](int i) {
    s.x[i] = colour_in[b * n + i];
    s.k[i] = kind_in[b * n + i];
  });
  tmt::TripResult res{0, 0, 0, 0, 0};
  const int elim = tmt::trip_program(w, s, cf, static_cast<uint32_t>(sub_keys[2 * b]),
                                     static_cast<uint32_t>(sub_keys[2 * b + 1]), trips[b], res);
  w.each([&](int i) {
    out.colour[b * n + i] = s.x[i];
    out.kind[b * n + i] = s.k[i];
  });
  if (w.leader()) {  // lane 0 ran the serial part: res is its own
    out.elim[b] = elim;
    out.act[b] = res.act;
    out.created[b] = res.created;
    out.ovf[b] = res.ovf != 0;
    out.caps[b] = res.caps;
    out.lines[b] = res.lines;
  }
}

const auto kernel = specials_trip_kernel<tmt::Geometry>;

}  // namespace

// Boards in flight per SM at R x C with the default caps (lines_max R + C,
// stack_max R*C + 8) and K colours, from the occupancy calculator (0 when
// a board's scratch does not fit shared memory: it then runs from device
// memory).
extern "C" int tmt_specials_trip_occupancy(int R, int C, int K) {
  const tmt::TripConfig cf{R, C, K, R + C, R * C + 8, true, true, true, true};
  const size_t smem = tmt::trip_bytes<tmt::Geometry>(cf);
  int blocks = 0;
  if (!tmt::trip_takes(cf) || tmt::allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Launches the kernel for B boards on `stream`; returns the cudaError_t of
// the launch (0 on success).  colour/kind in and out: int32[B, R, C];
// sub_keys: int64[B, 2] threefry words; trips: int32[B]; elim, act,
// created, caps, lines: int32[B]; ovf: bool[B].  scratch: null to keep
// each board's scratch in shared memory, else B * tmt_specials_trip_smem
// bytes of device memory.
extern "C" int tmt_specials_trip(const int* colour_in, const int* kind_in, const long long* sub_keys,
                                 const int* trips, int* colour_out, int* kind_out, int* elim,
                                 int* act, int* created, bool* ovf, int* caps, int* lines,
                                 void* scratch, int B, int R, int C, int K, int LM, int SM,
                                 int cookie, int v_laser, int h_laser, int bomb, void* stream) {
  if (B == 0) return 0;
  const tmt::TripConfig cf{R, C, K, LM, SM, cookie != 0, v_laser != 0, h_laser != 0, bomb != 0};
  if (!tmt::trip_takes(cf)) return cudaErrorInvalidValue;
  const size_t bytes = tmt::trip_bytes<tmt::Geometry>(cf);
  const size_t smem = scratch != nullptr ? 0 : bytes;
  const cudaError_t err = tmt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TripOut out{colour_out, kind_out, elim, act, created, ovf, caps, lines};
  kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      colour_in, kind_in, sub_keys, trips, out, static_cast<unsigned char*>(scratch), bytes, cf);
  return static_cast<int>(cudaGetLastError());
}

#else  // host build (TMT_HOST_BUILD): the same board program, board by board

#include <vector>

// As tmt_specials_trip, on the host, with the card's arguments but the
// stream: each board's scratch at scratch + b * tmt_specials_trip_smem
// bytes, or (a null scratch) in a buffer of its own.  Returns 0, or -1 for
// a board or config the library does not take.
extern "C" int tmt_specials_trip_host(const int* colour_in, const int* kind_in,
                                      const long long* sub_keys, const int* trips, int* colour_out,
                                      int* kind_out, int* elim, int* act, int* created, bool* ovf,
                                      int* caps, int* lines, void* scratch, int B, int R, int C,
                                      int K, int LM, int SM, int cookie, int v_laser, int h_laser,
                                      int bomb) {
  const tmt::TripConfig cf{R, C, K, LM, SM, cookie != 0, v_laser != 0, h_laser != 0, bomb != 0};
  if (!tmt::trip_takes(cf)) return -1;
  const int n = R * C;
  const tmt::Warp w{n};
  const size_t bytes = tmt::trip_bytes<tmt::Geometry>(cf);
  std::vector<uint64_t> own(scratch != nullptr ? 0 : bytes / 8 + 2);
  tmt::TripSmem<tmt::Geometry> s;
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    s.carve(scratch != nullptr ? static_cast<unsigned char*>(scratch) + b * bytes
                               : reinterpret_cast<unsigned char*>(own.data()),
            cf);
    for (int i = 0; i < n; ++i) {
      s.x[i] = colour_in[b * n + i];
      s.k[i] = kind_in[b * n + i];
    }
    tmt::TripResult res{0, 0, 0, 0, 0};
    elim[b] = tmt::trip_program(w, s, cf, static_cast<uint32_t>(sub_keys[2 * b]),
                                static_cast<uint32_t>(sub_keys[2 * b + 1]), trips[b], res);
    for (int i = 0; i < n; ++i) {
      colour_out[b * n + i] = s.x[i];
      kind_out[b * n + i] = s.k[i];
    }
    act[b] = res.act;
    created[b] = res.created;
    ovf[b] = res.ovf != 0;
    caps[b] = res.caps;
    lines[b] = res.lines;
  }
  return 0;
}

#endif
