// The specials cascade's simple trips for Hopper (sm_90a), one warp per
// board.
//
// Replaces the TPU kernel `cascade_sp_chunk` of
// tile_match_tpu/ops/pallas_cascade.py:1434 (call :1488, body
// `_cascade_sp_kernel` :1256, with `_union_mask_tile(want_aux=True)`, the
// case table `_simple_trip_tile`, the activation closure and
// `_gravity_two_tile`).  Its plain PyTorch version is `cascade_sp_reference`
// in tile_match_tpu_torch/ops/cascade_sp.py; the outputs of the two are
// equal bit for bit, all nine.
//
// What it computes, per board: while the board holds a >= 3 run, is not
// frozen, has run fewer than `max_cascades` trips and fewer than `limit`
// in this call, one trip —
//   1. detection and the union of the detected lines (csrc/trip.cuh);
//   2. the case table: per-line aggregates (counts, firsts and sums over a
//      cell's colour run in its row, over its column, over its row) decide
//      whether every line classifies in closed form, which cells create
//      which special and which union cells survive; any other shape freezes
//      the board with its reason bits.  Without the bomb no line pairs with
//      another, and one phase classifies every line by its length alone
//      (`case_table_no_bomb` in the plain version);
//   3. the activation closure of the lasers and bombs among the deleted
//      cells: four expansions and a convergence check; a cookie in it, or
//      no convergence, freezes the board;
//   4. delete, create, count; stable gravity of both channels (a cookie is
//      not empty); refill with randint(fold_in(sub, trips), (R, C), 1, K+1),
//      JAX's threefry (csrc/threefry.cuh).
//
// What bounds it on the card: not memory — a 10x10 board is 800 bytes in
// and 820 bytes out, a 0.008 ms bound at B=16384.  A trip is ~25 dependent
// warp phases of integer work on the board in shared memory, and a board
// runs its trips one after another: latency and synchronisation, times
// each board's own trips, and a launch lasts at least as long as its
// longest board.  The design:
//   - one warp per board (`Warp`, csrc/block.cuh), 32 boards in flight per
//     SM, each freeing its slot at its own last trip; a phase ends in
//     __syncwarp() and every reduction is one warp vote, with no block
//     barrier and no shared atomic;
//   - the board's shape fixed at compile time: the build makes one
//     library for each shape of at most 32 by 32 that runs, with index
//     arithmetic by constants and every bit helper one 32-bit window; any
//     larger board runs one library whose geometry is read at run time
//     (`Geometry`, csrc/trip.cuh);
//   - every run length, extension reach, union cover, per-run and
//     per-column aggregate and closure region is a count, first set bit or
//     test on row-major and column-major cell bit masks built by ballots,
//     in place of walks over rows and columns; the rare per-line sums
//     (survivor and target cells) visit only the set bits;
//   - the case table runs on the union cells alone, compacted, since no
//     other cell can freeze, create or be deleted;
//   - flags and codes in bytes: 4,792 bytes of shared memory a 10x10
//     board;
//   - the closure runs only when the trip deletes a special, and stops at
//     its fixed point; the refill keys of 32 trips are hashed at once, one
//     trip a lane, and each empty cell's two hashes run on a pair of lanes.
// The TPU's lean tier for large boards, its trip chunks and its lane
// transposes are gone.
//
// Limits: the board's working set fits a block's shared memory (~31 bytes
// a cell at 36x36: boards up to ~7,400 cells); input boards hold no empty
// cell.

// The board program is large: its cell loops stay rolled (block.cuh).
#define TMT_NO_UNROLL

#include "trip.cuh"

namespace tmt {

// freeze reasons (ops/cascade_sp.py REASON_*)
constexpr int kLen5 = 1, kExt4 = 2, kExtBomb = 4, kCookieHit = 8, kUnconverged = 16,
              kCross = 32, kMulti = 64;

// flag bits of the per-cell flag bytes, by the phase that writes them
constexpr int kCovH = 1, kCovV = 2, kUnion = 4;                      // fc
constexpr int kHasE3 = 1, kInitA = 2, kPartB = 4, kV3Top = 8;        // fd
constexpr int kCr33 = 1, kCr43 = 2, kCrv4 = 4, kCrossLeaf = 8, kHckOk = 16, kVckOk = 32,
              kExtVl = 64;                                           // fe
constexpr int kDele = 1, kRegion = 2;                                // fk

struct Config {
  int R, C, K, max_cascades, limit;
  bool cookie, v_laser, h_laser, bomb;
};

// Shared memory of one board.
template <class Ln>
struct Smem {
  Ln L;
  int *x, *k, *y, *yk;                 // the board, and the board after delete and create
  uint8_t *fc, *fd, *fe, *fk, *rb;     // flags, freeze reasons
  int8_t* code;                        // special created at the cell (-1: cookie)
  uint16_t* q;                         // compacted empty cells
  uint32_t* keys;                      // KeyRing words
  // cell masks (rm: row-major, cm: column-major)
  uint32_t *cross, *crossc, *chc, *mv57c;            // detection extras
  uint32_t *e3u2, *e3u1, *cvu0, *ext4a, *ext4b;      // table, per run (rm)
  uint32_t *thc, *tsc, *h4f, *hruns;                 // table, per row or run (rm)
  uint32_t *pb4c, *crv4c, *extvlc;                   // table, per column (cm)
  uint32_t *sa, *sb, *svc, *k3, *k4, *emp;           // closure, gravity
  // per column and per row values
  int *col_ngh, *col_ncrv, *col_ncv, *col_topg, *col_vck, *col_tsr, *col_crv4, *col_tgt,
      *col_v;
  int *row_nch, *row_thc, *row_tsc, *row_h;

  TMT_HOST_DEV size_t carve(unsigned char* base, int R, int C) {
    const int n = R * C, w = mask_words(n);
    Arena a{base, 0};
    L.carve(a, R, C);
    int** cell[4] = {&x, &k, &y, &yk};
    for (auto p : cell) *p = a.take<int>(n);
    uint8_t** flag[5] = {&fc, &fd, &fe, &fk, &rb};
    for (auto p : flag) *p = a.take<uint8_t>(n);
    code = a.take<int8_t>(n);
    q = a.take<uint16_t>(n);
    keys = a.take<uint32_t>(4 * 32);
    uint32_t** mask[22] = {&cross, &crossc, &chc, &mv57c, &e3u2, &e3u1, &cvu0, &ext4a,
                           &ext4b, &thc, &tsc, &h4f, &hruns, &pb4c, &crv4c, &extvlc,
                           &sa, &sb, &svc, &k3, &k4, &emp};
    for (auto p : mask) *p = a.take<uint32_t>(w);
    int** col[9] = {&col_ngh, &col_ncrv, &col_ncv, &col_topg, &col_vck, &col_tsr, &col_crv4,
                    &col_tgt, &col_v};
    for (auto p : col) *p = a.take<int>(C);
    int** row[4] = {&row_nch, &row_thc, &row_tsc, &row_h};
    for (auto p : row) *p = a.take<int>(R);
    return a.used;
  }
};

template <class Ln>
TMT_HOST_DEV size_t smem_bytes(int R, int C) {
  Smem<Ln> s;
  return s.carve(nullptr, R, C);
}

struct BoardState {
  int trips, elim, frozen, created, activated, reasons;
  bool active;
};

// The board's cascade; s.x / s.k hold the board on entry and on exit.
template <class W, class Ln>
TMT_DEV void cascade_sp_program(const W& w, const Smem<Ln>& s, const Config& cf, uint32_t key0,
                                uint32_t key1, BoardState& st) {
  const Ln& L = s.L;
  const int R = L.R(), C = L.C(), n = L.n(), nw = mask_words(n);
  const int h_code = cf.h_laser ? 3 : (cf.v_laser ? 2 : 0);
  const int v_code = cf.v_laser ? 2 : 0;
  const uint32_t mult = randint_mult(static_cast<uint32_t>(cf.K));
  int* x = s.x;
  int* k = s.k;
  KeyRing ring{s.keys, -1};

  auto mh = [&](int q) { return bit(L.mh, q); };
  auto mv = [&](int q) { return bit(L.mv, q); };
  auto ch = [&](int q) { return bit(L.ch, q); };
  auto cv = [&](int q) { return bit(L.cv, q); };
  auto prim = [&](int q) { return bit(L.p, q); };
  auto in5_7 = [](int len) { return len >= 5 && len <= 7; };
  // the row-major range [lo, hi) of cell q's colour run along its row
  auto run_lo = [&](int q) { return q - L.lc(q); };
  auto run_hi = [&](int q) { return q + L.rc(q) + 1; };

  for (int t = 0; t < cf.limit; ++t) {
    if (st.frozen != 0 || st.trips >= cf.max_cascades) break;
    const int sr0 = line_masks(w, L, x);
    if (sr0 < 0) break;

    // ---- 1. detection ----------------------------------------------------
    // the union cells, in order, into s.q: the case table writes only
    // theirs, every other cell keeps the zeros written here
    detect(w, L, sr0);
    int m = w.compact(n, s.q, [&](int i) {
      bool cov_h, cov_v;
      L.cover(x, i, cov_h, cov_v);
      const bool uni = prim(i) || ((cov_h || cov_v) && x[i] > 0);
      s.fc[i] = (cov_h ? kCovH : 0) | (cov_v ? kCovV : 0) | (uni ? kUnion : 0);
      s.fd[i] = s.fe[i] = s.rb[i] = s.fk[i] = 0;
      s.code[i] = 0;
      return uni;
    });

    // ---- 2. the case table -----------------------------------------------
    if (!cf.bomb) {
      // every line by its length: a 4-line lasers at its second cell, a
      // 5..8-line with the cookie on cookies at its third; a cell survives
      // only in the tail of a 6- or 7-line and in no other line's cells but
      // its tail; lines of 9 or more and extensions of 4 or more freeze the
      // board
      w.each_of(m, [&](int e) {
        const int i = s.q[e];
        const bool memh = mh(i), memv = mv(i);
        const int lc = L.lc(i), uc = L.uc(i);
        const int hli = L.hl(i), vli = L.vl(i);
        const bool len_bad = cf.cookie && ((memh && hli >= 9) || (memv && vli >= 9));
        const bool ext_bad = (ch(i) && L.hext(i) >= 4) || (cv(i) && L.vext(i) >= 4);
        s.rb[i] = (len_bad ? kLen5 : 0) | (ext_bad ? kExt4 : 0);
        const bool h4 = h_code != 0 && memh && hli == 4 && lc == 1;
        const bool v4 = v_code != 0 && memv && vli == 4 && uc == 1;
        const bool ck = cf.cookie && ((memh && hli >= 5 && hli <= 8 && lc == 2) ||
                                      (memv && vli >= 5 && vli <= 8 && uc == 2));
        const bool h_tail = cf.cookie && memh && (hli == 6 || hli == 7) && lc >= 5;
        const bool v_tail = cf.cookie && memv && (vli == 6 || vli == 7) && uc >= 5;
        const bool keep = (h_tail || v_tail) && (h_tail || !memh) && (v_tail || !memv) &&
                          !ch(i) && !cv(i);
        s.code[i] = static_cast<int8_t>(h4 ? h_code : v4 ? v_code : ck ? -1 : 0);
        s.fk[i] = (s.fc[i] & kUnion) && !keep ? kDele : 0;
      });
    } else {
      w.each_of(nw, [&](int q) { s.cross[q] = L.mh[q] & L.mv[q]; });
      // the extensions a run's aggregates count (rm, at cell q), and the
      // column masks (cm, at column-major index q)
      {
        uint32_t* const masks[8] = {s.e3u2, s.e3u1, s.cvu0, s.ext4a, s.ext4b,
                                    s.crossc, s.chc, s.mv57c};
        w.ballots(n, masks, [&](int q) {
          const int i = L.rm(q);
          int out = (bit(s.cross, i) ? 32 : 0) | (ch(i) ? 64 : 0) |
                    (cf.cookie && mv(i) && in5_7(L.vl(i)) ? 128 : 0);
          if (!cv(q)) return out;
          const int ue = L.ue(q), vx = L.vext(q), lc = L.lc(q);
          const bool e3 = vx == 3 && ue >= 1, ext4 = vx == 4;
          return out | (e3 && ue == 2 ? 1 : 0) | (e3 && ue == 1 ? 2 : 0) | (ue == 0 ? 4 : 0) |
                 (ext4 && (ue == 1 || (ue == 0 && lc == 1)) ? 8 : 0) |
                 (ext4 && (ue == 1 || (ue == 0 && lc == 2)) ? 16 : 0);
        });
      }
      // column and row aggregates
      w.each_of(C + R, [&](int e) {
        if (e < C) {
          const int lo = e * R, hi = lo + R;
          const int ngh = L.popc(s.chc, lo, hi), ncrv = L.popc(s.crossc, lo, hi);
          const int top = L.first(s.chc, lo, hi);
          s.col_ngh[e] = ngh;
          s.col_ncrv[e] = ncrv;
          s.col_ncv[e] = L.popc(L.cvc, lo, hi);
          s.col_topg[e] = top < 0 ? -1 : top - lo;
          // does this column hold a cookie-centre v-line?
          s.col_vck[e] = ngh + ncrv >= 1 && L.any(s.mv57c, lo, hi);
        } else {
          const int lo = (e - C) * C;
          s.row_nch[e - C] = L.popc(L.ch, lo, lo + C);
        }
      });
      // per-cell aggregates over the cell's horizontal colour run
      w.each_of(m, [&](int e) {
        const int i = s.q[e];
        const int r = L.row(i), c = L.col(i), lo = run_lo(i), hi = run_hi(i);
        const int ngv = L.popc(L.cv, lo, hi), ncrh = L.popc(s.cross, lo, hi);
        const bool has_e3 = L.any(s.e3u2, lo, hi) || L.any(s.e3u1, lo, hi);
        const bool h_star = mh(i) && ngv >= 1 && ncrh == 0;
        // the extension-3 initiator: the highest reach, then the leftmost
        const int f2 = L.first(s.e3u2, lo, hi);
        const bool initA = i == (f2 >= 0 ? f2 : L.first(s.e3u1, lo, hi)) && h_star;
        const bool partB = i == L.first(s.cvu0, lo, hi) && h_star && !has_e3 && L.hl(i) == 3;
        const bool v3_top = ch(i) && L.vl(i) == 3 && s.col_ncrv[c] == 0 && r == s.col_topg[c];
        s.fd[i] = (has_e3 ? kHasE3 : 0) | (initA ? kInitA : 0) | (partB ? kPartB : 0) |
                  (v3_top ? kV3Top : 0);
      });
      {
        // h-extension targets and survivors (rm, at cell q), v-extension
        // partners (cm, at column-major index q)
        uint32_t* const masks[3] = {s.thc, s.tsc, s.pb4c};
        w.ballots(n, masks, [&](int q) {
          const int i = L.rm(q);
          const int out = (s.fd[i] & kPartB) && L.vext(i) == 4 ? 4 : 0;
          if (!ch(q) || L.hext(q) != 4) return out;
          const int c = L.col(q);
          const bool v3 = (s.fd[q] & kV3Top) != 0;
          const bool v_star = mv(q) && s.col_ngh[c] >= 1 && s.col_ncrv[c] == 0;
          return out | ((v_star && !v3) || (s.col_vck[c] && L.vl(q) >= 5) ? 1 : 0) | (v3 ? 2 : 0);
        });
      }
      w.each_of(m, [&](int e) {
        const int i = s.q[e];
        const int r = L.row(i), c = L.col(i), lo = run_lo(i), hi = run_hi(i);
        const bool memh = mh(i), memv = mv(i), crs = bit(s.cross, i), cdh = ch(i), cdv = cv(i);
        const int hli = L.hl(i), vli = L.vl(i), hx = L.hext(i), vx = L.vext(i), uc = L.uc(i);
        const int n_gh_col = s.col_ngh[c], n_crv_col = s.col_ncrv[c];
        const int nsh_v = n_gh_col + n_crv_col;
        const int n_gv_run = L.popc(L.cv, lo, hi), n_crh_run = L.popc(s.cross, lo, hi);
        const int nsh_h = n_gv_run + n_crh_run;
        const bool has_e3 = (s.fd[i] & kHasE3) != 0;
        const bool partB = (s.fd[i] & kPartB) != 0;

        const bool multi = (!prim(i) && (s.fc[i] & kCovH) && (s.fc[i] & kCovV)) ||
                           (cdh && s.row_nch[r] >= 2) || (cdv && s.col_ncv[c] >= 2) ||
                           (memh && n_gv_run >= 1 && n_crh_run >= 1) ||
                           (memh && n_crh_run >= 2) || (memv && n_crv_col >= 2);
        const bool ext_bad = (cdh && hx >= 5) || (cdv && vx >= 5);
        const bool v4_star_bad = cdh && vli == 4 && hx == 4 && uc == 1;
        const bool v_ck_ok = cf.cookie && memv && in5_7(vli) && nsh_v >= 1;
        const bool v_ck_bad = cdh && in5_7(vli) && hx == 4 && uc == 2;
        const bool v_ck_col = s.col_vck[c] != 0;
        const bool cross_leaf = crs && v_ck_col && nsh_h == 1 && (hli == 3 || hli == 4);
        const bool h_star = memh && n_gv_run >= 1 && n_crh_run == 0;
        // length-4 extensions that shift a laser / cookie pick
        const bool ext4_a = L.any(s.ext4a, lo, hi), ext4_b = L.any(s.ext4b, lo, hi);
        const bool h4_star_bad = h_star && hli == 4 && !has_e3 && ext4_a;
        const bool h_ck_ok =
            cf.cookie && memh && in5_7(hli) && nsh_h >= 1 && n_crh_run == 0 && !has_e3;
        const bool h_ck_bad = memh && in5_7(hli) && (has_e3 || ext4_b) && n_gv_run >= 1;
        const bool shared_h = memh && nsh_h >= 1;
        const bool shared_v = memv && nsh_v >= 1;
        bool len_bad;
        if (cf.cookie) {
          len_bad = (memh && hli >= 9) || (memv && vli >= 9) || (shared_h && hli == 8) ||
                    (shared_v && vli == 8) ||
                    (shared_h && in5_7(hli) && !(h_ck_ok && !h_ck_bad)) ||
                    (shared_v && in5_7(vli) && !v_ck_ok);
        } else {
          len_bad = (shared_h && hli >= 5) || (shared_v && vli >= 5);
        }
        const bool cr_pair = crs && nsh_h == 1 && nsh_v == 1;
        const bool cr33 = cr_pair && hli == 3 && vli == 3;
        const bool cr43 = cr_pair && hli == 4 && vli == 3;
        const bool crv4 = cr_pair && vli == 4 && (hli == 3 || hli == 4);
        const bool cross_bad = crs && !(cr33 || cr43 || crv4 || cross_leaf);
        const bool star_bad = v4_star_bad || (v_ck_bad && v_ck_col) || h4_star_bad ||
                              (cdh && hx <= 4 && vli == 3 && n_crv_col >= 1);
        s.rb[i] = (len_bad ? kLen5 : 0) | (ext_bad ? kExt4 : 0) |
                  (star_bad || h_ck_bad ? kExtBomb : 0) | (cross_bad ? kCross : 0) |
                  (multi ? kMulti : 0);
        const bool ext_vl = cdv && vx == 4 && h_star && !partB;
        s.fe[i] = (cr33 ? kCr33 : 0) | (cr43 ? kCr43 : 0) | (crv4 ? kCrv4 : 0) |
                  (cross_leaf ? kCrossLeaf : 0) | (h_ck_ok ? kHckOk : 0) |
                  (v_ck_ok ? kVckOk : 0) | (ext_vl ? kExtVl : 0);
      });
      {
        uint32_t* const masks[4] = {s.h4f, s.hruns, s.crv4c, s.extvlc};
        w.ballots(n, masks, [&](int q) {  // rm at cell q, cm at column-major index q
          const int fe = s.fe[q], fe_c = s.fe[L.rm(q)];
          const bool h4 = L.hl(q) == 4;
          return (((fe & kCrv4) && h4) || (fe & kCrossLeaf) ? 1 : 0) |
                 ((fe & kCr43) || ((s.fd[q] & kInitA) && h4) ? 2 : 0) |
                 ((fe_c & kCrv4) ? 4 : 0) | ((fe_c & kExtVl) ? 8 : 0);
        });
      }
      // the targets and survivors of extensions, per column and per row:
      // sums over the few cells that have one
      w.each_of(C + R, [&](int e) {
        if (e < C) {
          const int lo = e * R, hi = lo + R;
          int tsr = 0, tgt = 0;  // survivor row of a length-4 v-extension partner, laser row
          for (int j = L.first(s.pb4c, lo, hi); j >= 0; j = L.first(s.pb4c, j + 1, hi))
            tsr += j - lo + L.up(L.erv, j) + 1;
          for (int j = L.first(s.extvlc, lo, hi); j >= 0;
               j = L.first(s.extvlc, j + 1, hi))
            tgt += j - lo - L.down(L.elv, j - 1) + 2;
          s.col_tsr[e] = tsr;
          s.col_tgt[e] = tgt;
          s.col_crv4[e] = L.any(s.crv4c, lo, hi);
        } else {
          const int lo = (e - C) * C, hi = lo + C;
          int thc = 0, tsc = 0;  // h-extension laser target and survivor columns
          for (int g = L.first(s.thc, lo, hi); g >= 0; g = L.first(s.thc, g + 1, hi))
            thc += g - lo - L.le(g) + 2;
          for (int g = L.first(s.tsc, lo, hi); g >= 0; g = L.first(s.tsc, g + 1, hi)) {
            const int le = L.le(g), re = L.re(g);
            tsc += (re > le ? g - lo + re : g - lo - le) + 1;
          }
          s.row_thc[e - C] = thc;
          s.row_tsc[e - C] = tsc;
        }
      });

      // creations and survivors, on the union cells and the laser targets
      m = w.compact(n, s.q, [&](int i) {
        const int r = L.row(i), c = L.col(i);
        return (s.fc[i] & kUnion) || r + 1 == s.col_tgt[c] || c + 1 == s.row_thc[r];
      });
      w.each_of(m, [&](int e) {
        const int i = s.q[e];
        const int r = L.row(i), c = L.col(i), lo = run_lo(i), hi = run_hi(i);
        const bool memh = mh(i), memv = mv(i), crs = bit(s.cross, i);
        const int hli = L.hl(i), vli = L.vl(i), lc = L.lc(i), uc = L.uc(i);
        const int n_gh_col = s.col_ngh[c], n_crv_col = s.col_ncrv[c];
        const int nsh_v = n_gh_col + n_crv_col;
        const int n_gv_run = L.popc(L.cv, lo, hi), n_crh_run = L.popc(s.cross, lo, hi);
        const int nsh_h = n_gv_run + n_crh_run;
        const int fd = s.fd[i], fe = s.fe[i];
        const bool has_e3 = fd & kHasE3, initA = fd & kInitA;
        const bool bomb = (fe & (kCr33 | kCr43)) || (fd & (kV3Top | kPartB)) ||
                          (initA && (hli == 3 || hli == 4));
        const bool v4 = memv && vli == 4 && uc == 1 &&
                        (nsh_v == 0 || s.col_crv4[c] || (n_gh_col >= 1 && n_crv_col == 0));
        const bool h4_flag =
            L.any(s.h4f, lo, hi) || (n_gv_run >= 1 && n_crh_run == 0 && !has_e3);
        const bool h4 = memh && hli == 4 && lc == 1 && (nsh_h == 0 || h4_flag);
        const bool vl_cells = v_code != 0 && (v4 || r + 1 == s.col_tgt[c]);
        const bool hl_cells = h_code != 0 && (h4 || c + 1 == s.row_thc[r]);
        const bool ck = cf.cookie &&
                        ((memh && hli >= 5 && hli <= 8 && lc == 2 &&
                          (nsh_h == 0 || (fe & kHckOk))) ||
                         (memv && vli >= 5 && vli <= 8 && uc == 2 &&
                          (nsh_v == 0 || (fe & kVckOk))));
        bool keep = false;
        if (memh) {  // survivor column of the run's h-run bomb pick
          int sc_b = 0;
          for (int g = L.first(s.hruns, lo, hi); g >= 0; g = L.first(s.hruns, g + 1, hi)) {
            const int q = g - r * C, lg = L.lc(g), rg = L.rc(g);
            sc_b += (rg > lg ? q + rg : q - lg) + 1;
          }
          keep = c + 1 == sc_b;
        }
        keep = keep || (c + 1 == s.row_tsc[r] && !prim(i));
        keep = keep || (r + 1 == s.col_tsr[c] && !prim(i));
        if (cf.cookie) {
          keep = keep || (memh && (hli == 6 || hli == 7) && lc >= 5 &&
                          (nsh_h == 0 || (fe & kHckOk)) && !cv(i) && !crs && !memv);
          keep = keep || (memv && (vli == 6 || vli == 7) && uc >= 5 &&
                          (nsh_v == 0 || (fe & kVckOk)) && !ch(i) && !crs && !memh);
        }
        s.code[i] = static_cast<int8_t>(bomb ? 4 : vl_cells ? v_code : hl_cells ? h_code : ck ? -1 : 0);
        s.fk[i] = (s.fc[i] & kUnion) && !keep ? kDele : 0;
      });
    }
    // freeze reasons and deleted specials: only the cells in s.q have any
    int bits = 0, spec = 0;
    w.each_of(m, [&](int e) {
      const int i = s.q[e];
      bits |= s.rb[i];
      spec += (s.fk[i] & kDele) && k[i] != 1;
    });
    const int table_bits = w.lanes_or(bits);

    // ---- 3. the activation closure ----------------------------------------
    const int n_spec = w.lanes_sum(spec);
    bool bad_sp = false, unconverged = false;
    int act_n = 0;
    if (n_spec > 0) {  // with no special deleted, every region is empty
      bad_sp = w.any([&](int i) { return (s.fk[i] & kDele) && k[i] == -1; });
      uint32_t* S = s.sa;
      uint32_t* S_next = s.sb;
      {
        uint32_t* const masks[3] = {S, s.k3, s.k4};
        w.ballots(n, masks, [&](int i) {
          return ((s.fk[i] & kDele) && k[i] > 1 ? 1 : 0) | (k[i] == 3 ? 2 : 0) |
                 (k[i] == 4 ? 4 : 0);
        });
      }
      // per column "an active v-laser", per row "an active h-laser"
      auto lines_of = [&](const uint32_t* Sm) {
        w.ballot(n, s.svc, [&](int j) {
          const int i = L.rm(j);
          return bit(Sm, i) && k[i] == 2;
        });
        w.each_of(C + R, [&](int e) {
          if (e < C)
            s.col_v[e] = L.any(s.svc, e * R, e * R + R);
          else
            s.row_h[e - C] = L.any(Sm, (e - C) * C, (e - C) * C + C, s.k3);
        });
      };
      // is cell i in the region of an active special: its column's
      // v-lasers, its row's h-lasers, the bombs of its 3x3
      auto region = [&](const uint32_t* Sm, int i) {
        const int r = L.row(i), c = L.col(i);
        if (s.col_v[c] || s.row_h[r]) return true;
        const int c0 = c > 0 ? c - 1 : 0, c1 = c + 1 < C ? c + 2 : C;
        for (int rr = r > 0 ? r - 1 : 0; rr <= r + 1 && rr < R; ++rr)
          if (L.any(Sm, rr * C + c0, rr * C + c1, s.k4)) return true;
        return false;
      };
      // four expansions; one that adds nothing leaves every later one the
      // same, and col_v / row_h already those of S
      bool fresh = false;
      for (int e = 0; e < 4 && !fresh; ++e) {
        lines_of(S);
        bool hit_cookie = false, grew = false;
        w.ballot(n, S_next, [&](int i) {
          const bool hit = region(S, i) && k[i] != 1 && k[i] != 0;
          const bool add = hit && k[i] > 1 && !bit(S, i);
          hit_cookie = hit_cookie || (hit && k[i] == -1);
          grew = grew || add;
          return bit(S, i) || add;
        });
        bad_sp = w.lanes_any(hit_cookie) || bad_sp;
        fresh = !w.lanes_any(grew);
        uint32_t* tmp = S;
        S = S_next;
        S_next = tmp;
      }
      if (!fresh) lines_of(S);
      bool hit_cookie = false, open = false;
      int act = 0;
      w.each([&](int i) {
        const bool reg = region(S, i);
        s.fk[i] |= reg ? kRegion : 0;
        hit_cookie = hit_cookie || (reg && k[i] == -1);
        open = open || (reg && k[i] > 1 && !bit(S, i));
        act += bit(S, i);
      });
      bad_sp = w.lanes_any(hit_cookie) || bad_sp;
      unconverged = w.lanes_any(open);
      act_n = w.lanes_sum(act);
    }
    const bool act_lane = n_spec > 0 && !bad_sp && !unconverged;
    const bool simple = table_bits == 0 && (n_spec == 0 || act_lane);
    if (!simple) {
      st.frozen = 1;
      st.reasons |= table_bits | (bad_sp ? kCookieHit : 0) |
                    (unconverged && !bad_sp ? kUnconverged : 0);
      break;
    }

    // ---- 4. delete, create, gravity, refill --------------------------------
    // delete and create into y / yk (a cookie is not empty), then gravity
    int n_dele = 0, n_created = 0;
    gravity(w, L, s.y, s.yk, x, k, s.emp, [&](int i) {
      const int cd = s.code[i];
      const bool d = (s.fk[i] & kDele) || (act_lane && (s.fk[i] & kRegion));
      n_dele += d;
      n_created += cd != 0;
      const int yc = cd != 0 ? (cd == -1 ? 0 : x[i]) : (d ? 0 : x[i]);
      const int yk = cd != 0 ? cd : (d ? 0 : k[i]);
      s.y[i] = yc;
      s.yk[i] = yk;
      return yc == 0 && yk == 0;
    });
    n_dele = w.lanes_sum(n_dele);
    n_created = w.lanes_sum(n_created);
    st.elim += n_dele - n_created;
    st.created += n_created;
    st.activated += act_n;
    refill(w, n, x, k, s.q, ring, key0, key1, st.trips, static_cast<uint32_t>(cf.K), mult);
    st.trips += 1;
  }
  st.active = line_masks(w, L, x) >= 0;
}

}  // namespace tmt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

// 32 boards (warps) an SM: ptxas keeps each thread within 64 registers
template <class Ln>
__global__ void __launch_bounds__(32, 32)
    cascade_sp_kernel(const int* __restrict__ colour_in, const int* __restrict__ kind_in,
                      const long long* __restrict__ sub_keys, const int* __restrict__ trips_in,
                      const int* __restrict__ elim_in, const int* __restrict__ frozen_in,
                      int* __restrict__ colour_out, int* __restrict__ kind_out,
                      int* __restrict__ trips_out, int* __restrict__ elim_out,
                      int* __restrict__ new_out, int* __restrict__ act_out,
                      int* __restrict__ frozen_out, bool* __restrict__ active_out,
                      int* __restrict__ reasons_out, tmt::Config cf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t b = blockIdx.x;
  tmt::Smem<Ln> s;
  s.carve(smem, cf.R, cf.C);
  const int n = s.L.n();
  const tmt::Warp w{n, static_cast<int>(threadIdx.x)};
  w.each([&](int i) {
    s.x[i] = colour_in[b * n + i];
    s.k[i] = kind_in[b * n + i];
  });
  tmt::BoardState st{trips_in[b], elim_in[b], frozen_in[b], 0, 0, 0, false};
  tmt::cascade_sp_program(w, s, cf, static_cast<uint32_t>(sub_keys[2 * b]),
                          static_cast<uint32_t>(sub_keys[2 * b + 1]), st);
  w.each([&](int i) {
    colour_out[b * n + i] = s.x[i];
    kind_out[b * n + i] = s.k[i];
  });
  if (w.leader()) {
    trips_out[b] = st.trips;
    elim_out[b] = st.elim;
    new_out[b] = st.created;
    act_out[b] = st.activated;
    frozen_out[b] = st.frozen;
    active_out[b] = st.active;
    reasons_out[b] = st.reasons;
  }
}

const auto kernel = cascade_sp_kernel<tmt::Geometry>;

}  // namespace

// Shared memory of one board, in bytes.
extern "C" long long tmt_cascade_sp_chunk_smem(int R, int C) {
  return static_cast<long long>(tmt::smem_bytes<tmt::Geometry>(R, C));
}

// Boards in flight per SM at R x C, from the occupancy calculator (0 when
// a board does not fit).
extern "C" int tmt_cascade_sp_chunk_occupancy(int R, int C) {
  const size_t smem = tmt::smem_bytes<tmt::Geometry>(R, C);
  int blocks = 0;
  if (!tmt::takes(R, C) || tmt::allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Launches the kernel for B boards on `stream`; returns the cudaError_t of
// the launch (0 on success).  colour/kind in and out: int32[B, R, C];
// sub_keys: int64[B, 2] threefry words; trips/elim/frozen in, and every
// other output: int32[B] (active: bool[B]).
extern "C" int tmt_cascade_sp(const int* colour_in, const int* kind_in, const long long* sub_keys,
                              const int* trips_in, const int* elim_in, const int* frozen_in,
                              int* colour_out, int* kind_out, int* trips_out, int* elim_out,
                              int* new_out, int* act_out, int* frozen_out, bool* active_out,
                              int* reasons_out, int B, int R, int C, int K, int max_cascades,
                              int limit, int cookie, int v_laser, int h_laser, int bomb,
                              void* stream) {
  if (B == 0) return 0;
  if (!tmt::takes(R, C) || R * C > 65535 || K < 1 || K > 65535) return cudaErrorInvalidValue;
  const size_t smem = tmt::smem_bytes<tmt::Geometry>(R, C);
  const tmt::Config cf{R, C, K, max_cascades, limit, cookie != 0, v_laser != 0, h_laser != 0,
                       bomb != 0};
  const cudaError_t err = tmt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      colour_in, kind_in, sub_keys, trips_in, elim_in, frozen_in, colour_out, kind_out, trips_out,
      elim_out, new_out, act_out, frozen_out, active_out, reasons_out, cf);
  return static_cast<int>(cudaGetLastError());
}

#else  // host build (TMT_HOST_BUILD): the same board program, board by board

#include <vector>

// As tmt_cascade_sp, on the host; returns 0, or -1 for a board shape the
// library's geometry does not take.
extern "C" int tmt_cascade_sp_host(const int* colour_in, const int* kind_in,
                                   const long long* sub_keys, const int* trips_in,
                                   const int* elim_in, const int* frozen_in, int* colour_out,
                                   int* kind_out, int* trips_out, int* elim_out, int* new_out,
                                   int* act_out, int* frozen_out, bool* active_out,
                                   int* reasons_out, int B, int R, int C, int K, int max_cascades,
                                   int limit, int cookie, int v_laser, int h_laser, int bomb) {
  if (!tmt::takes(R, C)) return -1;
  const int n = R * C;
  const tmt::Warp w{n};
  const tmt::Config cf{R, C, K, max_cascades, limit, cookie != 0, v_laser != 0, h_laser != 0,
                       bomb != 0};
  std::vector<uint64_t> smem(tmt::smem_bytes<tmt::Geometry>(R, C) / 8 + 2);
  tmt::Smem<tmt::Geometry> s;
  s.carve(reinterpret_cast<unsigned char*>(smem.data()), R, C);
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    for (int i = 0; i < n; ++i) {
      s.x[i] = colour_in[b * n + i];
      s.k[i] = kind_in[b * n + i];
    }
    tmt::BoardState st{trips_in[b], elim_in[b], frozen_in[b], 0, 0, 0, false};
    tmt::cascade_sp_program(w, s, cf, static_cast<uint32_t>(sub_keys[2 * b]),
                            static_cast<uint32_t>(sub_keys[2 * b + 1]), st);
    for (int i = 0; i < n; ++i) {
      colour_out[b * n + i] = s.x[i];
      kind_out[b * n + i] = s.k[i];
    }
    trips_out[b] = st.trips;
    elim_out[b] = st.elim;
    new_out[b] = st.created;
    act_out[b] = st.activated;
    frozen_out[b] = st.frozen;
    active_out[b] = st.active;
    reasons_out[b] = st.reasons;
  }
  return 0;
}

#endif
