// The specials cascade's simple trips for Hopper (sm_90a), one thread block
// per board, one thread per cell.
//
// Replaces the TPU kernel `cascade_sp_chunk` of
// tile_match_tpu/ops/pallas_cascade.py (body `_cascade_sp_kernel`, with
// `_union_mask_tile(want_aux=True)`, the case table `_simple_trip_tile`,
// the activation closure and `_gravity_two_tile`).  Its plain PyTorch
// version is `cascade_sp_reference` in tile_match_tpu_torch/ops/
// cascade_sp.py; the outputs of the two are equal bit for bit, all nine.
//
// What it computes, per board: while the board holds a >= 3 run, is not
// frozen, has run fewer than `max_cascades` trips and fewer than `limit`
// in this call, one trip —
//   1. detection: run offsets of every cell, the lowest row anchoring a
//      line, primary cells, extension lengths and candidates, the union of
//      the detected lines;
//   2. the case table: per-line aggregates (sums and maxima over a cell's
//      colour run in its row, over its column, over its row) decide whether
//      every line classifies in closed form, which cells create which
//      special and which union cells survive; any other shape freezes the
//      board with its reason bits.  Without the bomb no line pairs with
//      another, and one phase classifies every line by its length alone
//      (`case_table_no_bomb` in the plain version);
//   3. the activation closure of the lasers and bombs among the deleted
//      cells: four expansions and a convergence check; a cookie in it, or
//      no convergence, freezes the board;
//   4. delete, create, count; stable gravity of both channels (a cookie is
//      not empty); refill with randint(fold_in(sub, trips), (R, C), 1, K+1),
//      JAX's threefry computed per cell (csrc/threefry.cuh).
//
// What bounds it on the card: not memory — a 10x10 board is 800 bytes in
// and 820 bytes out.  A trip is ~20 block barriers and, per cell, short
// walks over its row, column and run in shared memory, plus five threefry
// hashes per refilled cell: integer issue and barrier latency, times each
// board's own trips.  The design keeps the board and every intermediate in
// shared memory for the whole call and gives each board its own block, so
// a board stops at its own last trip; per-run aggregates are bounded walks
// over the run instead of the TPU's log-step shifted scans, and the TPU's
// lean tier for large boards, its trip chunks and its lane transposes are
// gone.
//
// Limits: R * C <= 1024; input boards hold no empty cell.

#include "block.cuh"
#include "threefry.cuh"

namespace tmt {

constexpr int kBig = 1 << 20;

// freeze reasons (ops/cascade_sp.py REASON_*)
constexpr int kLen5 = 1, kExt4 = 2, kExtBomb = 4, kCookieHit = 8, kUnconverged = 16,
              kCross = 32, kMulti = 64;

// flag bits of the per-cell flag words, by the phase that writes them
constexpr int kPrim = 1, kMemH = 2, kMemV = 4;                      // fa
constexpr int kCandH = 1, kCandV = 2;                                // fb
constexpr int kCovH = 1, kCovV = 2, kUnion = 4;                      // fc
constexpr int kHasE3 = 1, kInitA = 2, kPartB = 4, kV3Top = 8;        // fd
constexpr int kCr33 = 1, kCr43 = 2, kCrv4 = 4, kCrossLeaf = 8, kHckOk = 16, kVckOk = 32,
              kExtVl = 64;                                           // fe
constexpr int kDele = 1, kRegion = 2;                                // fk

struct Config {
  int R, C, K, max_cascades, limit;
  bool cookie, v_laser, h_laser, bomb;
};

// Shared arrays of one board: kCellArrays per cell, kColArrays per column,
// kRowArrays per row.
constexpr int kCellArrays = 24, kColArrays = 6, kRowArrays = 3;

struct Smem {
  int *x, *k, *y, *yk, *lc, *rc, *uc, *dc, *le, *re, *ue, *de;
  int *fa, *fb, *fc, *fd, *fe, *fk, *ngv, *ncrh, *code, *rb, *s0, *s1;
  int *col_ngh, *col_ncrv, *col_ncv, *col_topg, *col_vck, *col_tsr;
  int *row_nch, *row_thc, *row_tsc;

  TMT_DEV Smem(int* base, int R, int C) {
    const int n = R * C;
    int** cell[kCellArrays] = {&x, &k, &y, &yk, &lc, &rc, &uc, &dc, &le, &re, &ue, &de,
                               &fa, &fb, &fc, &fd, &fe, &fk, &ngv, &ncrh, &code, &rb, &s0, &s1};
    for (int j = 0; j < kCellArrays; ++j) *cell[j] = base + j * n;
    base += kCellArrays * n;
    int** col[kColArrays] = {&col_ngh, &col_ncrv, &col_ncv, &col_topg, &col_vck, &col_tsr};
    for (int j = 0; j < kColArrays; ++j) *col[j] = base + j * C;
    base += kColArrays * C;
    int** row[kRowArrays] = {&row_nch, &row_thc, &row_tsc};
    for (int j = 0; j < kRowArrays; ++j) *row[j] = base + j * R;
  }
};

TMT_HOST_DEV size_t smem_ints(int R, int C) {
  return static_cast<size_t>(kCellArrays) * R * C + kColArrays * C + kRowArrays * R;
}

struct BoardState {
  int trips, elim, frozen, created, activated, reasons;
  bool active;
};

// Does the board hold a >= 3 run anywhere?
template <class Blk>
TMT_DEV bool has_line(const Blk& blk, const int* x, int R, int C) {
  return blk.any([&](int i) {
    const int r = i / C, c = i % C, v = x[i];
    if (v <= 0) return false;
    return (c + 2 < C && x[i + 1] == v && x[i + 2] == v) ||
           (r + 2 < R && x[i + C] == v && x[i + 2 * C] == v);
  });
}

// The board's cascade; s.x / s.k hold the board on entry and on exit.
template <class Blk>
TMT_DEV void cascade_sp_program(const Blk& blk, const Smem& s, const Config& cf, uint32_t key0,
                                uint32_t key1, BoardState& st) {
  const int R = cf.R, C = cf.C;
  const int h_code = cf.h_laser ? 3 : (cf.v_laser ? 2 : 0);
  const int v_code = cf.v_laser ? 2 : 0;
  const uint32_t mult = randint_mult(static_cast<uint32_t>(cf.K));
  int* x = s.x;
  int* k = s.k;

  auto hl = [&](int q) { return s.lc[q] + s.rc[q] + 1; };
  auto vl = [&](int q) { return s.uc[q] + s.dc[q] + 1; };
  auto hext = [&](int q) { return 1 + s.le[q] + s.re[q]; };
  auto vext = [&](int q) { return 1 + s.ue[q] + s.de[q]; };
  auto prim = [&](int q) { return (s.fa[q] & kPrim) != 0; };
  auto mh = [&](int q) { return (s.fa[q] & kMemH) != 0; };
  auto mv = [&](int q) { return (s.fa[q] & kMemV) != 0; };
  auto cross = [&](int q) { return (s.fa[q] & (kMemH | kMemV)) == (kMemH | kMemV); };
  auto ch = [&](int q) { return (s.fb[q] & kCandH) != 0; };
  auto cv = [&](int q) { return (s.fb[q] & kCandV) != 0; };
  auto in5_7 = [](int len) { return len >= 5 && len <= 7; };

  for (int t = 0; t < cf.limit; ++t) {
    const bool lined = has_line(blk, x, R, C);
    if (!lined || st.frozen != 0 || st.trips >= cf.max_cascades) break;

    // ---- 1. detection ----------------------------------------------------
    blk.each([&](int i) {
      const int r = i / C, c = i % C, v = x[i];
      int l = 0, rr = 0, u = 0, d = 0;
      if (v > 0) {
        for (int q = c - 1; q >= 0 && x[r * C + q] == v; --q) ++l;
        for (int q = c + 1; q < C && x[r * C + q] == v; ++q) ++rr;
        for (int q = r - 1; q >= 0 && x[q * C + c] == v; --q) ++u;
        for (int q = r + 1; q < R && x[q * C + c] == v; ++q) ++d;
      }
      s.lc[i] = l;
      s.rc[i] = rr;
      s.uc[i] = u;
      s.dc[i] = d;
    });
    const int sr0 = blk.max(
        [&](int i) {
          const bool anchor = x[i] > 0 && (hl(i) >= 3 || (vl(i) >= 3 && s.dc[i] == 0));
          return anchor ? i / C : -1;
        },
        -1);
    blk.each([&](int i) {
      const int r = i / C, c = i % C;
      const int j = sr0 * C + c;  // this column's cell in the flag row
      const bool vflag = x[j] > 0 && vl(j) >= 3 && s.dc[j] == 0;
      const bool memv = vflag && sr0 - s.uc[j] <= r && r <= sr0;
      const bool memh = r == sr0 && x[i] > 0 && hl(i) >= 3;
      s.fa[i] = (memh || memv ? kPrim : 0) | (memh ? kMemH : 0) | (memv ? kMemV : 0);
    });
    blk.each([&](int i) {
      const int r = i / C, c = i % C, v = x[i];
      int l = 0, rr = 0, u = 0, d = 0;
      if (v > 0) {
        for (int q = c - 1; q >= 0 && x[r * C + q] == v && !prim(r * C + q); --q) ++l;
        for (int q = c + 1; q < C && x[r * C + q] == v && !prim(r * C + q); ++q) ++rr;
        for (int q = r - 1; q >= 0 && x[q * C + c] == v && !prim(q * C + c); --q) ++u;
        for (int q = r + 1; q < R && x[q * C + c] == v && !prim(q * C + c); ++q) ++d;
      }
      s.le[i] = l;
      s.re[i] = rr;
      s.ue[i] = u;
      s.de[i] = d;
      s.fb[i] = (prim(i) && 1 + l + rr >= 3 ? kCandH : 0) | (prim(i) && 1 + u + d >= 3 ? kCandV : 0);
    });
    blk.each([&](int i) {
      const int r = i / C, c = i % C;
      bool cov_h = false, cov_v = false;
      for (int q = 0; q < C; ++q) {
        const int g = r * C + q;
        if (ch(g) && ((q <= c && q + s.re[g] >= c) || (q >= c && q - s.le[g] <= c))) cov_h = true;
      }
      for (int q = 0; q < R; ++q) {
        const int g = q * C + c;
        if (cv(g) && ((q <= r && q + s.de[g] >= r) || (q >= r && q - s.ue[g] <= r))) cov_v = true;
      }
      const bool uni = prim(i) || ((cov_h || cov_v) && x[i] > 0);
      s.fc[i] = (cov_h ? kCovH : 0) | (cov_v ? kCovV : 0) | (uni ? kUnion : 0);
      if (r == 0) {  // column aggregates
        int ngh = 0, ncrv = 0, ncv = 0, topg = kBig;
        for (int q = R - 1; q >= 0; --q) {
          const int g = q * C + c;
          ngh += ch(g);
          ncrv += cross(g);
          ncv += cv(g);
          if (ch(g)) topg = q;
        }
        s.col_ngh[c] = ngh;
        s.col_ncrv[c] = ncrv;
        s.col_ncv[c] = ncv;
        s.col_topg[c] = topg;
      }
      if (c == 0) {  // row aggregates
        int nch = 0;
        for (int q = 0; q < C; ++q) nch += ch(r * C + q);
        s.row_nch[r] = nch;
      }
    });

    // ---- 2. the case table -----------------------------------------------
    if (!cf.bomb) {
      // every line by its length: a 4-line lasers at its second cell, a
      // 5..8-line with the cookie on cookies at its third; a cell survives
      // only in the tail of a 6- or 7-line and in no other line's cells but
      // its tail; lines of 9 or more and extensions of 4 or more freeze the
      // board
      blk.each([&](int i) {
        const bool memh = mh(i), memv = mv(i);
        const int hli = hl(i), vli = vl(i);
        const bool len_bad = cf.cookie && ((memh && hli >= 9) || (memv && vli >= 9));
        const bool ext_bad = (ch(i) && hext(i) >= 4) || (cv(i) && vext(i) >= 4);
        s.rb[i] = (len_bad ? kLen5 : 0) | (ext_bad ? kExt4 : 0);
        const bool h4 = h_code != 0 && memh && hli == 4 && s.lc[i] == 1;
        const bool v4 = v_code != 0 && memv && vli == 4 && s.uc[i] == 1;
        const bool ck = cf.cookie && ((memh && hli >= 5 && hli <= 8 && s.lc[i] == 2) ||
                                      (memv && vli >= 5 && vli <= 8 && s.uc[i] == 2));
        const bool h_tail = cf.cookie && memh && (hli == 6 || hli == 7) && s.lc[i] >= 5;
        const bool v_tail = cf.cookie && memv && (vli == 6 || vli == 7) && s.uc[i] >= 5;
        const bool keep = (h_tail || v_tail) && (h_tail || !memh) && (v_tail || !memv) &&
                          !ch(i) && !cv(i);
        s.code[i] = h4 ? h_code : v4 ? v_code : ck ? -1 : 0;
        const bool dele = (s.fc[i] & kUnion) && !keep;
        s.fk[i] = dele ? kDele : 0;
        s.s0[i] = dele && k[i] > 1;
      });
    } else {
      // per-cell aggregates over the cell's horizontal colour run [c0, c1]
      blk.each([&](int i) {
        const int r = i / C, c = i % C;
        const int c0 = c - s.lc[i], c1 = c + s.rc[i];
        int ngv = 0, ncrh = 0, ne3 = 0, max_init = -1, max_u0 = -1;
        for (int q = c0; q <= c1; ++q) {
          const int g = r * C + q;
          ngv += cv(g);
          ncrh += cross(g);
          const bool e3 = cv(g) && vext(g) == 3 && s.ue[g] >= 1;
          ne3 += e3;
          if (e3 && s.ue[g] * C + (C - 1 - q) > max_init) max_init = s.ue[g] * C + (C - 1 - q);
          if (cv(g) && s.ue[g] == 0 && C - 1 - q > max_u0) max_u0 = C - 1 - q;
        }
        s.ngv[i] = ngv;
        s.ncrh[i] = ncrh;
        const bool has_e3 = ne3 > 0;
        const bool h_star = mh(i) && ngv >= 1 && ncrh == 0;
        const bool e3 = cv(i) && vext(i) == 3 && s.ue[i] >= 1;
        const bool initA = e3 && s.ue[i] * C + (C - 1 - c) == max_init && h_star;
        const bool partB =
            cv(i) && s.ue[i] == 0 && C - 1 - c == max_u0 && h_star && !has_e3 && hl(i) == 3;
        const bool v3_top =
            ch(i) && vl(i) == 3 && s.col_ncrv[c] == 0 && r == s.col_topg[c];
        s.fd[i] = (has_e3 ? kHasE3 : 0) | (initA ? kInitA : 0) | (partB ? kPartB : 0) |
                  (v3_top ? kV3Top : 0);
        if (r == 0) {  // does this column hold a cookie-centre v-line?
          bool vck = false;
          const bool nsh_v = s.col_ngh[c] + s.col_ncrv[c] >= 1;
          for (int q = 0; q < R && cf.cookie; ++q) {
            const int g = q * C + c;
            vck = vck || (mv(g) && in5_7(vl(g)) && nsh_v);
          }
          s.col_vck[c] = vck;
        }
      });
      blk.each([&](int i) {
        const int r = i / C, c = i % C;
        const int c0 = c - s.lc[i], c1 = c + s.rc[i];
        const bool memh = mh(i), memv = mv(i), crs = cross(i), cdh = ch(i), cdv = cv(i);
        const int hli = hl(i), vli = vl(i), hx = hext(i), vx = vext(i);
        const int n_gh_col = s.col_ngh[c], n_crv_col = s.col_ncrv[c];
        const int nsh_v = n_gh_col + n_crv_col;
        const int n_gv_run = s.ngv[i], n_crh_run = s.ncrh[i];
        const int nsh_h = n_gv_run + n_crh_run;
        const bool has_e3 = (s.fd[i] & kHasE3) != 0;
        const bool partB = (s.fd[i] & kPartB) != 0;

        const bool multi = (!prim(i) && (s.fc[i] & kCovH) && (s.fc[i] & kCovV)) ||
                           (cdh && s.row_nch[r] >= 2) || (cdv && s.col_ncv[c] >= 2) ||
                           (memh && n_gv_run >= 1 && n_crh_run >= 1) ||
                           (memh && n_crh_run >= 2) || (memv && n_crv_col >= 2);
        const bool ext_bad = (cdh && hx >= 5) || (cdv && vx >= 5);
        const bool v4_star_bad = cdh && vli == 4 && hx == 4 && s.uc[i] == 1;
        const bool v_ck_ok = cf.cookie && memv && in5_7(vli) && nsh_v >= 1;
        const bool v_ck_bad = cdh && in5_7(vli) && hx == 4 && s.uc[i] == 2;
        const bool v_ck_col = s.col_vck[c] != 0;
        const bool cross_leaf = crs && v_ck_col && nsh_h == 1 && (hli == 3 || hli == 4);
        const bool h_star = memh && n_gv_run >= 1 && n_crh_run == 0;
        int n_ext4_a = 0, n_ext4_b = 0;  // len-4 exts that shift a laser / cookie pick
        for (int q = c0; q <= c1; ++q) {
          const int g = r * C + q;
          const bool ext4 = cv(g) && vext(g) == 4;
          n_ext4_a += ext4 && (s.ue[g] == 1 || (s.ue[g] == 0 && s.lc[g] == 1));
          n_ext4_b += ext4 && (s.ue[g] == 1 || (s.ue[g] == 0 && s.lc[g] == 2));
        }
        const bool h4_star_bad = h_star && hli == 4 && !has_e3 && n_ext4_a > 0;
        const bool h_ck_ok =
            cf.cookie && memh && in5_7(hli) && nsh_h >= 1 && n_crh_run == 0 && !has_e3;
        const bool h_ck_bad = memh && in5_7(hli) && (has_e3 || n_ext4_b > 0) && n_gv_run >= 1;
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
        if (r == 0) {  // survivor row of a length-4 v-extension partner
          int tsr = 0;
          for (int q = 0; q < R; ++q) {
            const int g = q * C + c;
            if ((s.fd[g] & kPartB) && vext(g) == 4) tsr += q + s.de[g] + 1;
          }
          s.col_tsr[c] = tsr;
        }
        if (c == 0) {  // h-extension laser target and survivor columns
          int thc = 0, tsc = 0;
          for (int q = 0; q < C; ++q) {
            const int g = r * C + q;
            const bool v_star = mv(g) && s.col_ngh[q] >= 1 && s.col_ncrv[q] == 0;
            const bool v3 = (s.fd[g] & kV3Top) != 0;
            if (ch(g) && hext(g) == 4 && ((v_star && !v3) || (s.col_vck[q] && vl(g) >= 5)))
              thc += q - s.le[g] + 2;
            if (v3 && hext(g) == 4)
              tsc += (s.re[g] > s.le[g] ? q + s.re[g] : q - s.le[g]) + 1;
          }
          s.row_thc[r] = thc;
          s.row_tsc[r] = tsc;
        }
      });

      // creations and survivors
      blk.each([&](int i) {
        const int r = i / C, c = i % C;
        const int c0 = c - s.lc[i], c1 = c + s.rc[i];
        const bool memh = mh(i), memv = mv(i), crs = cross(i);
        const int hli = hl(i), vli = vl(i);
        const int n_gh_col = s.col_ngh[c], n_crv_col = s.col_ncrv[c];
        const int nsh_v = n_gh_col + n_crv_col;
        const int n_gv_run = s.ngv[i], n_crh_run = s.ncrh[i];
        const int nsh_h = n_gv_run + n_crh_run;
        const int fd = s.fd[i], fe = s.fe[i];
        const bool has_e3 = fd & kHasE3, initA = fd & kInitA;
        const bool bomb = (fe & (kCr33 | kCr43)) || (fd & (kV3Top | kPartB)) ||
                          (initA && (hli == 3 || hli == 4));
        bool col_crv4 = false;
        int tgt_vr = 0;
        for (int q = 0; q < R; ++q) {
          const int g = q * C + c;
          col_crv4 = col_crv4 || (s.fe[g] & kCrv4);
          if (s.fe[g] & kExtVl) tgt_vr += q - s.ue[g] + 2;
        }
        const bool v4 = memv && vli == 4 && s.uc[i] == 1 &&
                        (nsh_v == 0 || col_crv4 || (n_gh_col >= 1 && n_crv_col == 0));
        int n_h4 = 0, sc_b = 0;
        for (int q = c0; q <= c1; ++q) {
          const int g = r * C + q;
          n_h4 += ((s.fe[g] & kCrv4) && hl(g) == 4) || (s.fe[g] & kCrossLeaf);
          const bool hrun_s = (s.fe[g] & kCr43) || ((s.fd[g] & kInitA) && hl(g) == 4);
          if (hrun_s) sc_b += (s.rc[g] > s.lc[g] ? q + s.rc[g] : q - s.lc[g]) + 1;
        }
        const bool h4_flag = n_h4 > 0 || (n_gv_run >= 1 && n_crh_run == 0 && !has_e3);
        const bool h4 = memh && hli == 4 && s.lc[i] == 1 && (nsh_h == 0 || h4_flag);
        const bool vl_cells = v_code != 0 && (v4 || r + 1 == tgt_vr);
        const bool hl_cells = h_code != 0 && (h4 || c + 1 == s.row_thc[r]);
        const bool ck = cf.cookie &&
                        ((memh && hli >= 5 && hli <= 8 && s.lc[i] == 2 &&
                          (nsh_h == 0 || (fe & kHckOk))) ||
                         (memv && vli >= 5 && vli <= 8 && s.uc[i] == 2 &&
                          (nsh_v == 0 || (fe & kVckOk))));
        bool keep = memh && c + 1 == sc_b;
        keep = keep || (c + 1 == s.row_tsc[r] && !prim(i));
        keep = keep || (r + 1 == s.col_tsr[c] && !prim(i));
        if (cf.cookie) {
          keep = keep || (memh && (hli == 6 || hli == 7) && s.lc[i] >= 5 &&
                          (nsh_h == 0 || (fe & kHckOk)) && !cv(i) && !crs && !memv);
          keep = keep || (memv && (vli == 6 || vli == 7) && s.uc[i] >= 5 &&
                          (nsh_v == 0 || (fe & kVckOk)) && !ch(i) && !crs && !memh);
        }
        s.code[i] = bomb ? 4 : vl_cells ? v_code : hl_cells ? h_code : ck ? -1 : 0;
        const bool dele = (s.fc[i] & kUnion) && !keep;
        s.fk[i] = dele ? kDele : 0;
        s.s0[i] = dele && k[i] > 1;
      });
    }
    const int table_bits = blk.bit_or([&](int i) { return s.rb[i]; });

    // ---- 3. the activation closure ----------------------------------------
    const int n_spec = blk.count([&](int i) { return (s.fk[i] & kDele) && k[i] != 1; });
    bool bad_sp = blk.any([&](int i) { return (s.fk[i] & kDele) && k[i] == -1; });
    auto region = [&](const int* S, int i) {
      const int r = i / C, c = i % C;
      for (int q = 0; q < R; ++q)
        if (S[q * C + c] && k[q * C + c] == 2) return true;
      for (int q = 0; q < C; ++q)
        if (S[r * C + q] && k[r * C + q] == 3) return true;
      for (int dr = -1; dr <= 1; ++dr)
        for (int dc = -1; dc <= 1; ++dc) {
          const int rr = r + dr, cc = c + dc;
          if (rr >= 0 && rr < R && cc >= 0 && cc < C && S[rr * C + cc] && k[rr * C + cc] == 4)
            return true;
        }
      return false;
    };
    int* S = s.s0;
    int* S_next = s.s1;
    for (int e = 0; e < 4; ++e) {
      const bool cookie_hit = blk.any([&](int i) {
        const bool hit = region(S, i) && k[i] != 1 && k[i] != 0;
        S_next[i] = S[i] || (hit && k[i] > 1);
        return hit && k[i] == -1;
      });
      bad_sp = bad_sp || cookie_hit;
      int* tmp = S;
      S = S_next;
      S_next = tmp;
    }
    blk.each([&](int i) { s.fk[i] |= region(S, i) ? kRegion : 0; });
    const bool cookie_hit = blk.any([&](int i) {
      return (s.fk[i] & kRegion) && k[i] == -1;
    });
    bad_sp = bad_sp || cookie_hit;
    const bool unconverged = blk.any([&](int i) {
      return (s.fk[i] & kRegion) && k[i] > 1 && !S[i];
    });
    const int act_n = blk.count([&](int i) { return S[i] != 0; });
    const bool act_lane = n_spec > 0 && !bad_sp && !unconverged;
    const bool simple = table_bits == 0 && (n_spec == 0 || act_lane);
    if (!simple) {
      st.frozen = 1;
      st.reasons |= table_bits | (bad_sp ? kCookieHit : 0) |
                    (unconverged && !bad_sp ? kUnconverged : 0);
      break;
    }

    // ---- 4. delete, create, gravity, refill --------------------------------
    auto dele = [&](int i) {
      return (s.fk[i] & kDele) || (act_lane && (s.fk[i] & kRegion));
    };
    const int n_dele = blk.count(dele);
    const int n_created = blk.count([&](int i) { return s.code[i] != 0; });
    blk.each([&](int i) {
      const int cd = s.code[i];
      const bool d = dele(i);
      s.y[i] = cd != 0 ? (cd == -1 ? 0 : x[i]) : (d ? 0 : x[i]);
      s.yk[i] = cd != 0 ? cd : (d ? 0 : k[i]);
    });
    st.elim += n_dele - n_created;
    st.created += n_created;
    st.activated += act_n;
    // stable gravity: an empty cell lands at the number of empties above
    // it, a tile moves down by the number of empties below it
    blk.each([&](int i) {
      const int r = i / C, c = i % C;
      auto empty = [&](int q) { return s.y[q] == 0 && s.yk[q] == 0; };
      int dest = 0;
      if (empty(i)) {
        for (int q = 0; q < r; ++q) dest += empty(q * C + c);
      } else {
        dest = r;
        for (int q = r + 1; q < R; ++q) dest += empty(q * C + c);
      }
      x[dest * C + c] = s.y[i];
      k[dest * C + c] = s.yk[i];
    });
    blk.each([&](int i) {
      if (x[i] == 0 && k[i] == 0) {
        x[i] = refill_colour(key0, key1, static_cast<uint32_t>(st.trips), static_cast<uint32_t>(i),
                             static_cast<uint32_t>(cf.K), mult);
        k[i] = 1;
      }
    });
    st.trips += 1;
  }
  st.active = has_line(blk, x, R, C);
}

}  // namespace tmt

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

__global__ void cascade_sp_kernel(const int* __restrict__ colour_in, const int* __restrict__ kind_in,
                                  const long long* __restrict__ sub_keys,
                                  const int* __restrict__ trips_in, const int* __restrict__ elim_in,
                                  const int* __restrict__ frozen_in, int* __restrict__ colour_out,
                                  int* __restrict__ kind_out, int* __restrict__ trips_out,
                                  int* __restrict__ elim_out, int* __restrict__ new_out,
                                  int* __restrict__ act_out, int* __restrict__ frozen_out,
                                  bool* __restrict__ active_out, int* __restrict__ reasons_out,
                                  tmt::Config cf) {
  extern __shared__ int smem[];
  __shared__ int scratch;
  const int n = cf.R * cf.C;
  const size_t b = blockIdx.x;
  const tmt::Block blk{n, static_cast<int>(threadIdx.x), &scratch};
  const tmt::Smem s(smem, cf.R, cf.C);
  blk.each([&](int i) {
    s.x[i] = colour_in[b * n + i];
    s.k[i] = kind_in[b * n + i];
  });
  tmt::BoardState st{trips_in[b], elim_in[b], frozen_in[b], 0, 0, 0, false};
  tmt::cascade_sp_program(blk, s, cf, static_cast<uint32_t>(sub_keys[2 * b]),
                          static_cast<uint32_t>(sub_keys[2 * b + 1]), st);
  blk.each([&](int i) {
    colour_out[b * n + i] = s.x[i];
    kind_out[b * n + i] = s.k[i];
  });
  if (threadIdx.x == 0) {
    trips_out[b] = st.trips;
    elim_out[b] = st.elim;
    new_out[b] = st.created;
    act_out[b] = st.activated;
    frozen_out[b] = st.frozen;
    active_out[b] = st.active;
    reasons_out[b] = st.reasons;
  }
}

}  // namespace

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
  const int n = R * C;
  if (n > 1024 || R < 1 || C < 1 || K < 1 || K > 65535) return cudaErrorInvalidValue;
  const int threads = ((n + 31) / 32) * 32;
  const size_t smem = tmt::smem_ints(R, C) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(cascade_sp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const tmt::Config cf{R, C, K, max_cascades, limit, cookie != 0, v_laser != 0, h_laser != 0,
                       bomb != 0};
  cascade_sp_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      colour_in, kind_in, sub_keys, trips_in, elim_in, frozen_in, colour_out, kind_out,
      trips_out, elim_out, new_out, act_out, frozen_out, active_out, reasons_out, cf);
  return static_cast<int>(cudaGetLastError());
}

#else  // host build (TMT_HOST_BUILD): the same board program, board by board

#include <vector>

extern "C" int tmt_cascade_sp_host(const int* colour_in, const int* kind_in,
                                   const long long* sub_keys, const int* trips_in,
                                   const int* elim_in, const int* frozen_in, int* colour_out,
                                   int* kind_out, int* trips_out, int* elim_out, int* new_out,
                                   int* act_out, int* frozen_out, bool* active_out,
                                   int* reasons_out, int B, int R, int C, int K, int max_cascades,
                                   int limit, int cookie, int v_laser, int h_laser, int bomb) {
  const int n = R * C;
  std::vector<int> smem(tmt::smem_ints(R, C));
  const tmt::Block blk{n};
  const tmt::Smem s(smem.data(), R, C);
  const tmt::Config cf{R, C, K, max_cascades, limit, cookie != 0, v_laser != 0, h_laser != 0,
                       bomb != 0};
  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    for (int i = 0; i < n; ++i) {
      s.x[i] = colour_in[b * n + i];
      s.k[i] = kind_in[b * n + i];
    }
    tmt::BoardState st{trips_in[b], elim_in[b], frozen_in[b], 0, 0, 0, false};
    tmt::cascade_sp_program(blk, s, cf, static_cast<uint32_t>(sub_keys[2 * b]),
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
