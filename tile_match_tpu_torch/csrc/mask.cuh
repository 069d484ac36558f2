// The settled effective-action mask of one action: exact is_move_effective
// semantics (`board.py:735-787` of the original game) on a board with no
// >= 3 run, one action at a time: the epilogue of the cascade kernel (K1,
// all-normal boards).  The settled-mask kernel (K3, mask_sp.cu) computes
// the same function for 32 actions at once from cell bit masks.
//
// A post-swap run must pass through a swapped cell: per swapped cell the 3
// perpendicular stencils and the 1 parallel stencil pointing away from the
// partner, 8 per action.  Each stencil also needs the kind of its last
// (rightmost or bottom) cell to be >= 0 — the post-swap kind when that cell
// is a swapped one — the cookie-end quirk of the original game.  With
// specials, a swap of two specials or of a cookie is always effective
// (`board.py:741-745`).
//
// `at(r, c)` gives the colour, -1 off the board; `kat(r, c)` the kind, 1 off
// the board.  Actions are in action-table order: C*(R-1) down-swaps
// row-major, then R*(C-1) right-swaps row-major.
#pragma once

#include "block.cuh"

namespace tmt {

TMT_DEV bool is_special_kind(int k) { return k != 0 && k != 1; }

template <class At, class KindAt>
TMT_DEV bool settled_action(int a, int R, int C, const At& at, const KindAt& kat,
                            bool any_special) {
  const int n_down = C * (R - 1);
  bool m;
  int kA, kB;
  if (a < n_down) {
    const int r = a / C, c = a % C;
    const int A = at(r, c), B = at(r + 1, c);
    kA = kat(r, c);
    kB = kat(r + 1, c);
    m = (at(r, c - 2) == B && at(r, c - 1) == B && kB >= 0) ||
        (at(r, c - 1) == B && at(r, c + 1) == B && kat(r, c + 1) >= 0) ||
        (at(r, c + 1) == B && at(r, c + 2) == B && kat(r, c + 2) >= 0) ||
        (at(r - 2, c) == B && at(r - 1, c) == B && kB >= 0) ||
        (at(r + 1, c - 2) == A && at(r + 1, c - 1) == A && kA >= 0) ||
        (at(r + 1, c - 1) == A && at(r + 1, c + 1) == A && kat(r + 1, c + 1) >= 0) ||
        (at(r + 1, c + 1) == A && at(r + 1, c + 2) == A && kat(r + 1, c + 2) >= 0) ||
        (at(r + 2, c) == A && at(r + 3, c) == A && kat(r + 3, c) >= 0);
  } else {
    const int j = a - n_down;
    const int r = j / (C - 1), c = j % (C - 1);
    const int A = at(r, c), B = at(r, c + 1);
    kA = kat(r, c);
    kB = kat(r, c + 1);
    m = (at(r - 2, c) == B && at(r - 1, c) == B && kB >= 0) ||
        (at(r - 1, c) == B && at(r + 1, c) == B && kat(r + 1, c) >= 0) ||
        (at(r + 1, c) == B && at(r + 2, c) == B && kat(r + 2, c) >= 0) ||
        (at(r, c - 2) == B && at(r, c - 1) == B && kB >= 0) ||
        (at(r - 2, c + 1) == A && at(r - 1, c + 1) == A && kA >= 0) ||
        (at(r - 1, c + 1) == A && at(r + 1, c + 1) == A && kat(r + 1, c + 1) >= 0) ||
        (at(r + 1, c + 1) == A && at(r + 2, c + 1) == A && kat(r + 2, c + 1) >= 0) ||
        (at(r, c + 2) == A && at(r, c + 3) == A && kat(r, c + 3) >= 0);
  }
  if (any_special) {
    m = m || (is_special_kind(kA) && is_special_kind(kB)) || kA < 0 || kB < 0;
  }
  return m;
}

}  // namespace tmt
