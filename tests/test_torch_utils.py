"""The port's ``utils`` against the JAX package's: state counts (the
original game's code's numbers, as ``tests/test_utils_models.py`` holds
them), the validity predicate board for board, the tabular key and the
board-diff strings character for character."""

import numpy as np
import pytest
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.utils import print_board_diffs as jdiffs
from tile_match_tpu.utils import state_counts as jcounts
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.utils import (
    compute_num_states,
    format_boards,
    get_tabular_obs,
    highlight_board_diff,
    is_valid_states,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("R,C,K,expect", [
    (3, 3, 2, (102, 102)),
    (3, 2, 2, (18, 36)),
    (3, 2, 3, (198, 576)),
    (4, 3, 2, (378, 378)),
    (3, 3, 3, (8514, 9750)),
])
def test_compute_num_states(R, C, K, expect):
    assert compute_num_states(R, C, K, batch_size=4096, device="cpu") == expect


def test_is_valid_states_matches_jax():
    rng = np.random.default_rng(0)
    colours = rng.integers(1, 4, size=(500, 4, 5)).astype(np.int32)
    got = is_valid_states(EnvConfig(4, 5, 3, 10), colours, device="cpu")
    want = jcounts.is_valid_states(JaxConfig(4, 5, 3, 10), colours)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[0].any() and not got[0].all() and not got[1].all()


def test_get_tabular_obs():
    board = np.arange(8).reshape(2, 2, 2)
    assert get_tabular_obs(board, 5) == jcounts.get_tabular_obs(board, 5) == (0, 1, 2, 3, 4, 5, 6, 7, 5)


def test_board_diff_strings_match_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 5, size=(2, 4, 6))
    b = a.copy()
    b[0, 1, 2] += 1
    b[1, 3, 5] = -1
    assert format_boards(a[0], b[0]) == jdiffs.format_boards(a[0], b[0])
    assert format_boards(a[0], b[0], gap=3) == jdiffs.format_boards(a[0], b[0], gap=3)
    assert highlight_board_diff(a[0], b[0]) == jdiffs.highlight_board_diff(a[0], b[0])
    assert highlight_board_diff(a, b) == jdiffs.highlight_board_diff(a, b)
    assert highlight_board_diff(a, b).count("\033[48;5;1m") == 2
