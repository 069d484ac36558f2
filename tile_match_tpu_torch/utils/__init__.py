"""Analysis and debug utilities (counterpart of ``tile_match_tpu.utils``)."""

from .print_board_diffs import format_boards, highlight_board_diff
from .state_counts import compute_num_states, get_tabular_obs, is_valid_states

__all__ = [
    "compute_num_states",
    "is_valid_states",
    "get_tabular_obs",
    "format_boards",
    "highlight_board_diff",
]
