"""The benchmark's largest batch, config 1 at 131,072 boards
(``c1_rollout_b131072``), its largest board, 35x35 with 17 colours and the
vertical laser (``c5_rollout_b3000``), and the step on boards with a side
above 32 cells, all on the CPU: the step on the host builds of the
libraries whose geometry is read at run time (the build every board kernel
loads above 32x32), held to the plain reference step for step."""

import time

import pytest
import torch

from tile_match_tpu_torch import cuda_build
from tests.torch_port_helpers import host_kernels  # noqa: F401  (a fixture)
from tmt_bench import check, harness, manifest
from tmt_bench.program import PortProgram, ReferenceProgram
from tmt_bench.reference.random import key_of_seed
from tmt_bench.tests.helpers import BOARDS, CHUNK, CPU, tiny_cell

torch.set_num_threads(1)

# the kernels a step of a vertical-laser game launches on the card, the
# threefry words and the line test included
STEP_KERNELS = ("cascade_sp_chunk", "settled_mask_sp", "specials_trip", "combination_trip",
                "line_test", "threefry_words")


# each new cell: its configuration (rows, cols, colours, moves, specials),
# its batch, and the cell whose per-layer metrics it reports but for those
# of kernels it does not run
NEW_CELLS = {
    "c1_rollout_b131072": ("c1_10x10x4_no_specials", (10, 10, 4, 30, [], []), 131072,
                           "c1_rollout_b16384", ()),
    "c5_rollout_b3000": ("c5_35x35x17_vlaser", (35, 35, 17, 10, [], ["vertical_laser"]), 3000,
                         "c3_rollout_b16384", ("k1_roofline", "k4_boards_per_step")),
}


@pytest.mark.parametrize("name", sorted(NEW_CELLS))
def test_new_cell_is_its_configuration_at_its_batch(name):
    config, sizes, batch, like, left_out = NEW_CELLS[name]
    bench = manifest.load()
    cell = manifest.cell(bench, name)
    cfg = cell["config"]
    assert cfg["name"] == config
    assert (cfg["num_rows"], cfg["num_cols"], cfg["num_colours"], cfg["num_moves"],
            cfg["colourless_specials"], cfg["colour_specials"]) == sizes
    assert cell["traffic"]["batch"] == batch and cell["traffic"]["warmup_episodes"] == 1
    assert cell["workload"]["chips"] == 1
    assert {m["name"] for m in cell["end_to_end"]} == {"board_steps_per_s", "step_ms_p99", "setup_s"}
    same = manifest.cell(bench, like)
    assert ([m["name"] for m in cell["per_layer"]]
            == [m["name"] for m in same["per_layer"] if m["name"] not in left_out])
    c3 = manifest.cell(bench, "c3_rollout_b16384")["config"]
    assert cfg["guarantees"] == c3["guarantees"]


def test_tiny_run_of_c5_against_the_reference():
    """8 boards of 35x35x17 with the vertical laser, 3-move episodes, a
    window of 4 steps: an auto-reset is among the steps checked."""
    cell = tiny_cell("c5_rollout_b3000")
    cell["config"] = dict(cell["config"], num_moves=3)
    res = harness.run_cell(cell, 2**31 + 43, 0, False, CPU, PortProgram, time.time(), max_steps=4,
                           check_boards=BOARDS, check_chunk=CHUNK)
    checks = {c["name"]: c["value"] for c in res["checks"]}
    assert check.passed(res["checks"])
    assert checks["mismatches"] == 0 and checks["autoreset_steps_checked"] >= 1


@pytest.mark.parametrize("R,C", [(33, 9), (9, 33)])
def test_run_time_geometry_step_matches_the_reference(host_kernels, R, C):
    """A side of 33 cells (33x9: a column longer than one 32-bit window;
    9x33: a row wider than one), 17 colours, the vertical laser alone, 8
    boards: 25 steps of the port on the host builds of the libraries of any
    shape against the plain reference, every output of every board at every
    step, with two auto-resets."""
    assert cuda_build.shape_of(R, C) is None  # the library of any shape
    host_kernels(*STEP_KERNELS, shape=None)
    config = dict(num_rows=R, num_cols=C, num_colours=17, num_moves=10,
                  colourless_specials=[], colour_specials=["vertical_laser"])
    B = 8
    before = dict(cuda_build.launches)
    recs = []
    for cls in (PortProgram, ReferenceProgram):
        rec = harness.Recorder(torch.arange(B))
        harness.Loop(cls(config, torch.device("cpu"), 7), key_of_seed(2**31 + 41, "cpu"), B,
                     rec).run(25)
        recs.append(rec.stacked())
    port, ref = recs
    for f in harness.Recorder.FIELDS + ("action",):
        assert torch.equal(port[f], ref[f]), f
    assert int(ref["done"].any(-1).sum()) == 2  # regenerated at steps 10 and 20
    ran = {k for k in STEP_KERNELS if cuda_build.launches[k] > before[k]}
    assert ran >= {"cascade_sp_chunk", "settled_mask_sp", "combination_trip", "line_test",
                   "threefry_words"}
