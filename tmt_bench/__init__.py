"""The benchmark of the PyTorch/CUDA port (``tile_match_tpu_torch``) on one
NVIDIA H100: board-steps per second and the step's tail over whole
episodes, auto-resets included, for the cells ``BENCHMARK.json`` names.

One run of one cell: ``python3 tmt_bench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>`` (``run.py``).  The pieces, each found by
name: a configuration is ``configs/<file>.json`` (the game's sizes,
specials and guarantees), a traffic mix ``traffic/<name>.json`` (batch,
policy, auto-reset, warm-up), a metric ``metrics/<name>.py`` (its
reader).  ``harness`` drives the program (``program.PortProgram``),
``check`` holds its outputs against the plain reference (``reference/``,
which imports nothing of the program), ``control`` runs the control.
Imports neither JAX nor the JAX package.
"""
