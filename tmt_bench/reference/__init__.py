"""The plain reference of the benchmark: the game's batched step in plain
PyTorch, which the benchmark holds the program's outputs against.

A frozen copy of the port's plain CPU path as the benchmark was defined
(``config``, ``random``, ``runs``, ``lines``, ``board_ops``, ``classify``,
``resolve``, ``activate``, the plain half of ``combination`` and the
general ``effective_mask``), with its imports made local and every kernel
branch dropped, and an engine (``engine``) written down from the per-board
game: the plain cascade loop, the original game's move mask, no
compaction.  It imports nothing of the program, so no later change to the
program changes it.
"""
