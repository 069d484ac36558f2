"""The port's gate tools (counterparts of the JAX package's ``tools/``):
``parity_check``, ``kernel_coverage`` and ``truncation_audit``, each run
as ``python -m tile_match_tpu_torch.tools.<name>``."""
