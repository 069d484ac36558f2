"""The JAX package's examples on the port, each run as
``python -m tile_match_tpu_torch.examples.<name>`` with the same flags
(plus ``--device``, the card by default): ``random_baseline``, ``play``,
``q_learning_sweep``, ``dqn_train`` and ``scaling``."""
