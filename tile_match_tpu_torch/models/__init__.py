"""Agents that train on the batched env (counterpart of
``tile_match_tpu.models``): DQN, DQN with replay, QR-DQN, the random
baseline and tabular Q-learning."""
