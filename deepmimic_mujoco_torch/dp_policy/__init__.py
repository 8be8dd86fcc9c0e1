"""The original DeepMimic learning stack (port of ``deepmimic_mujoco_tpu/
dp_policy/``): the PPO and PG agents (fc_2layers_1024units actor-critic,
TF momentum, the clip-fraction stepsize rule), group normalizers, the
path-structured replay buffer, exploration annealing, the act-and-train
driver and the world that builds agents from JSON specs."""
