"""Data-parallel training across processes (port of
``deepmimic_mujoco_tpu/parallel``): one process per rank, parameters and
optimizer state replicated, each rank stepping its own contiguous slice of
the global env batch, the learners' gradients and statistics averaged with
``torch.distributed`` collectives."""
