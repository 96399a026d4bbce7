"""Artifact I/O, statistics and size helpers (counterpart of
``data_diet_distributed_tpu/utils``)."""
