"""Artifact I/O helpers (counterpart of ``data_diet_distributed_tpu/utils``)."""
