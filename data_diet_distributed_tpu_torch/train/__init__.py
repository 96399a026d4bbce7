"""Training (counterpart of ``data_diet_distributed_tpu/train``)."""
