"""The port's copy of the repo's ``examples/``: ``walkthrough.py``, the
scoring tour, run as ``python -m
data_diet_distributed_tpu_torch.examples.walkthrough`` on ``--device cuda``
unless told ``--device cpu``, importing no JAX."""
