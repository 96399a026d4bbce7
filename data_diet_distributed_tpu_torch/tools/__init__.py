"""The card host's tools: the port's copies of the JAX package's
``tools/make_shards.py``, ``npz_to_npy.py``, ``score_report.py``,
``trace_report.py``, ``request_report.py`` and ``run_monitor.py``, each run as
``python -m data_diet_distributed_tpu_torch.tools.<name>`` with the JAX tool's
arguments and output, and importing no JAX."""
