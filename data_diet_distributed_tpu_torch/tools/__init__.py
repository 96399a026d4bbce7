"""The card host's tools: the port's copies of the JAX package's
``tools/make_shards.py``, ``npz_to_npy.py``, ``score_report.py``,
``trace_report.py``, ``request_report.py``, ``run_monitor.py`` and of its
tuning tools ``autotune.py``, ``bisect_grand.py``, ``profile_dispatch.py``,
``perf_sentry.py`` and ``validate_duty.py``, each run as ``python -m
data_diet_distributed_tpu_torch.tools.<name>`` with the JAX tool's arguments
and output, and importing no JAX. The tuning tools run on ``--device cuda``
unless told ``--device cpu`` and pass it to every child."""
