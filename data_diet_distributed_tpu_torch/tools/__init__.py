"""The card host's tools: the port's copies of the JAX package's
``tools/make_shards.py``, ``npz_to_npy.py``, ``score_report.py``,
``trace_report.py``, ``request_report.py``, ``run_monitor.py``, of its
tuning tools ``autotune.py``, ``bisect_grand.py``, ``profile_dispatch.py``,
``perf_sentry.py`` and ``validate_duty.py``, of its drivers ``e2e_demo.py``
(the prune demo), ``imagenet_soak.py`` (config 5's ingestion and the
elastic fault soak) and ``serve_soak.py`` (the serving fleet's fault
cycles), and of the stdlib ``validate_metrics.py`` and
``serve_client.py``, each run as ``python -m
data_diet_distributed_tpu_torch.tools.<name>`` with the JAX tool's arguments
and output, and importing no JAX. The tuning tools and the drivers run on
``--device cuda`` unless told ``--device cpu`` and pass it to every child."""
