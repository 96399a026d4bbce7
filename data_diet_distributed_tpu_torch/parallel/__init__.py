"""Data parallelism over ``torch.distributed`` (counterpart of
``data_diet_distributed_tpu/parallel/``): ``mesh.py`` (the process group, the
geometry check, ZeRO-1 and the sharded weight update's layout) and
``collectives.py`` (the collectives the port runs)."""
