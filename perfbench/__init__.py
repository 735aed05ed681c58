"""The benchmark of ``minigrid_tpu_torch``: see ``perfbench/README.md``."""
