"""The benchmark of grasp_tpu_torch's serving engine (see run.py)."""
