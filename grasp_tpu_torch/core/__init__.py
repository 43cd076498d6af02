"""The compression engine (counterpart of grasp_tpu/core)."""
