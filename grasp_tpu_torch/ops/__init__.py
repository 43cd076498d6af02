"""Projection math and kernels of the port (counterpart of grasp_tpu.ops)."""
