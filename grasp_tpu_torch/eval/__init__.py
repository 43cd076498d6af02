"""Generation helpers of the port (counterpart of grasp_tpu.eval)."""
