"""Model families of the port (counterpart of grasp_tpu.models)."""
