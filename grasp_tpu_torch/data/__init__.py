"""Tokenizer and calibration data (counterpart of grasp_tpu/data)."""
