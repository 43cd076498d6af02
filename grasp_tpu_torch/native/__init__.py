"""Native (C++) runtime pieces of the port, built with g++ at first use and
loaded with ctypes (counterpart of grasp_tpu/native)."""

from grasp_tpu_torch.native.bindings import BatchServer, TokenStore, write_token_file  # noqa: F401
