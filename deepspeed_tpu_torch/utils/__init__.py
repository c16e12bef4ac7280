"""Offline tools over checkpoints, PyTorch port (``zero_to_fp32``)."""
