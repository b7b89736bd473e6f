"""Data-parallel training over torch.distributed (``data_parallel.py``)."""
