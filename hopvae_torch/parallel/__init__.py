"""Data and pattern parallelism over ``torch.distributed`` (``mesh``)."""
