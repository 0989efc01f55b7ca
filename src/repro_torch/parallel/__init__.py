"""Parallelism of the port over ``torch.distributed`` ranks: the model
axis of serving and the data axis of training (``parallel.sharding``,
``parallel.zero``, ``parallel.compression``)."""
