"""Model-axis tensor parallelism of the port (``parallel.sharding``)."""
