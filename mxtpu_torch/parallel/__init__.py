"""Serving and parallelism of the port: the continuous-batching engines,
their page allocator and prefix index, and tensor parallelism over
``torch.distributed`` (``mesh``, ``collectives``, ``sharding``,
``decode.ShardedDecoder``)."""
