"""The device mesh of one process: client sharding, silo-first
aggregation, gossip and spatial sharding (the reference package's
``parallel/``)."""
