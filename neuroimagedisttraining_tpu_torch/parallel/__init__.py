"""The device mesh, of one process or spanning the ranks of a process
group: client sharding and the ranks' exchange, silo-first aggregation,
gossip and spatial sharding (the reference package's ``parallel/``)."""
