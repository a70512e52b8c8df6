"""Sharding: the spec rules of the model's parameters, batches and caches
on a device mesh (``partition``), the fleet tick's lane split
(``partition.fleet_mesh`` / ``shard_fleet_tick``) and the activation
roles (``api``)."""
