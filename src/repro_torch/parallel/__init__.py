"""Mesh parallelism: the sharding rules and the collectives over a
``torch.distributed`` device mesh."""
