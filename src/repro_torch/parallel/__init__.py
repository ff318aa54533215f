"""Mesh placement: the sharding rules (``sharding``) and the explicit
collectives and tensor-parallel context of the cells (``comm``)."""
