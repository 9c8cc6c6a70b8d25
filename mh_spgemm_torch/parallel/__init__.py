"""Distributed SpGEMM of the port: meshes of shards and ``spgemm_dist``."""
