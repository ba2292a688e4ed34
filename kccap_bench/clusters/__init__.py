"""Cluster generators, one module each, named by a configuration's
``cluster.kind``."""
