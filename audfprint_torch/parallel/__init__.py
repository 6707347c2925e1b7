"""Several shards of one table: the mesh and its collectives (mesh.py),
the bucket-sharded store, match, merge and fingerprint (sharded.py), and
the same across processes (multihost.py)."""
