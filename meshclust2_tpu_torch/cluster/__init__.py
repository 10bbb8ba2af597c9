"""Device-resident clustering state (the port of meshclust2_tpu/cluster/
device_session.py)."""
