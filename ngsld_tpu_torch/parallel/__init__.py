"""Site-sharded sweeps of the torch engine (ngsld_tpu/parallel): the ring
on one device (ring.py)."""
