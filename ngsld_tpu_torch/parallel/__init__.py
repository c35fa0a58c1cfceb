"""Sweeps of the torch engine beyond one device's plain block run
(ngsld_tpu/parallel): the ring, on one device or across site blocks
(ring.py); the ranks, groups, launch and the ring's exchange of a
multi-device run (mesh.py); the --shard_ind steps, the gathered-pair step
(sweep.py) and the strip step (strip_ind.py), whose per-individual sums
are all-reduced over a 'pairs' row."""
