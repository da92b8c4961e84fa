"""Distribution of the port: the sharding rules and placements on a
DeviceMesh (``sharding.py``), attention per rank under ``local_map``
(``local_attention.py``), elastic resharding (``elastic.py``) and the
straggler watchdog (``straggler.py``)."""
