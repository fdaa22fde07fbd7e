"""Checkpoint/restart training loop, straggler watchdog and elastic re-mesh
(``fault_tolerance``); the population axis across ranks (``sharding``)."""
