"""Checkpoint/restart training loop, straggler watchdog and elastic re-mesh
(``fault_tolerance``); the population and data axes across ranks
(``sharding``); the int8 error-feedback all-reduce (``compression``)."""
