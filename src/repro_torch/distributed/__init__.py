"""Distribution in the port: logical sharding rules and the manual-SPMD
context (``sharding``), gradient compression (``compression``) and the
cluster runtime's health, straggler and elastic-restart bookkeeping
(``runtime``), as ``repro/distributed/``."""
