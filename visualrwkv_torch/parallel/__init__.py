"""Multi-process training: process groups, the ``(data, seq, model)`` mesh,
collectives and ZeRO sharding."""
