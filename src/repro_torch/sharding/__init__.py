"""Logical-axis sharding rules (:mod:`.rules`) and the explicit
collectives of the mesh path (:mod:`.collectives`)."""
