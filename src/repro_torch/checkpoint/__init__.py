"""Crash-safe file primitives: atomic publishes and the append-only
journal (:mod:`.ckpt`)."""
