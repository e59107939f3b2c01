"""The deterministic synthetic data pipeline (:mod:`.pipeline`)."""
