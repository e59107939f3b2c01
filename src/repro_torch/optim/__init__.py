"""Optimizers: AdamW with its schedule and clipping (:mod:`.adamw`), and
int8 gradient compression with error feedback (:mod:`.compress`)."""
