"""Launchers: the train CLI (:mod:`.train`), and process identity, publish
gating and the distributed table build's workers (:mod:`.distributed`)."""
