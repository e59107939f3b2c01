"""Launchers: the train / serve CLI (:mod:`.train`)."""
