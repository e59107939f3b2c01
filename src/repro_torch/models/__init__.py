"""CNN specs, parameters and the host adapter (``cnn``, ``zoo``, ``cnn_host``)."""
