"""LM training: the train and serve step factories (:mod:`.step`) and the
fault-tolerant loop (:mod:`.loop`)."""
