"""Models: the committee MLP potential and its parameter machinery."""
