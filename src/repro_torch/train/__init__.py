"""Training state, step and the single-device loop of the port."""
