"""Training of the port (the port of ``repro.train``): optimizers, gradient
compression and the train-step factory."""
