"""Serving layer of the port: batched generation (:mod:`.decode`).  The
market service comes with ROADMAP queue 1, item "The service"."""
