"""Roofline of one step on the NVIDIA H100 (the port of ``repro.roofline``):
per-device counts of a step run on a fake world (:mod:`.count`), its
collectives (:mod:`.collectives`), the three-term bound (:mod:`.analysis`)
and the dry run's tables (:mod:`.report`)."""
