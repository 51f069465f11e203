"""Forms of traffic, one module each, found by a mix's ``kind``
(see :mod:`portbench.generate`)."""
