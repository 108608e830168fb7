"""The benchmark's own machinery: cells and configurations found by name,
seeded weights and traffic, the client loop over the port's scheduler,
the yardstick (peaks, operation and byte counts, statistics) and the
correctness check against the plain reference. Imports nothing of the
JAX package; the port (``repro_torch``) is imported only where a run
drives it."""
