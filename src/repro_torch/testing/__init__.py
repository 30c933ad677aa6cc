"""Tools for holding the port against its references and for fault
injection: the numpy models and inputs the on-card smoke script uses
without the JAX package, and the seeded chaos harness
(:mod:`repro_torch.testing.chaos`) that the serving engine consults."""
