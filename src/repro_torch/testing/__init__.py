"""Inputs for holding the port against its references (numpy only, so the
on-card smoke script can use them without the JAX package)."""
