"""Checkpoints and per-phase timing of the prover."""
