"""Test helpers that need no JAX."""
