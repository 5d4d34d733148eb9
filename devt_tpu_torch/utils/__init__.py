"""Utilities (the JAX-variables ↔ state_dict weight bridge)."""
