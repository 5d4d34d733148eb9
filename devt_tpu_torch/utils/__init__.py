"""Utilities: the JAX-variables ↔ state_dict weight bridge, and the
import of reference (torchvision, Lightning) state_dicts."""
