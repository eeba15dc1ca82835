"""Helpers shared by the physics modules."""
