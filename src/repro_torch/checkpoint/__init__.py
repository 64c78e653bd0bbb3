"""Checkpoint bridge from the reference's ``.npz`` format."""
