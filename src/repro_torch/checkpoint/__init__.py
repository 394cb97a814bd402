"""Checkpoints in the reference's ``arrays.npz`` + ``manifest.json`` format."""
