"""Batched environments and the DeepMind observation pipeline."""
