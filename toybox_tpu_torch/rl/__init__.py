"""Policies, distributions and checkpoint loading for evaluation."""
