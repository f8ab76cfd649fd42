"""Policies, distributions, checkpoints, PPO and its test envs."""
