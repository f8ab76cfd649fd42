"""Core value types, RNG and action decoding."""
