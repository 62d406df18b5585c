"""Ported layer substrate: precision policy, activations, layers."""
