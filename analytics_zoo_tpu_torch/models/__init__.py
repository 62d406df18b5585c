"""Ported models."""
