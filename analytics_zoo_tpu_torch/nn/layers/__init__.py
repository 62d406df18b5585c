"""Ported layers."""
