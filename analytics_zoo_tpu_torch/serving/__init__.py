"""Ported serving: the continuous-batching generation loop."""
