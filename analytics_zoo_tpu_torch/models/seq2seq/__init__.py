"""Seq2seq (port of ``analytics_zoo_tpu/models/seq2seq``)."""

from .seq2seq import Bridge, RNNDecoder, RNNEncoder, Seq2seq

__all__ = ["Bridge", "RNNDecoder", "RNNEncoder", "Seq2seq"]
