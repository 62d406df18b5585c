"""Text classification (port of ``models/textclassification``)."""

from .text_classifier import TextClassifier

__all__ = ["TextClassifier"]
