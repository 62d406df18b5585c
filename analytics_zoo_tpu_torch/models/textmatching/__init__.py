"""Text matching (port of ``models/textmatching``)."""

from .knrm import KNRM
from .text_matcher import TextMatcher

__all__ = ["KNRM", "TextMatcher"]
