"""Text models (port of ``models/text``): the BERT heads and the
sequence-labelling models."""

from .bert_classifier import BERTClassifier
from .bert_estimators import BERTNER, BERTSQuAD, ner_token_loss, squad_span_loss
from .sequence_models import (NER, IntentEntity, POSTagger, SequenceTagger,
                              crf_tag_loss, crf_tag_loss_reg, masked_tag_loss)

__all__ = ["BERTClassifier", "BERTNER", "BERTSQuAD", "NER", "SequenceTagger",
           "POSTagger", "IntentEntity", "ner_token_loss", "squad_span_loss",
           "crf_tag_loss", "crf_tag_loss_reg", "masked_tag_loss"]
