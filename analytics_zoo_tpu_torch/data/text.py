"""Text pipeline (port of ``analytics_zoo_tpu/data/text.py``, which needs
no JAX): ``TextFeature``, ``TextSet`` and the transformer stages
(tokenizer, normalizer, word indexer, sequence shaper, ``Relation`` pairs),
the reference's ``feature/text`` package.

A TextSet is a host-side collection whose terminal ``to_arrays()`` emits
padded ``(N, L)`` int32 batches, the device-facing contract; the same
texts give the same indices and word index in both packages. pandas is
imported only by ``read_parquet``.
"""

from __future__ import annotations

import os
import string
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class TextFeature:
    """One text record: raw text, optional label/uri, accumulated transform
    outputs under ``keys()`` (text_feature.py:27-107 parity)."""

    def __init__(self, text: Optional[str] = None, label: Optional[int] = None,
                 uri: Optional[str] = None):
        self._d: Dict = {}
        if text is not None:
            self._d["text"] = text
        if label is not None:
            self._d["label"] = int(label)
        if uri is not None:
            self._d["uri"] = uri

    def get_text(self) -> Optional[str]:
        return self._d.get("text")

    def get_label(self) -> int:
        return self._d.get("label", -1)

    def get_uri(self) -> Optional[str]:
        return self._d.get("uri")

    def has_label(self) -> bool:
        return "label" in self._d

    def set_label(self, label: int) -> "TextFeature":
        self._d["label"] = int(label)
        return self

    def get_tokens(self) -> Optional[List[str]]:
        return self._d.get("tokens")

    def get_indices(self) -> Optional[List[int]]:
        return self._d.get("indexedTokens")

    def get_sample(self):
        return self._d.get("sample")

    def get_predict(self):
        return self._d.get("predict")

    def keys(self) -> List[str]:
        return list(self._d.keys())

    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        self._d[k] = v

    def __contains__(self, k):
        return k in self._d

    def copy(self) -> "TextFeature":
        out = TextFeature()
        out._d = dict(self._d)
        return out

    def __repr__(self):
        return f"TextFeature(keys={self.keys()})"


# ------------------------------------------------------------------ transformers


class TextTransformer:
    """Base transform stage (transformer.py:28-41 parity); stages chain with
    ``>>`` like the reference's ``Preprocessing`` chaining."""

    def transform(self, feature: TextFeature) -> TextFeature:
        raise NotImplementedError

    def __call__(self, feature: TextFeature) -> TextFeature:
        return self.transform(feature)

    def __rshift__(self, other: "TextTransformer") -> "ChainedTextTransformer":
        return ChainedTextTransformer([self, other])


class ChainedTextTransformer(TextTransformer):
    def __init__(self, stages: Sequence[TextTransformer]):
        self.stages = list(stages)

    def transform(self, feature: TextFeature) -> TextFeature:
        for s in self.stages:
            feature = s.transform(feature)
        return feature

    def __rshift__(self, other: TextTransformer) -> "ChainedTextTransformer":
        return ChainedTextTransformer(self.stages + [other])


class Tokenizer(TextTransformer):
    """Whitespace tokenizer (Tokenizer.scala parity)."""

    def transform(self, feature: TextFeature) -> TextFeature:
        feature["tokens"] = feature.get_text().split()
        return feature


class Normalizer(TextTransformer):
    """Lower-case + strip punctuation/digits from tokens (Normalizer.scala:
    removes dirty characters and converts to lower case)."""

    _strip = str.maketrans("", "", string.punctuation + string.digits)

    def transform(self, feature: TextFeature) -> TextFeature:
        toks = [t.lower().translate(self._strip) for t in feature.get_tokens()]
        feature["tokens"] = [t for t in toks if t]
        return feature


class WordIndexer(TextTransformer):
    """Map tokens → 1-based indices via ``word_index``; unknown words drop out
    (WordIndexer.scala parity — unknown tokens are removed, not mapped to 0)."""

    def __init__(self, word_index: Dict[str, int]):
        self.word_index = dict(word_index)

    def transform(self, feature: TextFeature) -> TextFeature:
        feature["indexedTokens"] = [self.word_index[t] for t in feature.get_tokens()
                                    if t in self.word_index]
        return feature


class SequenceShaper(TextTransformer):
    """Pad/truncate ``indexedTokens`` to ``len`` (SequenceShaper.scala parity:
    trunc_mode pre|post, pad with ``pad_element`` at the END)."""

    def __init__(self, len: int, trunc_mode: str = "pre", pad_element: int = 0):
        assert trunc_mode in ("pre", "post"), "trunc_mode should be pre or post"
        self.len = int(len)
        self.trunc_mode = trunc_mode
        self.pad_element = int(pad_element)

    def transform(self, feature: TextFeature) -> TextFeature:
        idx = list(feature.get_indices())
        if len(idx) > self.len:
            idx = idx[-self.len:] if self.trunc_mode == "pre" else idx[:self.len]
        else:
            idx = idx + [self.pad_element] * (self.len - len(idx))
        feature["indexedTokens"] = idx
        return feature


class TextFeatureToSample(TextTransformer):
    """Materialize (feature, label) arrays (TextFeatureToSample.scala parity)."""

    def transform(self, feature: TextFeature) -> TextFeature:
        x = np.asarray(feature.get_indices(), dtype="int32")
        y = np.asarray(feature.get_label(), dtype="int32")
        feature["sample"] = (x, y)
        return feature


# ------------------------------------------------------------------------ TextSet


@dataclass
class Relation:
    """(id1, id2, label) relation for text matching (common/relation.py parity)."""

    id1: str
    id2: str
    label: int

    def to_tuple(self):
        return (self.id1, self.id2, self.label)


class TextSet:
    """Collection of TextFeatures with chained transforms (text_set.py:23 parity).

    The reference's Local/Distributed split collapses: transforms always run
    host-side; ``to_arrays``/``generate_sample`` produce the device-ready batch.
    """

    def __init__(self, features: Sequence[TextFeature]):
        self.features: List[TextFeature] = list(features)
        self.word_index: Optional[Dict[str, int]] = None

    # -- constructors ----------------------------------------------------------
    @classmethod
    def from_texts(cls, texts: Sequence[str],
                   labels: Optional[Sequence[int]] = None) -> "TextSet":
        labels = labels if labels is not None else [None] * len(texts)
        return cls([TextFeature(t, l) for t, l in zip(texts, labels)])

    @classmethod
    def read(cls, path: str) -> "TextSet":
        """Read a directory of ``<category>/<file>.txt`` (text_set.py:302 parity:
        category dir name index becomes the label)."""
        feats = []
        cats = [c for c in sorted(os.listdir(path))
                if os.path.isdir(os.path.join(path, c))]
        for label, cat in enumerate(cats):
            cat_dir = os.path.join(path, cat)
            for fn in sorted(os.listdir(cat_dir)):
                with open(os.path.join(cat_dir, fn), encoding="utf-8",
                          errors="ignore") as f:
                    feats.append(TextFeature(f.read(), label,
                                             uri=os.path.join(cat, fn)))
        return cls(feats)

    @classmethod
    def read_csv(cls, path: str) -> "TextSet":
        """CSV of ``uri,text`` rows, no header (text_set.py:332 parity)."""
        import csv

        feats = []
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    # text may itself contain commas: keep everything after uri
                    feats.append(TextFeature(",".join(row[1:]), uri=row[0]))
        return cls(feats)

    @classmethod
    def read_parquet(cls, path: str) -> "TextSet":
        import pandas as pd

        df = pd.read_parquet(path)
        return cls([TextFeature(r["text"], uri=r.get("uri"))
                    for _, r in df.iterrows()])

    # -- accessors -------------------------------------------------------------
    def get_texts(self) -> List[str]:
        return [f.get_text() for f in self.features]

    def get_labels(self) -> List[int]:
        return [f.get_label() for f in self.features]

    def get_uris(self) -> List[Optional[str]]:
        return [f.get_uri() for f in self.features]

    def get_samples(self):
        return [f.get_sample() for f in self.features]

    def get_predicts(self):
        return [f.get_predict() for f in self.features]

    def get_word_index(self) -> Optional[Dict[str, int]]:
        return self.word_index

    def set_word_index(self, vocab: Dict[str, int]) -> "TextSet":
        self.word_index = dict(vocab)
        return self

    def save_word_index(self, path: str) -> None:
        """One ``word index`` pair per line (text_set.py:85 format parity)."""
        with open(path, "w", encoding="utf-8") as f:
            for w, i in sorted(self.word_index.items(), key=lambda kv: kv[1]):
                f.write(f"{w} {i}\n")

    def load_word_index(self, path: str) -> "TextSet":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                w, i = line.rsplit(" ", 1)
                vocab[w] = int(i)
        return self.set_word_index(vocab)

    def __len__(self):
        return len(self.features)

    # -- transforms ------------------------------------------------------------
    def transform(self, transformer: TextTransformer) -> "TextSet":
        """Returns a NEW TextSet; source features are never mutated (matching
        the reference's immutable RDD-map semantics)."""
        out = TextSet([transformer.transform(f.copy()) for f in self.features])
        out.word_index = self.word_index
        return out

    def tokenize(self) -> "TextSet":
        return self.transform(Tokenizer())

    def normalize(self) -> "TextSet":
        return self.transform(Normalizer())

    def word2idx(self, remove_topN: int = 0, max_words_num: int = -1,
                 min_freq: int = 1,
                 existing_map: Optional[Dict[str, int]] = None) -> "TextSet":
        """Build the word index from token frequencies then map tokens
        (text_set.py:224-272 parity): drop the ``remove_topN`` most frequent,
        keep at most ``max_words_num`` with frequency ≥ ``min_freq``; indices
        start from 1 (or extend ``existing_map``)."""
        counts = Counter(t for f in self.features for t in (f.get_tokens() or ()))
        ranked = [w for w, c in counts.most_common() if c >= min_freq]
        ranked = ranked[remove_topN:]
        if max_words_num > 0:
            ranked = ranked[:max_words_num]
        vocab = dict(existing_map or {})
        nxt = max(vocab.values()) + 1 if vocab else 1
        for w in ranked:
            if w not in vocab:
                vocab[w] = nxt
                nxt += 1
        return self.transform(WordIndexer(vocab)).set_word_index(vocab)

    def shape_sequence(self, len: int, trunc_mode: str = "pre",
                       pad_element: int = 0) -> "TextSet":
        return self.transform(SequenceShaper(len, trunc_mode, pad_element))

    def generate_sample(self) -> "TextSet":
        return self.transform(TextFeatureToSample())

    # -- terminal / utilities --------------------------------------------------
    def to_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Stack indexed tokens + labels into device-ready ``(N, L)`` / ``(N,)``
        batches — the device-facing contract of this pipeline."""
        xs = np.stack([np.asarray(f.get_indices(), dtype="int32")
                       for f in self.features])
        ys = np.asarray([f.get_label() for f in self.features], dtype="int32")
        return xs, ys

    def random_split(self, weights: Sequence[float],
                     seed: int = 0) -> List["TextSet"]:
        """Random split by weight fractions (text_set.py:193 parity)."""
        w = np.asarray(weights, dtype="float64")
        w = w / w.sum()
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self.features))
        cuts = np.floor(np.cumsum(w) * len(perm)).astype(int)[:-1]
        out = []
        for chunk in np.split(perm, cuts):
            ts = TextSet([self.features[i] for i in chunk])
            ts.word_index = self.word_index
            out.append(ts)
        return out

    # -- relation constructors (text matching) ---------------------------------
    @classmethod
    def from_relation_pairs(cls, relations: Sequence[Relation], corpus1: "TextSet",
                            corpus2: "TextSet", seed: int = 0) -> "TextSet":
        """Pairwise-training set (text_set.py:369 parity): for each positive
        relation pick a negative with the same id1; sample feature is
        ``(2, L1+L2)`` [positive; negative] with label [1, 0]."""
        c1 = {f.get_uri(): f.get_indices() for f in corpus1.features}
        c2 = {f.get_uri(): f.get_indices() for f in corpus2.features}
        pos: Dict[str, List[str]] = {}
        neg: Dict[str, List[str]] = {}
        for r in relations:
            (pos if r.label > 0 else neg).setdefault(r.id1, []).append(r.id2)
        rng = np.random.default_rng(seed)
        feats = []
        for id1, pos_ids in pos.items():
            negs = neg.get(id1, [])
            if not negs:
                continue
            for pid in pos_ids:
                nid = negs[int(rng.integers(len(negs)))]
                x = np.stack([
                    np.concatenate([c1[id1], c2[pid]]),
                    np.concatenate([c1[id1], c2[nid]]),
                ]).astype("int32")
                tf = TextFeature(uri=id1)
                tf["indexedTokens"] = x
                tf["sample"] = (x, np.asarray([1, 0], dtype="int32"))
                feats.append(tf)
        return cls(feats)

    @classmethod
    def from_relation_lists(cls, relations: Sequence[Relation], corpus1: "TextSet",
                            corpus2: "TextSet") -> "TextSet":
        """Listwise-ranking set (text_set.py:401 parity): group by id1; sample
        feature ``(list_len, L1+L2)``, label ``(list_len, 1)``."""
        c1 = {f.get_uri(): f.get_indices() for f in corpus1.features}
        c2 = {f.get_uri(): f.get_indices() for f in corpus2.features}
        groups: Dict[str, List[Relation]] = {}
        for r in relations:
            groups.setdefault(r.id1, []).append(r)
        feats = []
        for id1, rels in groups.items():
            x = np.stack([np.concatenate([c1[id1], c2[r.id2]])
                          for r in rels]).astype("int32")
            y = np.asarray([[r.label] for r in rels], dtype="int32")
            tf = TextFeature(uri=id1)
            tf["indexedTokens"] = x
            tf["sample"] = (x, y)
            feats.append(tf)
        return cls(feats)
