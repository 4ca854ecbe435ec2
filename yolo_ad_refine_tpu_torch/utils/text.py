"""Offline text embeddings for YOLO-World's open vocabulary.

The port's own copy of ``yolo_ad_refine_tpu/utils/text.py`` (the port
imports nothing of the JAX package), bit-equal to it: the reference encodes
class names with CLIP's text tower, whose weights are not shipped, so
``YOLO.set_classes`` falls back to this deterministic hashed character
n-gram encoder. A name maps to a bag of 2-4-gram hash buckets (blake2b)
which a fixed seeded Gaussian projection lifts into the head's embedding
space, L2-normalised. It keeps what the head relies on (deterministic,
normalised, distinct names near-orthogonal, close surface forms close) and
lacks CLIP's semantics. Callers with a real encoder pass ``text_embeddings``
to ``set_classes`` instead.
"""

from __future__ import annotations

import hashlib

import numpy as np

N_BUCKETS = 4096
_NGRAMS = (2, 3, 4)


def _ngram_buckets(name: str) -> np.ndarray:
    """Hashed character-n-gram counts, (N_BUCKETS,) float32."""
    s = f" {name.strip().lower()} "
    counts = np.zeros(N_BUCKETS, np.float32)
    for n in _NGRAMS:
        for i in range(max(0, len(s) - n + 1)):
            g = s[i : i + n]
            h = int.from_bytes(hashlib.blake2b(g.encode(), digest_size=8).digest(), "little")
            counts[h % N_BUCKETS] += 1.0
    return counts


def _projection(embed_dim: int) -> np.ndarray:
    """Fixed (N_BUCKETS, embed_dim) Gaussian projection — seeded so every
    process (train, val, a later deploy) maps a name to the same vector."""
    rng = np.random.default_rng(0x59415431)  # 'YAT1'
    return rng.standard_normal((N_BUCKETS, embed_dim), dtype=np.float32) / np.sqrt(embed_dim)


_PROJ_CACHE: dict[int, np.ndarray] = {}


def encode_class_names(names: list[str], embed_dim: int = 512) -> np.ndarray:
    """(len(names), embed_dim) L2-normalized offline text embeddings."""
    proj = _PROJ_CACHE.setdefault(embed_dim, _projection(embed_dim))
    feats = np.stack([_ngram_buckets(n) for n in names]) @ proj
    norms = np.linalg.norm(feats, axis=-1, keepdims=True)
    return (feats / np.maximum(norms, 1e-9)).astype(np.float32)
