"""LM corpus pipeline: raw text -> trained BPE -> packed token bins.  A
copy of the JAX package's ``data/lm_corpus.py`` (numpy only, ``tokenizers``
imported inside the functions that train or load a tokenizer), so the
port builds configs[3]'s ``token-file:`` bins without the JAX package.

The reference trains image classifiers only (its ``src/main.py:47-49``);
the GPT-2 BASELINE config (BASELINE.json configs[3], "GPT-2 124M /
OpenWebText") needs a token pipeline: a tokenizer, a document-packed token
stream, and train/val splits.  This module provides the OpenWebText-shaped
preprocessing as a library:

  1. ``collect_documents`` — walk source roots for UTF-8 text documents,
     content-dedupe (vendored copies are rampant in real corpora), and split
     train/val *by document* with a stable hash so the split survives
     re-runs.
  2. ``train_tokenizer`` — byte-level BPE trained on the corpus itself
     (``tokenizers``' Rust trainer), GPT-2-shaped: ``vocab_size`` 50257 with
     ``<|endoftext|>`` as the document separator.  Training locally instead
     of shipping OpenAI's merges keeps the pipeline self-contained: it
     needs no network (tiktoken's merges are a lazy download).
  3. ``tokenize_to_bin`` — encode each document, append the EOT id, and pack
     everything into one flat uint16 memmap — the nanoGPT bin layout: random
     (or sequential) windows of ``seq+1`` tokens are training samples, and
     document boundaries are learned via EOT rather than padded away.

No torch dependency: the output is a plain ``np.memmap`` any consumer
maps read-only (``load_token_bin``).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import numpy as np

EOT_TOKEN = "<|endoftext|>"


@dataclass(frozen=True)
class CorpusDoc:
    path: str
    size: int


def iter_text_files(
    roots: Sequence[str],
    *,
    suffixes: tuple[str, ...] = (".py",),
    max_file_bytes: int = 1_000_000,
    min_file_bytes: int = 64,
) -> Iterator[str]:
    """Yield paths of candidate documents under ``roots`` (sorted walk —
    deterministic corpus across runs)."""
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for name in sorted(filenames):
                if not name.endswith(suffixes):
                    continue
                p = os.path.join(dirpath, name)
                try:
                    sz = os.path.getsize(p)
                except OSError:
                    continue
                if min_file_bytes <= sz <= max_file_bytes:
                    yield p


def read_document(path: str) -> str | None:
    """Read a document as UTF-8; None for undecodable/unreadable files."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
        return raw.decode("utf-8")
    except (OSError, UnicodeDecodeError):
        return None


def collect_documents(
    roots: Sequence[str],
    *,
    val_frac: float = 0.01,
    max_total_bytes: int | None = None,
    suffixes: tuple[str, ...] = (".py",),
    max_file_bytes: int = 1_000_000,
) -> tuple[list[CorpusDoc], list[CorpusDoc]]:
    """Scan ``roots`` into deduped (train_docs, val_docs).

    Dedupe is by content hash (identical vendored files collapse to one
    copy).  The split is by a stable content-hash bucket, not RNG, so
    train/val membership is a property of the document — re-scans, added
    roots, or a different machine cannot leak val docs into train.
    """
    seen: set[bytes] = set()
    train: list[CorpusDoc] = []
    val: list[CorpusDoc] = []
    total = 0
    # val_frac=0 means NO val split; any positive fraction gets >=1 bucket.
    val_buckets = max(1, round(val_frac * 1000)) if val_frac > 0 else 0
    for path in iter_text_files(
        roots, suffixes=suffixes, max_file_bytes=max_file_bytes
    ):
        text = read_document(path)
        if text is None:
            continue
        digest = hashlib.sha1(text.encode("utf-8")).digest()
        if digest in seen:
            continue
        seen.add(digest)
        doc = CorpusDoc(path=path, size=len(text))
        # Low bits of the content hash pick the split: ~val_frac of docs.
        if int.from_bytes(digest[:4], "big") % 1000 < val_buckets:
            val.append(doc)
        else:
            train.append(doc)
        total += doc.size
        if max_total_bytes is not None and total >= max_total_bytes:
            break
    return train, val


def _doc_texts(docs: Iterable[CorpusDoc]) -> Iterator[str]:
    for d in docs:
        text = read_document(d.path)
        if text is not None:
            yield text


def train_tokenizer(
    docs: Sequence[CorpusDoc],
    *,
    vocab_size: int = 50257,
    out_path: str,
):
    """Train a byte-level BPE on ``docs`` and save tokenizer JSON.

    GPT-2-shaped on purpose: byte-level alphabet (no UNK possible),
    ``vocab_size`` including ``<|endoftext|>``, so the trained LM keeps the
    exact published 124M parameter count.
    """
    from tokenizers import ByteLevelBPETokenizer

    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(
        _doc_texts(docs),
        vocab_size=vocab_size,
        min_frequency=2,
        special_tokens=[EOT_TOKEN],
    )
    tok.save(out_path)
    return tok


def load_tokenizer(path: str):
    from tokenizers import Tokenizer

    return Tokenizer.from_file(path)


def tokenize_to_bin(
    tokenizer,
    docs: Sequence[CorpusDoc],
    bin_path: str,
    *,
    batch_docs: int = 512,
) -> int:
    """Encode ``docs`` -> flat uint16 token stream with EOT separators.

    Returns the token count.  Encoding runs through ``encode_batch`` (Rust
    thread pool) in document batches; the bin is streamed to disk, never
    resident.
    """
    eot = tokenizer.token_to_id(EOT_TOKEN)
    if eot is None:
        raise ValueError(f"tokenizer has no {EOT_TOKEN!r} token")
    if tokenizer.get_vocab_size() > 2**16:
        # The bin is uint16 — fail before the (expensive) encode, not
        # mid-write on the first id >= 65536.
        raise ValueError(
            f"vocab {tokenizer.get_vocab_size()} exceeds the uint16 bin "
            "format (max 65536)"
        )
    n_tokens = 0
    with open(bin_path, "wb") as f:
        batch: list[str] = []

        def flush():
            nonlocal n_tokens
            if not batch:
                return
            for enc in tokenizer.encode_batch(batch):
                ids = np.asarray(enc.ids + [eot], dtype=np.uint16)
                f.write(ids.tobytes())
                n_tokens += ids.size
            batch.clear()

        for text in _doc_texts(docs):
            batch.append(text)
            if len(batch) >= batch_docs:
                flush()
        flush()
    return n_tokens


def load_token_bin(path: str) -> np.ndarray:
    """Read-only uint16 memmap over a packed token bin."""
    return np.memmap(path, dtype=np.uint16, mode="r")


def build_corpus(
    out_dir: str,
    roots: Sequence[str],
    *,
    vocab_size: int = 50257,
    val_frac: float = 0.01,
    max_total_bytes: int | None = None,
    suffixes: tuple[str, ...] = (".py",),
) -> dict:
    """End-to-end: scan -> BPE -> train.bin/val.bin/tokenizer.json/meta.json."""
    os.makedirs(out_dir, exist_ok=True)
    train_docs, val_docs = collect_documents(
        roots, val_frac=val_frac, max_total_bytes=max_total_bytes,
        suffixes=suffixes,
    )
    tok_path = os.path.join(out_dir, "tokenizer.json")
    train_tokenizer(train_docs, vocab_size=vocab_size, out_path=tok_path)
    tokenizer = load_tokenizer(tok_path)
    n_train = tokenize_to_bin(
        tokenizer, train_docs, os.path.join(out_dir, "train.bin")
    )
    n_val = tokenize_to_bin(
        tokenizer, val_docs, os.path.join(out_dir, "val.bin")
    )
    meta = {
        "roots": list(roots),
        "suffixes": list(suffixes),
        "vocab_size": vocab_size,
        "train_docs": len(train_docs),
        "val_docs": len(val_docs),
        "train_bytes": sum(d.size for d in train_docs),
        "val_bytes": sum(d.size for d in val_docs),
        "train_tokens": n_train,
        "val_tokens": n_val,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def _main() -> None:  # pragma: no cover - thin CLI over build_corpus
    import argparse

    ap = argparse.ArgumentParser(
        description="Build a BPE-tokenized LM corpus from source-text roots"
    )
    ap.add_argument("--out", required=True)
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--vocab-size", type=int, default=50257)
    ap.add_argument("--val-frac", type=float, default=0.01)
    ap.add_argument("--max-total-bytes", type=int, default=None)
    args = ap.parse_args()
    meta = build_corpus(
        args.out, args.roots, vocab_size=args.vocab_size,
        val_frac=args.val_frac, max_total_bytes=args.max_total_bytes,
    )
    print(json.dumps(meta))


if __name__ == "__main__":  # pragma: no cover
    _main()
