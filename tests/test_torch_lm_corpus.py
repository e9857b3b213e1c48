"""The port's copy of the LM corpus pipeline (``data/lm_corpus.py``):
the build-corpus cases of the JAX package's ``tests/test_lm_corpus.py``,
run on the port's module over documents the test writes, and the two
copies' outputs compared byte for byte."""

import json
import os

import numpy as np
import pytest

from pytorch_distributed_training_tpu.data import lm_corpus as jlc
from pytorch_distributed_training_tpu_torch.data import lm_corpus as lc

WORDS = ("alpha", "beta", "gamma", "delta", "sigma", "theta", "kappa",
         "omega", "tensor", "shard", "batch", "token", "layer", "step")


def _write_docs(root) -> str:
    """Forty small Python sources with distinct bodies, a duplicate (the
    content dedupe drops it) and a file too small to count."""
    rng = np.random.default_rng(0)
    docs = root / "docs"
    docs.mkdir()
    for i in range(40):
        names = rng.choice(WORDS, 6)
        body = "\n".join(
            f"def {a}_{i}_{j}({b}, {c}):\n    return {b} * {j} + {c}\n"
            for j, (a, b, c) in enumerate(zip(names, names[1:], names[2:])))
        (docs / f"mod_{i:02d}.py").write_text(f"import os\n\n{body}")
    (docs / "copy.py").write_text((docs / "mod_00.py").read_text())
    (docs / "tiny.py").write_text("x = 1\n")
    return str(docs)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    docs = _write_docs(root)
    out = root / "out"
    meta = lc.build_corpus(str(out), [docs], vocab_size=400, val_frac=0.1)
    return docs, str(out), meta


def test_build_corpus_roundtrip(corpus):
    _, out, meta = corpus
    assert meta["train_docs"] + meta["val_docs"] == 40    # dedupe, size
    assert meta["train_tokens"] > 1000
    assert meta["val_tokens"] > 0
    toks = lc.load_token_bin(os.path.join(out, "train.bin"))
    assert toks.dtype == np.uint16
    assert toks.size == meta["train_tokens"]
    assert int(toks.max()) < meta["vocab_size"]
    tok = lc.load_tokenizer(os.path.join(out, "tokenizer.json"))
    eot = tok.token_to_id(lc.EOT_TOKEN)
    assert int((toks == eot).sum()) == meta["train_docs"]
    first_doc = toks[: int(np.argmax(toks == eot))]
    text = tok.decode(list(first_doc.astype(int)))
    assert text.startswith("import os") and "def " in text


def test_split_is_content_stable(corpus):
    docs, _, _ = corpus
    t1, v1 = lc.collect_documents([docs], val_frac=0.1)
    t2, v2 = lc.collect_documents([docs], val_frac=0.1)
    assert [d.path for d in t1] == [d.path for d in t2]
    assert [d.path for d in v1] == [d.path for d in v2]
    assert not ({d.path for d in t1} & {d.path for d in v1})
    jt, jv = jlc.collect_documents([docs], val_frac=0.1)
    assert [d.path for d in t1] == [d.path for d in jt]
    assert [d.path for d in v1] == [d.path for d in jv]


def test_meta_matches_bins(corpus):
    _, out, meta = corpus
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f) == meta
    for split in ("train", "val"):
        n = lc.load_token_bin(os.path.join(out, f"{split}.bin")).size
        assert n == meta[f"{split}_tokens"]


def test_bins_equal_the_jax_copy(corpus, tmp_path):
    docs, out, meta = corpus
    jmeta = jlc.build_corpus(str(tmp_path), [docs], vocab_size=400,
                             val_frac=0.1)
    assert jmeta == meta
    for name in ("train.bin", "val.bin", "tokenizer.json"):
        with open(os.path.join(out, name), "rb") as a, \
                open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name
