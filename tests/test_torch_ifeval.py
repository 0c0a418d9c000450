"""The port's IFEval checker harness (``evals/ifeval.py``, a copy of the
JAX package's) against the JAX package's on the CPU.

For every official instruction id, every kwargs the JAX tests and the
proxy dataset give it, and a corpus of responses (every string of
``tests/test_ifeval.py``'s cases, read from its syntax tree, and
``detokenize`` of 300 seeded token-id streams), ``check_instruction``
gives the JAX package's verdict. ``evaluate`` gives equal results on the
same transcripts. The sentence splitters are pinned: nltk's punkt
algorithm where ``nltk`` is installed, the regex splitter without it, in
both packages alike.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

from quantizations_tpu.evals import ifeval as ji
from quantizations_tpu.evals.ifeval_proxy import PROXY_DATASET
from quantizations_tpu_torch.evals import ifeval as ti
from quantizations_tpu_torch.evals.ifeval_proxy import detokenize

JAX_TESTS = Path(__file__).resolve().parent / "test_ifeval.py"


def _literal_tuples():
    """Every tuple literal of ``tests/test_ifeval.py``."""
    out = []
    for node in ast.walk(ast.parse(JAX_TESTS.read_text())):
        if isinstance(node, ast.Tuple):
            try:
                out.append(ast.literal_eval(node))
            except ValueError:
                pass
    return out


TUPLES = _literal_tuples()
CASES = [t for t in TUPLES if len(t) == 4 and isinstance(t[0], str)
         and ":" in t[0] and isinstance(t[1], str)]


def _corpus():
    texts = {s for t in TUPLES for s in t if isinstance(s, str)}
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(0, 80))
        texts.add(detokenize(rng.integers(0, 1 << 17, n)))
    texts |= {"", " ", '"', "My answer is yes.", "{}", "[1, 2]",
              "```json\n{\"a\": 1}\n```", "<<Title>>\n\n* a\n* b\n\nP.S. x"}
    return sorted(texts)


CORPUS = _corpus()


def _kwargs_by_id():
    kw = {iid: [{}] for iid in ji.OFFICIAL_INSTRUCTION_IDS}
    for iid, _, k, _ in CASES:
        kw.setdefault(iid, []).append(k)
    for ex in PROXY_DATASET:
        for iid, k in zip(ex["instruction_id_list"], ex["kwargs"]):
            kw[iid].append(k)
    return kw


KWARGS = _kwargs_by_id()


def test_cases_were_read():
    assert len(CASES) >= 40
    assert len(CORPUS) > 300
    assert set(ti.OFFICIAL_INSTRUCTION_IDS) == set(ji.OFFICIAL_INSTRUCTION_IDS)
    assert len(ti.OFFICIAL_INSTRUCTION_IDS) == 25


@pytest.mark.parametrize("iid", ji.OFFICIAL_INSTRUCTION_IDS)
def test_check_instruction_matches_jax(iid):
    n = 0
    for kw in KWARGS[iid]:
        for text in CORPUS:
            want = ji.check_instruction(iid, text, kw)
            got = ti.check_instruction(iid, text, kw)
            assert got == want, (iid, text, kw)
            n += 1
    assert n >= len(CORPUS)


def test_jax_cases_hold_in_the_port():
    for iid, text, kw, want in CASES:
        assert ti.check_instruction(iid, text, kw) == want, (iid, text)


def test_unknown_id_is_skipped():
    assert ti.check_instruction("nonexistent:checker", "text", {}) is None


def test_detect_language_matches_jax():
    texts = [s for t in TUPLES if len(t) == 2 and isinstance(t[0], str)
             for s in t[:1]] + CORPUS
    for text in texts:
        assert ti.detect_language(text) == ji.detect_language(text), text


def test_evaluate_matches_jax():
    rng = np.random.default_rng(1)
    texts = {ex["prompt"]: detokenize(rng.integers(0, 1 << 17, 40))
             for ex in PROXY_DATASET}
    dataset = PROXY_DATASET + [{"key": 0, "prompt": "p",
                                "instruction_id_list": ["nonexistent:x",
                                                        "punctuation:no_comma"],
                                "kwargs": [{}, {}]}]
    texts["p"] = "no commas"
    got = ti.evaluate(texts.__getitem__, dataset).to_dict()
    want = ji.evaluate(texts.__getitem__, dataset).to_dict()
    assert got == want
    assert got["skipped_instructions"] == 1
    assert 0.0 < got["instruction_accuracy"] < 1.0


SENTENCES = [("Dr. Smith went home. He slept.", 2, 3),
             ("The value is 3.5 meters. Next one.", 2, 3),
             ("Wait... what? Yes!", 2, 3),
             ("One. Two. Three.", 3, 3),
             ("Hello world", 1, 1)]


def test_nltk_splitter_pinned():
    """With ``nltk`` installed both packages count with punkt."""
    pytest.importorskip("nltk")
    assert ti.sentence_splitter() == "nltk_punkt"
    for text, punkt, _ in SENTENCES:
        assert ti._num_sentences(text) == punkt == ji._num_sentences(text)


def test_regex_splitter_pinned(monkeypatch):
    """Without ``nltk`` both packages count with the regex splitter (the
    card's machine may lack ``nltk``; both arms of a run then share it)."""
    monkeypatch.setattr(ti, "_sentence_tokenizer", lambda: None)
    monkeypatch.setattr(ji, "_sentence_tokenizer", lambda: None)
    assert ti.sentence_splitter() == "regex"
    for text, _, regex in SENTENCES:
        assert ti._num_sentences(text) == regex == ji._num_sentences(text)
