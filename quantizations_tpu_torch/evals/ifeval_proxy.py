"""IFEval score parity on the trained-distribution proxy model
(counterpart of ``quantizations_tpu/evals/ifeval_proxy.py``).

The accuracy claim of a 4-bit scheme is that the 4-bit model scores the
same on IFEval as the bf16 model. Without a trained checkpoint this
module closes the claim's shape end to end: a synthesized IFEval dataset
covering all 25 official instruction ids is served by the slot
:class:`~quantizations_tpu_torch.serve.engine.Engine` twice over the same
quantized parameters,

- once through the 4-bit kernels (the quantized model), and
- once with ``QuantConfig(dense_twin=True)``: every projection
  dequantizes its layer to dense bf16 (K10, or K7 for planar words) and
  runs a bf16 product with fp32 sums, so that the model computes with
  the dequantized twin's weights without holding a 16 GB twin,

and both transcripts are scored by the checker harness (:mod:`.ifeval`).
The claim under test: the score delta is ~0 and the per-(example,
instruction) verdict agreement ~1.

Both sides share one deterministic word-level detokenizer (below), so
the comparison is about the token streams the two compute paths emit.
Its vocabulary makes a random-ish token stream engage a useful subset of
checkers with pass rates away from 0 and 1 (commas, paragraph breaks,
ALL-CAPS words, ``[placeholders]``, ``*highlights*``, bullet lines).
The tokenizer and the dataset are copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Dict, List, Union

import torch

__all__ = ["PROXY_DATASET", "detokenize", "encode_prompt",
           "run_ifeval_proxy"]


# ---------------------------------------------------------------------------
# Deterministic proxy tokenizer
# ---------------------------------------------------------------------------

_WORDS = (
    "the of and to in is that it for on with as at by this from or an be "
    "are was were has have had not but all can will would there their one "
    "two three new time way day man world life hand part child eye woman "
    "place work week case point company number group problem fact market "
    "team night area money story result change light water food side "
    "house service friend power hour game line end member law car city "
    "community name president team minute idea kid body back parent face "
    "others level office door health person art war history party result "
    "morning reason research girl guy moment air teacher force education "
    "data model value system state question business issue kind head far "
    "black long little own other old right big high small large next "
    "early young important few public bad same able good great national "
    "different following".split())

_CAPITALS = ("The North Market Section However Therefore Monday Spring "
             "River Atlas Summary Report Council Harbor Meadow".split())

_ALLCAPS = "WARNING NOTE IMPORTANT TODO".split()

_SPECIALS = [
    ".", ".", ".", ",", ",", "!", "?", ";", ":",
    "\n\n", "\n\n",           # paragraph breaks
    "\n* ",                    # markdown bullet
    " [name]", " [address]", " [date]",   # IFEval placeholders
    " *highlighted*", " *key point*",     # highlighted sections
    " P.S.", " ******", " <<Atlas Report>>",
]


def _token_pieces() -> List[str]:
    """512 text pieces; piece i is what token id ``i % 512`` renders as.
    Words carry their own leading space, punctuation binds tight."""
    pieces: List[str] = []
    for w in _WORDS:
        pieces.append(" " + w)
    for w in _CAPITALS:
        pieces.append(" " + w)
    for w in _ALLCAPS:
        pieces.append(" " + w)
    pieces.extend(_SPECIALS)
    # pad to 512 with the common-word cycle so the id->piece map covers
    # the whole modulus evenly
    i = 0
    while len(pieces) < 512:
        pieces.append(" " + _WORDS[i % len(_WORDS)])
        i += 1
    return pieces[:512]


_PIECES = _token_pieces()


def detokenize(ids) -> str:
    """Deterministic token-id -> text (both model variants share it)."""
    return "".join(_PIECES[int(t) % len(_PIECES)] for t in ids).strip()


def encode_prompt(text: str, vocab_size: int) -> List[int]:
    """Deterministic text -> token ids (stable across runs/processes;
    the proxy model is untrained, so only determinism matters)."""
    return [zlib.crc32(w.encode()) % vocab_size for w in text.split()]


# ---------------------------------------------------------------------------
# Synthesized dataset — every official instruction id appears at least once
# (official input_data.jsonl schema: key/prompt/instruction_id_list/kwargs)
# ---------------------------------------------------------------------------

def _ex(key: int, prompt: str, ids: List[str],
        kwargs: List[dict]) -> dict:
    return {"key": key, "prompt": prompt, "instruction_id_list": ids,
            "kwargs": kwargs}


PROXY_DATASET: List[dict] = [
    _ex(1, "Describe the harbor market in the morning.",
        ["keywords:existence"], [{"keywords": ["the", "market"]}]),
    _ex(2, "Write a short note about the city council meeting.",
        ["keywords:forbidden_words"],
        [{"forbidden_words": ["zyzzyva", "quixotic"]}]),
    _ex(3, "Explain why the river floods in spring.",
        ["keywords:frequency"],
        [{"keyword": "and", "frequency": 2, "relation": "at least"}]),
    _ex(4, "Tell a story about two friends.",
        ["keywords:letter_frequency"],
        [{"letter": "e", "let_frequency": 15,
          "let_relation": "at least"}]),
    _ex(5, "Summarize the health report.",
        ["language:response_language"], [{"language": "en"}]),
    _ex(6, "Write about the national education system.",
        ["length_constraints:number_words"],
        [{"num_words": 40, "relation": "at least"}]),
    _ex(7, "Give a brief answer about the water supply.",
        ["length_constraints:number_words"],
        [{"num_words": 200, "relation": "less than"}]),
    _ex(8, "Describe a week at the office.",
        ["length_constraints:number_sentences"],
        [{"num_sentences": 3, "relation": "at least"}]),
    _ex(9, "Write two paragraphs about the game.",
        ["length_constraints:number_paragraphs"],
        [{"num_paragraphs": 2}]),
    _ex(10, "Write three paragraphs; start the second with 'However'.",
        ["length_constraints:nth_paragraph_first_word"],
        [{"num_paragraphs": 3, "nth_paragraph": 2,
          "first_word": "However"}]),
    _ex(11, "Draft a letter that includes a template placeholder.",
        ["detectable_content:number_placeholders"],
        [{"num_placeholders": 1}]),
    _ex(12, "Write a message and add a postscript.",
        ["detectable_content:postscript"],
        [{"postscript_marker": "P.S."}]),
    _ex(13, "Is the market open on Monday?",
        ["detectable_format:constrained_response"], [{}]),
    _ex(14, "Return the company data as JSON.",
        ["detectable_format:json_format"], [{}]),
    _ex(15, "Write a report with two sections.",
        ["detectable_format:multiple_sections"],
        [{"num_sections": 2, "section_spliter": "Section"}]),
    _ex(16, "List the team's three problems as bullets.",
        ["detectable_format:number_bullet_lists"], [{"num_bullets": 2}]),
    _ex(17, "Highlight at least one key point.",
        ["detectable_format:number_highlighted_sections"],
        [{"num_highlights": 1}]),
    _ex(18, "Give your answer a title.",
        ["detectable_format:title"], [{}]),
    _ex(19, "Answer in all lowercase.",
        ["change_case:english_lowercase"], [{}]),
    _ex(20, "ANSWER IN ALL CAPITAL LETTERS.",
        ["change_case:english_capital"], [{}]),
    _ex(21, "Use at least one fully-capitalized word.",
        ["change_case:capital_word_frequency"],
        [{"capital_frequency": 1, "capital_relation": "at least"}]),
    _ex(22, "First repeat the request, then answer it.",
        ["combination:repeat_prompt"],
        [{"prompt_to_repeat": "First repeat the request"}]),
    _ex(23, "Give two different responses.",
        ["combination:two_responses"], [{}]),
    _ex(24, "Describe the night sky without using any commas.",
        ["punctuation:no_comma"], [{}]),
    _ex(25, "End your answer with the exact phrase 'the end'.",
        ["startend:end_checker"], [{"end_phrase": "the end"}]),
    _ex(26, "Wrap your whole answer in double quotation marks.",
        ["startend:quotation"], [{}]),
    # multi-instruction examples (the official set mixes several per
    # prompt; prompt-level strict accuracy only differs from
    # instruction-level accuracy when these exist)
    _ex(27, "Write about the art community.",
        ["keywords:existence", "length_constraints:number_words",
         "language:response_language"],
        [{"keywords": ["the"]}, {"num_words": 30, "relation": "at least"},
         {"language": "en"}]),
    _ex(28, "Describe the power grid, avoiding commas, in English.",
        ["punctuation:no_comma", "language:response_language"],
        [{}, {"language": "en"}]),
]


# Variant expansion: with 31 instructions one flipped verdict moves the
# score 3.2 points. Three extra examples per instruction id with rotated
# topics and kwargs bring every id to >= 4 prompts (109 examples, 120
# scored instructions), so that +-1 verdict is under 1 point.

_TOPICS = ("the spring market", "the city harbor", "the research team",
           "the night train", "the teacher council", "the water system")

_VARIANT_SPECS: Dict[str, List[dict]] = {
    "keywords:existence": [
        {"keywords": ["water", "the"]}, {"keywords": ["night"]},
        {"keywords": ["zyzzyva"]}],                 # near-sure fail arm
    "keywords:forbidden_words": [
        {"forbidden_words": ["the"]},               # near-sure fail arm
        {"forbidden_words": ["xylotomy"]},
        {"forbidden_words": ["market", "harbor"]}],
    "keywords:frequency": [
        {"keyword": "the", "frequency": 3, "relation": "at least"},
        {"keyword": "of", "frequency": 2, "relation": "less than"},
        {"keyword": "water", "frequency": 1, "relation": "at least"}],
    "keywords:letter_frequency": [
        {"letter": "t", "let_frequency": 20, "let_relation": "at least"},
        {"letter": "z", "let_frequency": 3, "let_relation": "less than"},
        {"letter": "e", "let_frequency": 40, "let_relation": "at least"}],
    "language:response_language": [
        {"language": "en"}, {"language": "en"}, {"language": "en"}],
    "length_constraints:number_words": [
        {"num_words": 20, "relation": "at least"},
        {"num_words": 400, "relation": "less than"},
        {"num_words": 120, "relation": "at least"}],
    "length_constraints:number_sentences": [
        {"num_sentences": 2, "relation": "at least"},
        {"num_sentences": 12, "relation": "less than"},
        {"num_sentences": 6, "relation": "at least"}],
    "length_constraints:number_paragraphs": [
        {"num_paragraphs": 1}, {"num_paragraphs": 3},
        {"num_paragraphs": 2}],
    "length_constraints:nth_paragraph_first_word": [
        {"num_paragraphs": 2, "nth_paragraph": 1, "first_word": "The"},
        {"num_paragraphs": 2, "nth_paragraph": 2, "first_word": "However"},
        {"num_paragraphs": 3, "nth_paragraph": 3, "first_word": "Therefore"}],
    "detectable_content:number_placeholders": [
        {"num_placeholders": 2}, {"num_placeholders": 1},
        {"num_placeholders": 3}],
    "detectable_content:postscript": [
        {"postscript_marker": "P.S."}, {"postscript_marker": "P.P.S"},
        {"postscript_marker": "P.S."}],
    "detectable_format:constrained_response": [{}, {}, {}],
    "detectable_format:json_format": [{}, {}, {}],
    "detectable_format:multiple_sections": [
        {"num_sections": 3, "section_spliter": "Section"},
        {"num_sections": 2, "section_spliter": "SECTION"},
        {"num_sections": 2, "section_spliter": "Section"}],
    "detectable_format:number_bullet_lists": [
        {"num_bullets": 1}, {"num_bullets": 3}, {"num_bullets": 2}],
    "detectable_format:number_highlighted_sections": [
        {"num_highlights": 2}, {"num_highlights": 1},
        {"num_highlights": 3}],
    "detectable_format:title": [{}, {}, {}],
    "change_case:english_lowercase": [{}, {}, {}],
    "change_case:english_capital": [{}, {}, {}],
    "change_case:capital_word_frequency": [
        {"capital_frequency": 2, "capital_relation": "at least"},
        {"capital_frequency": 6, "capital_relation": "less than"},
        {"capital_frequency": 1, "capital_relation": "at least"}],
    "combination:repeat_prompt": [
        {"prompt_to_repeat": "Please describe"},
        {"prompt_to_repeat": "Now explain"},
        {"prompt_to_repeat": "Kindly summarize"}],
    "combination:two_responses": [{}, {}, {}],
    "punctuation:no_comma": [{}, {}, {}],
    "startend:end_checker": [
        {"end_phrase": "the end"},
        {"end_phrase": "any other questions?"},
        {"end_phrase": "that is all"}],
    "startend:quotation": [{}, {}, {}],
}

_PROMPT_VERBS = {          # ids whose prompt must echo the kwargs
    "combination:repeat_prompt": ("Please describe", "Now explain",
                                  "Kindly summarize"),
}


def _expand_variants() -> List[dict]:
    out: List[dict] = []
    key = 100
    for j, iid in enumerate(sorted(_VARIANT_SPECS)):
        for k, kw in enumerate(_VARIANT_SPECS[iid]):
            topic = _TOPICS[(j + k) % len(_TOPICS)]
            if iid in _PROMPT_VERBS:
                prompt = f"{_PROMPT_VERBS[iid][k]} {topic}."
            else:
                prompt = (f"Write about {topic}, variant {k + 1}, "
                          f"following the instruction.")
            out.append(_ex(key, prompt, [iid], [kw]))
            key += 1
    # extra multi-instruction mixes (prompt-level strict accuracy)
    out.extend([
        _ex(900, "Describe the night train schedule in detail.",
            ["punctuation:no_comma", "change_case:english_lowercase",
             "length_constraints:number_words"],
            [{}, {}, {"num_words": 25, "relation": "at least"}]),
        _ex(901, "Summarize the water system report with highlights.",
            ["detectable_format:number_highlighted_sections",
             "detectable_content:number_placeholders"],
            [{"num_highlights": 1}, {"num_placeholders": 1}]),
        _ex(902, "Write a titled note about the teacher council.",
            ["detectable_format:title", "startend:quotation"],
            [{}, {}]),
        _ex(903, "List the harbor problems, ending with 'the end'.",
            ["detectable_format:number_bullet_lists",
             "startend:end_checker"],
            [{"num_bullets": 2}, {"end_phrase": "the end"}]),
        _ex(904, "Explain the market data in two paragraphs.",
            ["length_constraints:number_paragraphs",
             "keywords:existence"],
            [{"num_paragraphs": 2}, {"keywords": ["data"]}]),
        _ex(905, "Report on the research team in English sentences.",
            ["language:response_language",
             "length_constraints:number_sentences",
             "keywords:frequency"],
            [{"language": "en"},
             {"num_sentences": 3, "relation": "at least"},
             {"keyword": "team", "frequency": 1, "relation": "at least"}]),
    ])
    return out


PROXY_DATASET.extend(_expand_variants())


def _covered() -> set:
    s = set()
    for ex in PROXY_DATASET:
        s.update(ex["instruction_id_list"])
    return s


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def run_ifeval_proxy(preset: str = "8b", quant_type: str = "fp4",
                     kv_dtype: str = "bf16", max_new_tokens: int = 96,
                     slots: int = 8, seed: int = 0, proxy: bool = True,
                     device: Union[str, torch.device] = "cuda") -> Dict:
    """Serve the synthesized IFEval set through the slot ``Engine`` twice
    (the 4-bit kernels, then the dense twin, over the same params built
    on ``device``) with greedy decoding, and score both.

    Returns ``{"quantized": .., "dense_twin": .., "deltas": ..,
    "verdict_agreement": .., "n_examples": .., "n_instructions": ..,
    "max_new_tokens": ..}``, the JAX package's keys.
    """
    from ..config import QuantConfig, ServeConfig
    from ..device import resolve_device
    from ..models.llama import LLAMA3_8B, TINY_LLAMA, init_llama_params
    from ..serve.engine import Engine
    from .ifeval import OFFICIAL_INSTRUCTION_IDS, check_instruction, evaluate

    missing = set(OFFICIAL_INSTRUCTION_IDS) - _covered()
    if missing:   # the dataset must stay exhaustive as ids evolve
        raise AssertionError(f"dataset misses instruction ids: {missing}")

    dev = resolve_device(device)
    base = LLAMA3_8B if preset == "8b" else TINY_LLAMA
    qcfg = QuantConfig(quant_type=quant_type)
    cfg = dataclasses.replace(base, kv_cache_dtype=kv_dtype, quant=qcfg)
    params = init_llama_params(
        cfg, seed=seed, dist="trained_proxy" if proxy else "normal",
        device=dev)

    prompts = [ex["prompt"] for ex in PROXY_DATASET]
    enc = {p: encode_prompt(p, cfg.vocab_size) for p in prompts}
    plen = max(len(v) for v in enc.values())
    max_seq = 64 * ((plen + max_new_tokens + 63) // 64 + 1)
    serve = ServeConfig(max_seq_len=max_seq, max_new_tokens=max_new_tokens)

    def side(side_cfg) -> Dict[str, str]:
        eng = Engine(params, side_cfg, serve, slots=slots,
                     temperature=0.0, seed=seed)
        uid_to_prompt = {}
        for p in prompts:
            uid = eng.submit(enc[p], max_new_tokens=max_new_tokens)
            uid_to_prompt[uid] = p
        finished = eng.run()
        return {uid_to_prompt[uid]: detokenize(req.output_ids)
                for uid, req in finished.items()}

    texts_q = side(cfg)
    twin_cfg = dataclasses.replace(
        cfg, quant=dataclasses.replace(qcfg, dense_twin=True))
    texts_t = side(twin_cfg)

    res_q = evaluate(texts_q.__getitem__, PROXY_DATASET)
    res_t = evaluate(texts_t.__getitem__, PROXY_DATASET)

    agree = total = 0
    for ex in PROXY_DATASET:
        kwargs_list = ex.get("kwargs") or [{}] * len(
            ex["instruction_id_list"])
        for iid, kw in zip(ex["instruction_id_list"], kwargs_list):
            vq = check_instruction(iid, texts_q[ex["prompt"]], kw)
            vt = check_instruction(iid, texts_t[ex["prompt"]], kw)
            total += 1
            agree += int(vq == vt)

    dq, dt = res_q.to_dict(), res_t.to_dict()
    return {
        "quantized": dq,
        "dense_twin": dt,
        "deltas": {
            "prompt_accuracy": dq["prompt_accuracy"] - dt["prompt_accuracy"],
            "instruction_accuracy": (dq["instruction_accuracy"]
                                     - dt["instruction_accuracy"]),
        },
        "verdict_agreement": agree / total if total else 1.0,
        "n_examples": len(PROXY_DATASET),
        "n_instructions": total,
        "max_new_tokens": max_new_tokens,
    }


if __name__ == "__main__":
    print(json.dumps(run_ifeval_proxy()))
