"""IFEval harness: instruction-following evaluation of a generate
function (a copy of ``quantizations_tpu/evals/ifeval.py``; the port
imports nothing of the JAX package).

It reads the official ``input_data.jsonl`` format (``{"key", "prompt",
"instruction_id_list", "kwargs"}``), drives any ``prompt -> response``
callable (the slot ``Engine`` or a generate loop with a tokenizer) and
scores the responses with rule-based checkers. Text scoring only: no
tensor and no device.

The checker registry carries the official google-research
implementation's logic for all 25 instruction ids. Unknown ids are
reported as ``skipped`` rather than passed, so a score is conservative
and comparable between two models scored by the same rules, which is
what the parity claim needs.

Two checkers stand in for the official third-party dependencies:

- ``length_constraints:number_sentences``: the official counter is
  nltk's pretrained English punkt. Its pickle is a download, so the
  same punkt algorithm (``nltk.tokenize.punkt.PunktSentenceTokenizer``)
  runs with a curated English abbreviation set. Without ``nltk`` a
  regex splitter counts instead (:func:`sentence_splitter` says which
  one a process uses); both arms of one run share it.
- ``language:response_language``: the official checker is
  ``langdetect.detect(response) == language``. :func:`detect_language`
  decides by Unicode script for the ~20 non-Latin-script languages, and
  by stopword and diacritic scoring for Latin-script languages.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
from typing import Callable, Dict, List, Optional

__all__ = ["check_instruction", "evaluate", "IFEvalResult", "CHECKERS",
           "OFFICIAL_INSTRUCTION_IDS", "detect_language",
           "sentence_splitter"]


# --------------------------------------------------------------------------
# Instruction checkers: response text + kwargs -> bool
# --------------------------------------------------------------------------

# The checkers below port the OFFICIAL google-research IFEval logic
# (instruction_following_eval/instructions.py) for every covered id:
# same regexes, same relation semantics ("at least" / "less than"),
# same edge-case handling (empty paragraph rules, isupper()/islower(),
# word-boundary forbidden words, strict two-responses splitting).
def _num_words(text: str) -> int:
    return len(re.findall(r"\w+", text))


# Curated English abbreviations for the punkt tokenizer (stand-in for
# the trained english.pickle's learned set; punkt stores them lowercase
# WITHOUT the trailing period, internal periods kept).
_PUNKT_ABBREVS = frozenset((
    "dr", "mr", "mrs", "ms", "prof", "rev", "hon", "st", "jr", "sr",
    "etc", "e.g", "i.e", "vs", "viz", "cf", "al", "inc", "ltd", "co",
    "corp", "dept", "fig", "figs", "gen", "gov", "sen", "rep", "capt",
    "sgt", "col", "lt", "maj", "no", "nos", "op", "pp", "p", "vol",
    "approx", "appt", "apt", "est", "min", "max", "misc", "u.s", "u.k",
    "u.s.a", "a.m", "p.m", "jan", "feb", "mar", "apr", "jun", "jul",
    "aug", "sep", "sept", "oct", "nov", "dec", "mon", "tue", "wed",
    "thu", "fri", "sat", "sun", "ave", "blvd", "rd", "ph.d", "m.d",
    "b.a", "m.a", "d.c", "mt", "ft", "oz", "lbs", "sq",
))


@functools.lru_cache(maxsize=1)
def _sentence_tokenizer():
    try:
        from nltk.tokenize.punkt import (PunktParameters,
                                         PunktSentenceTokenizer)
    except Exception:  # pragma: no cover - without nltk
        return None
    params = PunktParameters()
    params.abbrev_types = set(_PUNKT_ABBREVS)
    return PunktSentenceTokenizer(params)


def sentence_splitter() -> str:
    """Which sentence counter this process uses: ``"nltk_punkt"`` or
    ``"regex"`` (no ``nltk``)."""
    return "regex" if _sentence_tokenizer() is None else "nltk_punkt"


def _num_sentences(text: str) -> int:
    # official: instructions_util.count_sentences -> punkt tokenize
    tok = _sentence_tokenizer()
    if tok is None:  # pragma: no cover - regex fallback
        return len([s for s in re.split(r"[.!?]+", text) if s.strip()])
    return len(tok.tokenize(text))


def _check_keywords_existence(text, keywords=(), **_):
    # official: re.search(keyword, value, IGNORECASE) per keyword
    return all(re.search(k, text, flags=re.IGNORECASE) for k in keywords)


def _check_keywords_forbidden(text, forbidden_words=(), **_):
    # official: word-boundary search — "car" does NOT match "scarf"
    return not any(
        re.search(r"\b" + w + r"\b", text, flags=re.IGNORECASE)
        for w in forbidden_words)


def _check_keywords_frequency(text, keyword="", frequency=1,
                              relation="at least", **_):
    n = len(re.findall(keyword, text, flags=re.IGNORECASE))
    return n >= frequency if relation == "at least" else n < frequency


def _check_letter_frequency(text, letter="", let_frequency=1,
                            let_relation="at least", **_):
    n = text.lower().count(letter.lower())
    return (n >= let_frequency if let_relation == "at least"
            else n < let_frequency)


def _check_length_words(text, num_words=0, relation="at least", **_):
    n = _num_words(text)
    return n >= num_words if relation == "at least" else n < num_words


def _check_length_sentences(text, num_sentences=0, relation="at least", **_):
    n = _num_sentences(text)
    return (n >= num_sentences if relation == "at least"
            else n < num_sentences)


def _check_num_paragraphs(text, num_paragraphs=0, **_):
    # official: split on ***; empty FIRST/LAST chunks are dropped, an
    # empty INTERIOR chunk fails outright
    paras = re.split(r"\s?\*\*\*\s?", text)
    n = len(paras)
    for i, p in enumerate(paras):
        if not p.strip():
            if i in (0, len(paras) - 1):
                n -= 1
            else:
                return False
    return n == num_paragraphs


def _check_nth_paragraph_first_word(text, num_paragraphs=0,
                                    nth_paragraph=1, first_word="", **_):
    paras = re.split(r"\n\n", text)
    n = len(paras)
    for p in paras:
        if not p.strip():
            n -= 1
    if nth_paragraph <= len(paras):
        para = paras[nth_paragraph - 1].strip()
        if not para:
            return False
    else:
        return False
    word = para.split()[0].strip().lstrip("'\"")
    got = ""
    for ch in word:
        if ch in ".,?!'\"":
            break
        got += ch.lower()
    return n == num_paragraphs and got == first_word.lower()


def _check_num_bullets(text, num_bullets=0, **_):
    # official: "* item" lines (excluding "**bold") plus "-" lines
    star = re.findall(r"^\s*\*[^\*].*$", text, flags=re.MULTILINE)
    dash = re.findall(r"^\s*-.*$", text, flags=re.MULTILINE)
    return len(star) + len(dash) == num_bullets


def _check_constrained_response(text, **_):
    options = ("My answer is yes.", "My answer is no.",
               "My answer is maybe.")
    t = text.strip()
    return any(o in t for o in options)


def _check_highlighted_sections(text, num_highlights=0, **_):
    n = 0
    for h in re.findall(r"\*[^\n\*]*\*", text):
        if h.strip("*").strip():
            n += 1
    for h in re.findall(r"\*\*[^\n\*]*\*\*", text):
        if h.removeprefix("**").removesuffix("**").strip():
            n += 1
    return n >= num_highlights


def _check_title(text, **_):
    return any(t.strip("<>").strip()
               for t in re.findall(r"<<[^\n]+>>", text))


def _check_json_format(text, **_):
    try:
        json.loads(text.strip().removeprefix("```json").removeprefix("```")
                   .removesuffix("```").strip())
        return True
    except Exception:
        return False


def _check_no_comma(text, **_):
    return "," not in text


def _check_quotation(text, **_):
    t = text.strip()
    return len(t) > 1 and t.startswith('"') and t.endswith('"')


def _check_end_phrase(text, end_phrase="", **_):
    # official: strip whole-response whitespace and surrounding quotes
    # only — a trailing period after the phrase FAILS
    return text.strip().strip('"').lower().endswith(
        end_phrase.strip().lower())


def _check_all_lowercase(text, **_):
    return text.islower()


def _check_all_capital(text, **_):
    return text.isupper()


def _check_capital_word_frequency(text, capital_frequency=0,
                                  capital_relation="at least", **_):
    # official tokenizes with nltk and counts word.isupper() — single
    # capitals like "I" count
    n = sum(1 for w in re.findall(r"[A-Za-z]+", text) if w.isupper())
    return (n >= capital_frequency if capital_relation == "at least"
            else n < capital_frequency)


def _check_repeat_prompt(text, prompt_to_repeat="", **_):
    return text.strip().lower().startswith(prompt_to_repeat.strip().lower())


def _check_two_responses(text, **_):
    # official: split on ******; empty interior chunks fail, the two
    # responses must be non-empty and distinct
    chunks = text.split("******")
    valid = []
    for i, c in enumerate(chunks):
        if not c.strip():
            if i not in (0, len(chunks) - 1):
                return False
        else:
            valid.append(c)
    return len(valid) == 2 and valid[0].strip() != valid[1].strip()


def _check_num_placeholders(text, num_placeholders=0, **_):
    return len(re.findall(r"\[.*?\]", text)) >= num_placeholders


def _check_postscript(text, postscript_marker="P.S.", **_):
    t = text.lower()
    if postscript_marker == "P.P.S":
        pattern = r"\s*p\.\s?p\.\s?s.*$"
    elif postscript_marker == "P.S.":
        pattern = r"\s*p\.\s?s\..*$"
    else:
        pattern = r"\s*" + re.escape(postscript_marker.lower()) + r".*$"
    return bool(re.findall(pattern, t, flags=re.MULTILINE))


def _check_num_sections(text, num_sections=0, section_spliter="Section",
                        **_):
    # official: count splitter occurrences via re.split, AT LEAST
    # semantics, case-sensitive
    pattern = r"\s?" + re.escape(section_spliter) + r"\s?\d+\s?"
    return len(re.split(pattern, text)) - 1 >= num_sections


# --------------------------------------------------------------------------
# Language identification (stand-in for the official langdetect call)
# --------------------------------------------------------------------------

# Unicode-script blocks that map to a single ISO 639-1 code (or to a
# small ambiguous family resolved below). Ranges are inclusive.
_SCRIPT_BLOCKS = (
    (0x0590, 0x05FF, "he"),   # Hebrew
    (0x0600, 0x06FF, "_arab"),  # Arabic family: ar / fa / ur
    (0x0900, 0x097F, "_deva"),  # Devanagari family: hi / mr / ne
    (0x0980, 0x09FF, "bn"),   # Bengali
    (0x0A00, 0x0A7F, "pa"),   # Gurmukhi -> Punjabi
    (0x0A80, 0x0AFF, "gu"),   # Gujarati
    (0x0B00, 0x0B7F, "or"),   # Oriya
    (0x0B80, 0x0BFF, "ta"),   # Tamil
    (0x0C00, 0x0C7F, "te"),   # Telugu
    (0x0C80, 0x0CFF, "kn"),   # Kannada
    (0x0D00, 0x0D7F, "ml"),   # Malayalam
    (0x0D80, 0x0DFF, "si"),   # Sinhala
    (0x0E00, 0x0E7F, "th"),   # Thai
    (0x0E80, 0x0EFF, "lo"),   # Lao
    (0x1000, 0x109F, "my"),   # Myanmar
    (0x10A0, 0x10FF, "ka"),   # Georgian
    (0x1200, 0x137F, "am"),   # Ethiopic -> Amharic
    (0x1780, 0x17FF, "km"),   # Khmer
    (0x0370, 0x03FF, "el"),   # Greek
    (0x0400, 0x04FF, "_cyrl"),  # Cyrillic family: ru / uk / bg / sr
    (0x0530, 0x058F, "hy"),   # Armenian
    (0x3040, 0x30FF, "ja"),   # Hiragana + Katakana
    (0xAC00, 0xD7AF, "ko"),   # Hangul syllables
    (0x1100, 0x11FF, "ko"),   # Hangul jamo
    (0x4E00, 0x9FFF, "zh-cn"),  # CJK unified (kana wins if present)
)

# Latin-script stopword profiles (token sets, lowercase). Scored by hit
# count; a language-distinctive character adds a large boost.
_LATIN_STOPWORDS = {
    "en": {"the", "is", "are", "was", "and", "of", "to", "in", "that",
           "it", "you", "for", "with", "this", "have", "not", "be"},
    "de": {"der", "die", "das", "und", "ist", "nicht", "ein", "eine",
           "mit", "für", "auf", "sich", "dass", "ich", "auch", "werden"},
    "fr": {"le", "la", "les", "et", "est", "une", "des", "que", "pour",
           "dans", "qui", "pas", "vous", "avec", "sont", "nous"},
    "es": {"el", "los", "las", "es", "una", "que", "para", "con", "por",
           "del", "como", "más", "pero", "está", "también"},
    "it": {"il", "che", "di", "è", "una", "per", "con", "del", "sono",
           "come", "anche", "questo", "della", "gli", "non"},
    "pt": {"o", "os", "as", "é", "uma", "que", "para", "com", "não",
           "mais", "você", "como", "dos", "pela", "são"},
    "nl": {"de", "het", "een", "en", "van", "is", "dat", "niet", "met",
           "voor", "zijn", "ook", "maar", "naar"},
    "sw": {"na", "ya", "wa", "kwa", "ni", "za", "katika", "la", "kuwa",
           "hii", "cha", "kama", "yake", "hata", "sana"},
    "fi": {"ja", "on", "ei", "että", "se", "hän", "mutta", "oli",
           "niin", "kun", "myös", "voi", "ovat", "tämä"},
    "vi": {"và", "là", "của", "có", "không", "được", "người", "trong",
           "này", "cho", "một", "các", "những"},
    "id": {"yang", "dan", "di", "itu", "dengan", "untuk", "tidak",
           "ini", "dari", "akan", "pada", "adalah"},
    "pl": {"jest", "nie", "się", "na", "że", "jak", "ale", "tak", "do",
           "co", "przez", "oraz"},
    "tr": {"bir", "ve", "bu", "için", "ile", "olarak", "çok", "daha",
           "gibi", "ancak", "olan"},
}

# Distinctive characters: presence is near-proof for the language among
# Latin-script candidates (checked against the whole text).
_LATIN_MARKERS = {
    "vi": "ăđơưạảấầậắằặẹẻẽếềểệịọỏốồộớờợụủứừựỳỵỷỹ",
    "pl": "łżźćśąęń",
    "tr": "ışğİ",
    "pt": "ãõç",
    "es": "ñ¿¡",
    "de": "ß",
}

# Urdu-specific letters (also exclude Persian), then Persian-specific
# (shared with Urdu, so test Urdu first), else Arabic.
_URDU_CHARS = "ےڑٹڈںھۓ"
_PERSIAN_CHARS = "گچپژ"
# Devanagari disambiguation by high-frequency function words.
_DEVA_WORDS = {
    "ne": {"छ", "छन्", "गर्न", "भएको", "गरेको", "हुन्छ", "लागि",
           "गर्नुहोस्", "यो", "हो", "मा", "पनि", "बस्छ", "गर्छ"},
    "mr": {"आहे", "आणि", "मध्ये", "येथे", "आहेत", "करण्यासाठी", "होते"},
    "hi": {"है", "और", "के", "में", "की", "से", "हैं", "किया", "करने"},
}
_CYRL_MARKERS = (("uk", "іїєґ"), ("sr", "јљњђћџ"))


def detect_language(text: str) -> str:
    """Best-effort ISO 639-1 code for ``text`` (langdetect stand-in).

    Non-Latin scripts are identified exactly by Unicode block (with
    ar/fa/ur, hi/mr/ne, ru/uk/bg/sr disambiguation); Latin scripts by
    stopword + diacritic scoring with an ``en`` default.
    """
    counts: Dict[str, int] = {}
    for ch in text:
        cp = ord(ch)
        for lo, hi, code in _SCRIPT_BLOCKS:
            if lo <= cp <= hi:
                counts[code] = counts.get(code, 0) + 1
                break
    if counts:
        top = max(counts, key=counts.get)
        if top == "zh-cn" and counts.get("ja"):
            top = "ja"  # kanji + any kana = Japanese
        if top == "_arab":
            if any(c in text for c in _URDU_CHARS):
                return "ur"
            if any(c in text for c in _PERSIAN_CHARS):
                return "fa"
            return "ar"
        if top == "_deva":
            words = set(re.findall(r"[ऀ-ॿ]+", text))
            best, best_n = "hi", 0
            for code, vocab in _DEVA_WORDS.items():
                n = len(words & vocab)
                if n > best_n:
                    best, best_n = code, n
            return best
        if top == "_cyrl":
            for code, marks in _CYRL_MARKERS:
                if any(c in text for c in marks):
                    return code
            if text.count("ъ") >= 2:  # modern Russian rarely uses it
                return "bg"
            return "ru"
        return top
    # Latin script: stopwords + distinctive diacritics.
    tokens = re.findall(r"[^\W\d_]+", text.lower(), flags=re.UNICODE)
    tokset = set(tokens)
    scores = {code: len(tokset & words)
              for code, words in _LATIN_STOPWORDS.items()}
    for code, marks in _LATIN_MARKERS.items():
        if any(c in text for c in marks):
            scores[code] = scores.get(code, 0) + 4
    best = max(scores, key=scores.get)
    return best if scores[best] > 0 else "en"


def _check_response_language(text, language="en", **_):
    # official: langdetect.detect(value) == self._language
    return detect_language(text) == language


CHECKERS: Dict[str, Callable[..., bool]] = {
    "language:response_language": _check_response_language,
    "keywords:existence": _check_keywords_existence,
    "keywords:forbidden_words": _check_keywords_forbidden,
    "keywords:frequency": _check_keywords_frequency,
    "keywords:letter_frequency": _check_letter_frequency,
    "length_constraints:number_words": _check_length_words,
    "length_constraints:number_sentences": _check_length_sentences,
    "length_constraints:number_paragraphs": _check_num_paragraphs,
    "length_constraints:nth_paragraph_first_word":
        _check_nth_paragraph_first_word,
    "detectable_format:number_bullet_lists": _check_num_bullets,
    "detectable_format:constrained_response": _check_constrained_response,
    "detectable_format:number_highlighted_sections":
        _check_highlighted_sections,
    "detectable_format:title": _check_title,
    "detectable_format:json_format": _check_json_format,
    "detectable_format:multiple_sections": _check_num_sections,
    "detectable_content:number_placeholders": _check_num_placeholders,
    "detectable_content:postscript": _check_postscript,
    "punctuation:no_comma": _check_no_comma,
    "startend:quotation": _check_quotation,
    "startend:end_checker": _check_end_phrase,
    "change_case:english_lowercase": _check_all_lowercase,
    "change_case:english_capital": _check_all_capital,
    "change_case:capital_word_frequency": _check_capital_word_frequency,
    "combination:repeat_prompt": _check_repeat_prompt,
    "combination:two_responses": _check_two_responses,
}

# Official instruction-id universe (instructions_registry.py): 25 ids.
# All 25 are covered (two named approximations: punkt parameters and
# the langdetect stand-in — see module docstring).
OFFICIAL_INSTRUCTION_IDS = tuple(sorted(CHECKERS))


def check_instruction(instruction_id: str, response: str,
                      kwargs: Optional[dict]) -> Optional[bool]:
    """True/False = pass/fail; None = no checker for this id."""
    fn = CHECKERS.get(instruction_id)
    if fn is None:
        return None
    kw = {k: v for k, v in (kwargs or {}).items() if v is not None}
    try:
        return bool(fn(response, **kw))
    except TypeError:
        return bool(fn(response))


@dataclasses.dataclass
class IFEvalResult:
    prompt_total: int = 0
    prompt_correct: int = 0           # strict prompt-level accuracy
    instruction_total: int = 0
    instruction_correct: int = 0
    skipped_instructions: int = 0

    @property
    def prompt_accuracy(self) -> float:
        return (self.prompt_correct / self.prompt_total
                if self.prompt_total else 0.0)

    @property
    def instruction_accuracy(self) -> float:
        return (self.instruction_correct / self.instruction_total
                if self.instruction_total else 0.0)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["prompt_accuracy"] = self.prompt_accuracy
        d["instruction_accuracy"] = self.instruction_accuracy
        return d


def evaluate(
    generate_fn: Callable[[str], str],
    dataset: List[dict],
) -> IFEvalResult:
    """Score ``generate_fn`` over IFEval examples.

    ``dataset``: list of dicts in the official jsonl schema. Use
    ``[json.loads(l) for l in open(path)]`` to load the released file.
    """
    res = IFEvalResult()
    for ex in dataset:
        response = generate_fn(ex["prompt"])
        ids = ex["instruction_id_list"]
        kwargs_list = ex.get("kwargs") or [{}] * len(ids)
        ok_all = True
        for iid, kw in zip(ids, kwargs_list):
            verdict = check_instruction(iid, response, kw)
            if verdict is None:
                res.skipped_instructions += 1
                ok_all = False
                continue
            res.instruction_total += 1
            if verdict:
                res.instruction_correct += 1
            else:
                ok_all = False
        res.prompt_total += 1
        if ok_all:
            res.prompt_correct += 1
    return res
