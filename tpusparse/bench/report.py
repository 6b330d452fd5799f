"""Doc/artifact cross-reference guard.

``verify_docs`` checks that every benchmark artifact and section the docs,
tests and scripts cite exists, that every recorded ``*_error`` key is
mentioned, and that every reading above the physical roofline carries its
flag — so no claim ships without a backing record.
"""

from __future__ import annotations


def verify_docs(root: str | None = None) -> list[str]:
    """Cross-reference check: every claim in the repo docs must have its
    backing artifact (claims that cited sections and JSON files that did
    not exist, and a recorded failure no prose mentioned, have shipped
    before).

    Checks, returning a list of problems (empty = clean):

    - every ``BENCH_<x>.json`` mentioned in CHANGES.md / BENCH.md /
      README.md exists at the repo root; every ``data/<x>.json|mtx|npz``
      mentioned there or in tests/*.py / scripts/*.py exists;
    - every ``§<name>`` citation — in CHANGES.md, in README.md, INSIDE
      BENCH.md itself, and in tests/*.py / scripts/*.py — resolves
      against BENCH.md's ``##`` headers. Matching is exact-word (plus
      singular/plural), NOT prefix: ``§SpMM-wins`` hits "## SpMM
      win-region: ..." but ``§scale`` does NOT hit "## Scaling".
      Multi-word citations (``§gallery floor table``) resolve only if
      the full phrase matches one header, or a word-prefix matches a
      header AND every remaining word appears in that section's body —
      so citing a table/row/law a section doesn't contain fails.
      (Style consequence: prose after a citation must be separated by
      punctuation — "§Solver, above" not "§Solver above".)
    - every ``*_error`` key in a committed ``BENCH_*.json`` or
      ``data/*.json`` record is MENTIONED in BENCH.md — by key name or
      by a distinctive token of the message (e.g. RESOURCE_EXHAUSTED).
      A failure a benchmark recorded is a result; the prose must own it.
    - every roofline value > 1.0 in a repo-written record
      (``BENCH_gallery.json``, ``BENCH_scale.json``, ``data/*.json``)
      carries a truthy ``slope_artifact`` sibling key (the slope timer
      can undershoot on short spans).
      Driver-written round records (``BENCH_r0N.json``) are immutable
      history and exempt.
    """
    import glob as _glob
    import json as _json
    import os
    import re

    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    problems: list[str] = []

    docs = {}
    for name in ("CHANGES.md", "BENCH.md", "README.md"):
        path = os.path.join(root, name)
        if os.path.exists(path):
            with open(path) as f:
                docs[name] = f.read()
    code = {}
    for sub in ("tests", "scripts"):
        for path in sorted(_glob.glob(os.path.join(root, sub, "*.py"))):
            with open(path) as f:
                code[os.path.relpath(path, root)] = f.read()

    for name, text in {**docs, **code}.items():
        for jf in sorted(set(re.findall(r"\bBENCH_[A-Za-z0-9_.-]+\.json",
                                        text))):
            if not os.path.exists(os.path.join(root, jf)):
                problems.append(f"{name} cites {jf}, which does not exist")
        for df in sorted(set(re.findall(
                r"\bdata/[A-Za-z0-9_.-]+\.(?:json|mtx|npz)\b", text))):
            if os.path.exists(os.path.join(root, df)):
                continue
            # a study script's OWN output path (argparse default or
            # open-for-write) legitimately predates its record; prose
            # citing the record before the run does not
            writes = re.search(
                r'(default=|open\(\s*)["\']' + re.escape(df) + r'["\']',
                text)
            if name.endswith(".py") and writes:
                continue
            problems.append(f"{name} cites {df}, which does not exist")

    bench = docs.get("BENCH.md", "")
    # split BENCH.md into (header, body) sections for the body-word rule;
    # ### subsections are first-class citation anchors too
    parts = re.split(r"^#{2,3}\s+(.*)$", bench, flags=re.MULTILINE)
    sections = []           # (header_words, body_word_set)
    strip_cites = re.compile(r"§[A-Za-z0-9_-]+(?:[ ][A-Za-z0-9_-]+){0,3}")
    for i in range(1, len(parts), 2):
        hw = re.findall(r"[a-z0-9]+", parts[i].lower())
        body = parts[i + 1] if i + 1 < len(parts) else ""
        # a §-citation's own text must not satisfy its body-word check
        bw = set(re.findall(r"[a-z0-9]+", strip_cites.sub("", body).lower()))
        sections.append((hw, bw))

    def tok_match(t: str, w: str) -> bool:
        return t == w or t + "s" == w or w + "s" == t

    def resolves(cite_words: list[str]) -> bool:
        # longest word-prefix that fully matches some header; remaining
        # words must appear in that section's body
        for take in range(len(cite_words), 0, -1):
            toks = [t for w in cite_words[:take]
                    for t in re.findall(r"[a-z0-9]+", w.lower())]
            rest = [t for w in cite_words[take:]
                    for t in re.findall(r"[a-z0-9]+", w.lower())]
            for hw, bw in sections:
                if all(any(tok_match(t, w) for w in hw) for t in toks) \
                        and all(any(tok_match(t, w) for w in bw)
                                for t in rest):
                    return True
        return False

    # citation grammar: § + word, then greedily up to 3 more
    # space-separated plain words, TRIMMED at the first English function
    # word — citations name sections/artifacts ("gallery floor table"),
    # prose continuations start with stopwords ("§gallery and ..."); a
    # continuation starting with a content word needs punctuation after
    # the citation. Docs use bare §X (incl. BENCH.md's internal
    # cross-references); code files count only the explicit "BENCH.md §X"
    # form (a bare § in source is not necessarily a BENCH.md citation).
    stop = {"and", "or", "the", "a", "an", "of", "in", "on", "at", "as",
            "is", "are", "to", "for", "with", "by", "from", "this",
            "that", "these", "those", "it", "its", "but", "not", "no",
            "was", "were", "has", "have", "had", "than", "then", "so",
            "if", "when", "where", "which", "who", "whose", "all",
            "any", "both", "each", "above", "below", "here", "there",
            "now", "once", "still", "also"}
    phrase = r"([A-Za-z0-9_-]+(?:[ ][A-Za-z0-9_-]+){0,3})"
    doc_cite_re = re.compile("§" + phrase)
    code_cite_re = re.compile(r"BENCH\.md §" + phrase)
    for name, text in {**docs, **code}.items():
        pat = code_cite_re if name in code else doc_cite_re
        for cite in sorted(set(pat.findall(text))):
            words = cite.split(" ")
            for i, w in enumerate(words):
                if w.lower() in stop:
                    words = words[:i]
                    break
            if words and not resolves(words):
                problems.append(
                    f"{name} cites §{' '.join(words)}, but no BENCH.md "
                    f"section matches it (full-phrase or "
                    f"prefix+body-words)")

    # *_error keys in committed records must be owned by BENCH.md prose
    bench_lower = bench.lower()
    rec_files = sorted(_glob.glob(os.path.join(root, "BENCH_*.json"))
                       + _glob.glob(os.path.join(root, "data", "*.json")))
    flag_exempt = re.compile(r"BENCH_r\d+\.json$")

    def walk(obj, fn):
        if isinstance(obj, dict):
            fn(obj)
            for v in obj.values():
                walk(v, fn)
        elif isinstance(obj, list):
            for v in obj:
                walk(v, fn)

    for path in rec_files:
        rel = os.path.relpath(path, root)
        try:
            with open(path) as f:
                rec = _json.load(f)
        except Exception as e:       # unparseable committed record
            problems.append(f"{rel} is not valid JSON: {e}")
            continue

        def check(d, rel=rel):
            for k, v in d.items():
                if re.search(r"(^|_)error$", k) and v:
                    toks = [k] + re.findall(r"[A-Z][A-Z_]{5,}", str(v)) \
                        + re.findall(r"[A-Za-z]+Error", str(v))
                    if not any(t.lower() in bench_lower for t in toks):
                        problems.append(
                            f"{rel} records {k}={str(v)[:60]!r}, which "
                            f"BENCH.md never mentions — a recorded "
                            f"failure is a result; the prose must own it")
                if "roofline" in k and isinstance(v, (int, float)) \
                        and v > 1.0 and not d.get("slope_artifact") \
                        and not d.get("artifact") \
                        and not flag_exempt.search(rel):
                    problems.append(
                        f"{rel} has {k}={v} > 1.0 with no slope_artifact "
                        f"flag (slope-undershoot law, BENCH.md header)")
        walk(rec, check)
    return problems
