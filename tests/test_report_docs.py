"""Doc/artifact cross-reference guard: cited sections and JSON artifacts
must exist, a recorded failure must be owned by prose, and a reading above
the physical roofline must be flagged."""

import json
from pathlib import Path

from tpusparse.bench.report import verify_docs

_ROOT = Path(__file__).resolve().parent.parent

# Built by concatenation so the guard's own source scan (tests/*.py are
# checked for artifact citations now) does not see a literal phantom.
_PHANTOM_JSON = "BENCH_" + "nonexistent.json"


def test_repo_docs_have_backing_artifacts():
    """Every BENCH_*.json, data/*, and § citation in the repo docs, tests
    and scripts exists/resolves; every recorded *_error is owned by
    BENCH.md prose; every >1.0 roofline reading carries its
    slope_artifact flag."""
    problems = verify_docs(str(_ROOT))
    assert problems == [], "\n".join(problems)


def test_checker_flags_missing_json(tmp_path):
    (tmp_path / "CHANGES.md").write_text(
        f"shipped the run ({_PHANTOM_JSON})\n")
    (tmp_path / "BENCH.md").write_text("# BENCH\n## Scaling\n")
    problems = verify_docs(str(tmp_path))
    assert any(_PHANTOM_JSON in p for p in problems)


def test_checker_flags_missing_data_file(tmp_path):
    (tmp_path / "BENCH.md").write_text(
        "# BENCH\n## Scaling\nrecorded in data/ghost" "_record.json\n")
    problems = verify_docs(str(tmp_path))
    assert any("ghost" in p for p in problems), problems


def test_checker_flags_phantom_section(tmp_path):
    (tmp_path / "CHANGES.md").write_text("recorded in BENCH.md " "§scale\n")
    (tmp_path / "BENCH.md").write_text("# BENCH\n## Scaling\n")
    problems = verify_docs(str(tmp_path))
    assert any("§scale" in p for p in problems), problems


def test_checker_accepts_word_and_plural_matches(tmp_path):
    (tmp_path / "CHANGES.md").write_text(
        "see BENCH.md " "§gallery and BENCH.md " "§SpMM-wins and "
        "BENCH.md " "§Scaling\n")
    (tmp_path / "BENCH.md").write_text(
        "# BENCH\n## Workload gallery: real topologies\n"
        "## SpMM win-region: batched sparse vs dense\n## Scaling\n")
    assert verify_docs(str(tmp_path)) == []


# --- the three r4 escapes, reconstructed -------------------------------

def test_checker_flags_internal_phantom_table_citation(tmp_path):
    """A doc once cited a '§gallery floor table' that did
    not exist anywhere in BENCH.md — an INTERNAL citation the r4 guard
    never scanned. A multi-word citation must either match a header
    fully or have its extra words present in the resolved section's
    body."""
    (tmp_path / "BENCH.md").write_text(
        "# BENCH\n## Workload gallery\nrouted rows and regret.\n"
        "The 73% sits inside the band (§gallery floor table).\n")
    problems = verify_docs(str(tmp_path))
    assert any("gallery floor table" in p for p in problems), problems
    # ... and resolves once the section's body actually contains it
    (tmp_path / "BENCH.md").write_text(
        "# BENCH\n## Workload gallery\nrouted rows and regret.\n"
        "### Gallery floor table\n| floors |\n"
        "The 73% sits inside the band (§gallery floor table).\n")
    assert verify_docs(str(tmp_path)) == []


def test_checker_flags_unmentioned_error_record(tmp_path):
    """A GB-scale record once recorded the train step dying with
    RESOURCE_EXHAUSTED and BENCH.md described the chain as whole. Any
    *_error key in a committed record must be mentioned in BENCH.md (key
    name or a distinctive token of the message)."""
    (tmp_path / ("BENCH_" + "scale.json")).write_text(json.dumps(
        [{"m": 65536, "train_error":
          "JaxRuntimeError: RESOURCE_EXHAUSTED: device backend error"}]))
    (tmp_path / "BENCH.md").write_text(
        "# BENCH\n## GB scale\nthe chain ran whole, all good\n")
    problems = verify_docs(str(tmp_path))
    assert any("train_error" in p for p in problems), problems
    # owning the failure in prose (distinctive token) clears it
    (tmp_path / "BENCH.md").write_text(
        "# BENCH\n## GB scale\nthe train step died with "
        "RESOURCE_EXHAUSTED; sizing law below\n")
    assert verify_docs(str(tmp_path)) == []


def test_checker_flags_naked_over_roofline_reading(tmp_path):
    """r4 weak #3: six >1.0-roofline gallery readings carried no flag
    while the prose claimed they all did. Any roofline > 1.0 in a
    repo-written record needs a truthy slope_artifact sibling."""
    (tmp_path / ("BENCH_" + "gallery.json")).write_text(json.dumps(
        [{"workload": "mesh2d-96",
          "rows": {"tcsr": {"us": 4.6, "roofline": 1.231}}}]))
    (tmp_path / "BENCH.md").write_text("# BENCH\n## Workload gallery\n")
    problems = verify_docs(str(tmp_path))
    assert any("1.231" in p for p in problems), problems
    (tmp_path / ("BENCH_" + "gallery.json")).write_text(json.dumps(
        [{"workload": "mesh2d-96",
          "rows": {"tcsr": {"us": 4.6, "roofline": 1.231,
                            "slope_artifact": True}}}]))
    assert verify_docs(str(tmp_path)) == []


def test_checker_exempts_driver_round_records(tmp_path):
    """Driver round records ("BENCH_r0" + N) are immutable history (r1's 1.012
    dense_xla headline predates the flagging convention)."""
    (tmp_path / ("BENCH_" + "r01.json")).write_text(json.dumps(
        {"parsed": {"detail": {"dense_xla": {"roofline_frac": 1.012}}}}))
    (tmp_path / "BENCH.md").write_text("# BENCH\n## Scaling\n")
    assert verify_docs(str(tmp_path)) == []
