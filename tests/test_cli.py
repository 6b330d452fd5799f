"""CLI smoke tests (CPU backend, tiny workloads)."""

import json
import subprocess
import sys

import pytest

_BASE = [sys.executable, "-m", "tpusparse.cli"]
_TINY = ["--cpu", "--m", "256", "--n", "256"]


def _run(args):
    return subprocess.run(_BASE + args, capture_output=True, text=True,
                          timeout=240)


def test_check_exit_code_reflects_results():
    r = _run(["check", *_TINY, "--kernels", "dense_xla,sell"])
    assert r.returncode == 0, r.stderr[-500:]
    assert "OK" in r.stdout


def test_bench_json_records():
    r = _run(["bench", *_TINY, "--kernels", "dense_xla", "--format", "json"])
    assert r.returncode == 0, r.stderr[-500:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["kernel"] == "dense_xla" and rec["m"] == 256
    assert rec["us"] > 0


def test_unknown_kernel_rejected():
    r = _run(["check", *_TINY, "--kernels", "nope"])
    assert r.returncode != 0
    assert "unknown kernels" in (r.stdout + r.stderr)


def test_cli_mtx(tmp_path, capsys):
    import numpy as np

    from tpusparse.cli import main

    p = tmp_path / "m.mtx"
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 256, 900)
    cols = rng.integers(0, 256, 900)
    pos = np.unique(rows * 256 + cols)
    lines = ["%%MatrixMarket matrix coordinate real general",
             f"256 256 {len(pos)}"]
    for q in pos:
        lines.append(f"{q // 256 + 1} {q % 256 + 1} "
                     f"{rng.uniform(-1, 1):.5f}")
    p.write_text("\n".join(lines) + "\n")
    assert main(["mtx", str(p), "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "routed to" in out and "OK" in out


def test_cli_mtx_fem_fixture(capsys):
    """The committed FEM MatrixMarket fixture (data/fem_mesh_16384.mtx)
    runs end-to-end: ingest -> stats -> route -> float64-oracle check.
    chip_smoke.py runs the same file on the card."""
    from pathlib import Path

    from tpusparse.cli import main

    fixture = (Path(__file__).resolve().parent.parent
               / "data" / "fem_mesh_16384.mtx")
    assert fixture.exists(), "committed fixture missing"
    assert main(["mtx", str(fixture), "--cpu", "--no-time"]) == 0
    out = capsys.readouterr().out
    assert "routed to" in out and "OK" in out


def test_cli_solve_smoke(capsys):
    from tpusparse.cli import main

    # tiny grid so the whole route->precondition->solve path stays cheap;
    # jacobi (not amg/chebyshev) keeps compile time out of the suite budget
    assert main(["solve", "--side", "16", "--precond", "jacobi",
                 "--tol", "1e-4", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "cg+jacobi" in out and "OK" in out


def test_cli_solve_amg_precond_roundtrip(tmp_path, capsys):
    from tpusparse.cli import main

    p = str(tmp_path / "precond.npz")
    assert main(["solve", "--side", "24", "--precond", "amg",
                 "--save-precond", p, "--tol", "1e-4", "--cpu"]) == 0
    assert "amg saved" in capsys.readouterr().out
    assert main(["solve", "--side", "24", "--precond", "amg",
                 "--precond-file", p, "--tol", "1e-4", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "amg load" in out and "cg+amg" in out and "OK" in out
