"""``repro_torch.analysis.lint``: each corpus file trips exactly its rule,
TH002 gives the reference's JH002 findings on the reference's corpus, and
the port's tree is clean under the committed allowlist."""
import pathlib

import pytest

from repro.analysis.lint import lint_file as ref_lint_file
from repro_torch.analysis.lint import (AllowEntry, lint_file, lint_paths, load_allowlist,
                                       logical_axis_vocab, main)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORPUS = ROOT / "tests" / "torch_analysis_corpus" / "lint"
REF_CORPUS = ROOT / "tests" / "analysis_corpus" / "lint"
PORT = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("fname,rule,hits", [
    ("bad_th001.py", "TH001", 3),       # immediate, in-loop, hot-path
    ("sim/bad_th002.py", "TH002", 3),   # time.time, time.sleep, from-import
    ("bad_th003.py", "TH003", 2),
    ("bad_th004.py", "TH004", 3),       # two mesh axes, one logical axis
])
def test_corpus_file_trips_exactly_its_rule(fname, rule, hits):
    findings = lint_file(CORPUS / fname)
    assert len(findings) == hits, [str(f) for f in findings]
    assert {f.rule for f in findings} == {rule}, [str(f) for f in findings]


def test_th002_gives_the_reference_findings():
    path = REF_CORPUS / "sim" / "bad_jh002.py"
    got = [(f.line, f.col, f.qualname) for f in lint_file(path)]
    want = [(f.line, f.col, f.qualname) for f in ref_lint_file(path)]
    assert got == want and len(got) == 3


def test_th002_only_applies_to_virtual_clock_modules(tmp_path):
    elsewhere = tmp_path / "not_sim.py"
    elsewhere.write_text((CORPUS / "sim" / "bad_th002.py").read_text())
    assert lint_file(elsewhere) == []


def test_logical_vocabulary_is_the_rules_keys():
    assert {"embed", "heads", "vocab", "act_batch", "act_embed"} <= logical_axis_vocab()
    assert not logical_axis_vocab() & {"pod", "data", "model"}


def test_port_tree_is_clean_and_the_allowlist_narrow():
    findings, suppressed = lint_paths([str(PORT)])
    assert findings == [], "\n".join(str(f) for f in findings)
    assert lint_paths([str(PORT)], allowlist=[]) == ([], [])
    # an entry suppresses only its own rule, path and qualname
    hot = CORPUS / "bad_th001.py"
    right = AllowEntry("TH001", "bad_th001.py", "decode_step", "x")
    wrong = AllowEntry("TH001", "bad_th001.py", "wrong_name", "x")
    f_right, s_right = lint_paths([str(hot)], allowlist=[right])
    f_wrong, s_wrong = lint_paths([str(hot)], allowlist=[wrong])
    assert [s.qualname for s in s_right] == ["decode_step"] and len(f_right) == 2
    assert s_wrong == [] and len(f_wrong) == 3


def test_committed_allowlist_entries_are_justified():
    for entry in load_allowlist():
        assert entry.justification, f"{entry} lacks a justification"


def test_cli_exit_codes(capsys):
    assert main([str(PORT)]) == 0
    assert main([str(CORPUS)]) == 1
    out = capsys.readouterr().out
    assert all(f"TH00{i}" in out for i in range(1, 5))
