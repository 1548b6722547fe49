"""crlint over the port: the carried linter (pinned byte-equal to the JAX
package's by ``test_torch_checkpoint.py::CARRIED``) flags the lint fixtures
exactly as the reference does, and its gate over ``src/repro_torch`` — the
serving code and its example included — finds nothing beyond the port's
baseline, which is the reference's baseline with ``src/repro/`` read as
``src/repro_torch/``."""

import os
import subprocess
import sys

import pytest

from repro.analysis import crlint as ref_crlint
from repro_torch.analysis import crlint

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "lint_fixtures")
BASELINE = os.path.join(REPO, "crlint_baseline_torch.txt")
GATED = ("src/repro_torch", "examples/torch_serve_swap.py")
# fixture -> the checker of every finding and their count
# (``tests/test_crlint.py``)
EXPECTED = {"bad_raw_os.py": ("CRL001", 9), "bad_publish.py": ("CRL002", 4),
            "bad_guard.py": ("CRL003", 2), "bad_pairing.py": ("CRL004", 1),
            "bad_swallow.py": ("CRL005", 3), "bad_clock.py": ("CRL006", 5),
            "clean_core.py": (None, 0)}


def _in_repo(fn, *args):
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.crlint", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)


@pytest.fixture(scope="module")
def findings():
    return _in_repo(crlint.analyze_paths, [FIXTURES])


@pytest.mark.parametrize("fixture", sorted(EXPECTED))
def test_fixture_flagged_as_the_reference_flags_it(findings, fixture):
    got = [f for f in findings if os.path.basename(f.path) == fixture]
    checker, n = EXPECTED[fixture]
    assert len(got) == n and all(f.checker == checker for f in got)


def test_fixture_findings_equal_the_reference_linter():
    want = _in_repo(ref_crlint.analyze_paths, [FIXTURES])
    got = _in_repo(crlint.analyze_paths, [FIXTURES])
    assert [f.render() for f in got] == [f.render() for f in want]


def test_port_baseline_is_the_reference_baseline_renamed():
    ref = ref_crlint.load_baseline(os.path.join(REPO, "crlint_baseline.txt"))
    port = crlint.load_baseline(BASELINE)
    assert sum(port.values()) == 7
    assert port == type(ref)({k.replace(":src/repro/", ":src/repro_torch/"):
                              v for k, v in ref.items()})


def test_gate_over_the_port_has_no_new_findings():
    p = _cli("--baseline", BASELINE, *GATED)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.strip().splitlines()[-1] == \
        "crlint: 0 new finding(s), 7 baselined"


def test_reverting_a_shim_in_the_port_fails_the_gate(tmp_path):
    """faults.replace -> os.replace in the port's checkpoint module must be
    a fresh finding the port's baseline misses."""
    with open(os.path.join(REPO, "src", "repro_torch", "core",
                           "checkpoint.py"), encoding="utf-8") as fh:
        src = fh.read()
    assert "faults.replace(" in src
    bad = tmp_path / "core" / "checkpoint.py"
    bad.parent.mkdir()
    bad.write_text("# crlint: fixture\n"
                   + src.replace("faults.replace(", "os.replace(", 1))
    p = _cli("--baseline", BASELINE, str(bad))
    assert p.returncode == 1
    assert "CRL001" in p.stdout and "os.replace" in p.stdout
