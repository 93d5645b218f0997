"""The port's reprolint (``repro_torch.analysis``) against the reference's
(``repro.analysis``), and the int guard of ``kernels._build.function``.

  * on the reference's own fixtures (tests/analysis_fixtures) the two
    analyzers give the same (rule, line) findings for every rule the port
    keeps; the one place they differ is TRC004 on a builtin, which the
    port exempts (tests/torch_analysis_fixtures/trc004_builtins.py);
  * KRN001 flags C entries reached around the guard or whose code skips
    ``_build.check`` (its own fixtures);
  * ``src/repro_torch`` lints clean, and the reference's analyzer finds
    nothing in it but that builtin;
  * the CLI keeps the reference's exit codes;
  * a C entry refuses an int past its ctypes type before any launch;
  * ``--sanitize-smoke`` holds the wrappers' twins to their oracles.
"""
import ctypes
import os
import subprocess
import sys

import pytest

import repro.analysis as RA
import repro_torch.analysis as TA
from repro_torch.analysis import launches, smoke
from repro_torch.analysis.findings import RULES
from repro_torch.kernels import _build

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "analysis_fixtures")
OWN = os.path.join(TESTS, "torch_analysis_fixtures")
PORT = os.path.join(REPO, "src", "repro_torch")

#: the reference's rules that carry over, by fixture name
SHARED = ["lck001", "lck002", "lck003", "lck004", "sup001", "tel001",
          "trc003", "trc004"]


def _fixture(name, where=FIXTURES):
    return os.path.join(where, name + ".py")


def _found(findings):
    return sorted((f.rule, f.line, f.suppressed) for f in findings)


@pytest.mark.parametrize("twin", ["bad", "good"])
@pytest.mark.parametrize("rule", SHARED)
def test_findings_match_the_reference(rule, twin):
    path = _fixture(f"{rule}_{twin}")
    assert _found(TA.analyze([path])) == _found(RA.analyze([path]))


@pytest.mark.parametrize("rule", SHARED)
def test_bad_twin_flags_and_good_twin_is_silent(rule):
    live = {f.rule for f in TA.analyze([_fixture(rule + "_bad")])
            if not f.suppressed}
    assert rule.upper() in live
    good = [f for f in TA.analyze([_fixture(rule + "_good")])
            if not f.suppressed]
    assert not good, [f.format() for f in good]


def test_builtins_are_exempt_from_trc004():
    """The one stated difference: the reference flags the entry's
    ``len`` as a value missing from the key (a false positive: a builtin
    is no value an entry differs by); both flag ``scale``."""
    path = _fixture("trc004_builtins", OWN)
    ref = [f.message for f in RA.analyze([path]) if f.rule == "TRC004"]
    port = [f.message for f in TA.analyze([path]) if f.rule == "TRC004"]
    assert any("'len'" in m for m in ref)
    assert [m for m in ref if "'len'" not in m] == port
    assert len(port) == 1 and "'scale'" in port[0]


def test_krn001_flags_entries_around_the_guard():
    bad = [f for f in TA.analyze([_fixture("krn001_bad", OWN)])
           if f.rule == "KRN001"]
    assert [f.line for f in bad] == [9, 15, 19]
    assert "CDLL" in bad[0].message and "_build.check" in bad[1].message
    assert "_library" in bad[2].message
    assert TA.analyze([_fixture("krn001_good", OWN)]) == []


@pytest.mark.parametrize("rule", ["TRC001", "TRC002", "PLK001", "PLK002",
                                  "PLK003"])
def test_rules_without_a_counterpart_stay_out_of_the_catalog(rule):
    """No tracers, no Pallas and no kernel bodies in Python: the port
    keeps none of these (README, "Static analysis")."""
    from repro.analysis.findings import RULES as REF_RULES
    assert rule in REF_RULES and rule not in RULES


def test_the_port_lints_clean():
    assert TA.DEFAULT_ROOTS == (PORT,)
    live = [f.format() for f in TA.analyze() if not f.suppressed]
    assert not live, live


def test_the_reference_finds_only_the_builtin_in_the_port():
    """The reference's analyzer over src/repro_torch: the LCK001 faults it
    found (``_note_trace``, ``IndexStore._trim``) are repaired, and what is
    left is its TRC004 on ``len``."""
    left = RA.analyze([PORT])
    assert left and all(f.rule == "TRC004" and "'len'" in f.message
                        for f in left), [f.format() for f in left]


def test_the_kernel_wrappers_name_every_c_entry():
    names = {(lib, fn) for lib, fn, _, _ in launches.c_entries()}
    assert len(names) == 15
    assert ("bvh_traverse", "bvh_knn_launch") in names
    assert ("fine_knn", "fine_knn_rope_launch") in names


def test_python_m_runs_the_default_pass():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "reprolint (default): 0 finding(s), " \
        "0 suppressed"


def test_cli_exit_codes(capsys):
    from repro_torch.analysis.__main__ import main
    assert main([PORT]) == 0
    assert main([_fixture("lck001_bad"), _fixture("krn001_bad", OWN)]) == 1
    assert "KRN001" in capsys.readouterr().out
    assert main([os.path.join(OWN, "no_such_file.py")]) == 2
    assert "internal error" in capsys.readouterr().err
    assert main(["--list-rules"]) == 0
    listed = {line.split()[0] for line in
              capsys.readouterr().out.splitlines()}
    assert listed == set(RULES)


def test_strict_needs_a_card(capsys):
    """--strict launches every kernel once; without a card it says so and
    exits 2 rather than pass silently."""
    import torch
    from repro_torch.analysis.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the cuda case runs --strict")
    assert main(["--strict"]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the int guard of kernels._build.function
# ---------------------------------------------------------------------------

def test_ctypes_wraps_an_int_past_int32():
    """The fault the guard repairs: a raw ctypes c_int argument wraps."""
    libc = ctypes.CDLL(None)
    raw = libc.abs
    raw.argtypes, raw.restype = [ctypes.c_int], ctypes.c_int
    assert raw((1 << 31) + 5) == 2147483643 and raw(1 << 40) == 0
    guarded = _build.Entry("libc", "abs", raw, [ctypes.c_int])
    assert guarded(-5) == 5
    with pytest.raises(OverflowError, match="libc.abs: argument 0"):
        guarded((1 << 31) + 5)


@pytest.mark.parametrize("bad", [1 << 31, 1 << 40, -(1 << 31) - 1])
def test_a_c_entry_refuses_a_size_past_int32_and_launches_nothing(
        monkeypatch, bad):
    launched = []

    def fake_entry(*args):
        launched.append(args)
        return 0

    class FakeLibrary:
        fake_launch = fake_entry

    monkeypatch.setattr(_build, "_library", lambda lib: FakeLibrary)
    monkeypatch.setattr(_build, "_FUNCS", {})
    fn = _build.function("fakelib", "fake_launch",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_float])
    assert isinstance(fn, _build.Entry)
    assert fn(None, 7, 0.5) == 0 and fn.calls == 1
    with pytest.raises(OverflowError,
                       match=r"fakelib.fake_launch: argument 1 \(c_int\)"):
        fn(None, bad, 0.5)
    assert len(launched) == 1 and fn.calls == 1
    assert fn.int_args == [(1, -(1 << 31), (1 << 31) - 1)]


# ---------------------------------------------------------------------------
# the sanitize smoke and the strict pass
# ---------------------------------------------------------------------------

def test_sanitize_smoke_holds_the_twins_to_their_oracles(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    lines = []
    assert smoke.run(n=1000, q=128, echo=lines.append) == 0
    assert lines[-1] == "sanitize smoke: all kernel contracts held on cpu"
    assert "REPRO_SANITIZE" not in os.environ      # restored after the run


@pytest.mark.cuda
def test_strict_pass_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    lines = []
    assert launches.strict(echo=lines.append) == []
    assert sum(line.startswith("  guard ok") for line in lines) == 15
