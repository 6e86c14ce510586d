"""Module-level autouse fixtures that run a port test suite under the
port's sanitizers, as tests/conftest.py runs the reference's busiest
suites under the reference's: ``_torch_sanitizers = armed("lockcheck",
"jitcheck")`` in a test module. The split is the reference's: a lock
cycle, a steady-state rebuild, an unsanctioned hot-path host sync, a torn
read, an aliasing write, a manifested deadlock or a replay divergence
fails the test; held-across and escaped locks, late builds, dtype drift,
cache mutations, journal gaps, write skews, stale memos, drift and
park-watchdog preemptions are warnings. schedcheck runs each test under
one of four fixed seeds, chosen by the test's node id, over the port's
control-plane threads (the test's own thread keeps its real clock);
lockcheck arms with it (its factory seam is schedcheck's interposition
layer), its findings collected only where lockcheck is named."""
import hashlib
import os
import warnings

import pytest

from nomad_tpu_torch import jitcheck, lockcheck, schedcheck, statecheck

SCHEDCHECK_SEEDS = (11, 23, 37, 53)
TESTS = os.path.dirname(os.path.abspath(__file__)) + os.sep


def _seed(nodeid: str) -> int:
    return SCHEDCHECK_SEEDS[int.from_bytes(hashlib.blake2b(
        nodeid.encode(), digest_size=2).digest(), "little")
        % len(SCHEDCHECK_SEEDS)]


def _strip(r):
    return {k: v for k, v in r.items() if k != "stack"}


def _problems(states):
    out = []
    lc = states.get("lockcheck")
    if lc is not None:
        for v in lc["held_across"] + lc["escaped"]:
            warnings.warn(f"lockcheck finding (report-only): {_strip(v)}")
        for i, cyc in enumerate(lc["cycles"]):
            out.append(f"LOCK CYCLE {i}: {' -> '.join(cyc['locks'])}\n"
                       + "\n".join(e["stack"] for e in cyc["edges"]))
    jc = states.get("jitcheck")
    if jc is not None:
        for v in jc["late_builds"] + jc["dtype_drift"] + jc["mutations"]:
            warnings.warn(f"jitcheck finding (report-only): {v}")
        for r in jc["rebuilds"]:
            out.append(f"STEADY-STATE REBUILD at {r['site']}: "
                       f"{r['signature']} x{r['count']}\n{r['stack']}")
        for r in jc["host_syncs"]:
            out.append(f"HOT-PATH HOST SYNC {r['kind']} at {r['site']} "
                       f"x{r['count']} (dispatch {r['label']!r}, evals "
                       f"{r['evals']})\n{r['stack']}")
    sc = states.get("statecheck")
    if sc is not None:
        for v in (sc["journal_gaps"] + sc["write_skews"]
                  + sc["stale_memos"] + sc["drifts"]):
            warnings.warn(f"statecheck finding (report-only): {_strip(v)}")
        for r in sc["torn_reads"]:
            out.append(f"TORN READ ({r['kind']}) in {r['op']} at "
                       f"{r['site']}: versions {r['versions']}\n"
                       f"{r['stack']}")
        for r in sc["aliasing_writes"]:
            out.append(f"ALIASING WRITE ({r['kind']}) at {r['site']}: "
                       f"{r['detail']}\n{r.get('stack', '')}")
    sch = states.get("schedcheck")
    if sch is not None:
        if sch["preemptions"]:
            warnings.warn(f"schedcheck: {sch['preemptions']} park-watchdog "
                          "preemption(s); the schedule was best-effort")
        for r in sch["reports"]:
            if r.get("kind") == "deadlock":
                out.append(f"MANIFESTED DEADLOCK under schedule seed "
                           f"{r['schedule_seed']} at step {r['step']}: "
                           f"{r.get('waiting')}")
            elif r.get("kind") == "divergence":
                out.append(f"REPLAY DIVERGENCE at seed {r['schedule_seed']}")
    return out


def armed(*checkers):
    """An autouse fixture running each test of the module under
    ``checkers`` (names of the port's sanitizer modules)."""
    names = set(checkers)

    @pytest.fixture(autouse=True)
    def _torch_sanitizers(request):
        lock_on = "lockcheck" in names or "schedcheck" in names
        if lock_on:
            # the tests' own locks too (the suites' ordered-lane hooks
            # wait on them): lockcheck's wrappers are schedcheck's seam
            lockcheck.enable(roots=[TESTS])
        if "statecheck" in names:
            statecheck.enable()
        if "jitcheck" in names:
            jitcheck.enable()
        if "schedcheck" in names:
            schedcheck.enable()
            # the test thread stays outside the schedule: the suites
            # drive the reference package beside the port's
            schedcheck.begin_run(_seed(request.node.nodeid), root=False)
        states = {}
        try:
            yield
        finally:
            if "schedcheck" in names:
                schedcheck.end_run()
                states["schedcheck"] = schedcheck.state()
            for name, mod in (("jitcheck", jitcheck),
                              ("statecheck", statecheck),
                              ("lockcheck", lockcheck)):
                if name in names:
                    states[name] = mod.state()
            for mod in (schedcheck, jitcheck, statecheck, lockcheck):
                mod.disable()
                mod._reset_for_tests()
        problems = _problems(states)
        if problems:
            pytest.fail("port sanitizer finding(s) during this test:\n"
                        + "\n".join(problems), pytrace=False)

    return _torch_sanitizers
