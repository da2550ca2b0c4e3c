"""Where the test suite's worker-seconds go: each test's wall time and the
JAX compilation inside it, by file.

As a pytest plugin it records, for every test, its wall time (setup, call
and teardown) and the seconds JAX spent tracing, lowering and compiling
(``jax.monitoring``'s duration events), and the seconds the persistent
compilation cache saved; each process writes one JSON file into
``$SUITE_PROFILE_DIR``:

    SUITE_PROFILE_DIR=/tmp/prof PYTHONPATH=src:scripts JAX_PLATFORMS=cpu \\
        python -m pytest -p suite_profile -p xdist -n 6 --dist loadfile \\
        --junitxml=/tmp/prof/port.xml tests/test_torch_*.py

As a script it sums those files by test file, largest first, and, given
junit files (``--junit A.xml B.xml``), prints each file's worker-seconds in
each of them (a test's junit time is its setup, call and teardown):

    python scripts/suite_profile.py /tmp/prof --junit before.xml after.xml
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import time
import xml.etree.ElementTree as ET

EVENTS = {"/jax/core/compile/jaxpr_trace_duration": "trace",
          "/jax/core/compile/jaxpr_to_mlir_module_duration": "lower",
          "/jax/core/compile/backend_compile_duration": "backend",
          "/jax/compilation_cache/compile_time_saved_sec": "cache_saved"}

_totals: collections.Counter = collections.Counter()
_by_test: dict = {}


def _listener(event: str, duration: float, **_) -> None:
    name = EVENTS.get(event)
    if name is not None:
        _totals[name] += duration


def pytest_configure(config) -> None:
    import jax.monitoring

    jax.monitoring.register_event_duration_secs_listener(_listener)


def pytest_runtest_protocol(item, nextitem):
    before, t0 = dict(_totals), time.perf_counter()
    yield
    row = {k: v - before.get(k, 0.0) for k, v in _totals.items()}
    row["wall"] = time.perf_counter() - t0
    _by_test[item.nodeid] = row


pytest_runtest_protocol.hookwrapper = True


def pytest_unconfigure(config) -> None:
    out = os.environ.get("SUITE_PROFILE_DIR")
    if not out:
        return
    os.makedirs(out, exist_ok=True)
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    with open(os.path.join(out, f"{worker}.json"), "w") as f:
        json.dump(_by_test, f)


def junit_seconds(path: str) -> dict:
    """Worker-seconds by test file in a junit file."""
    per: collections.Counter = collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        module = case.get("classname", "").split(".")
        name = next((m for m in module if m.startswith("test_")), module[-1])
        per[name + ".py"] += float(case.get("time", 0.0))
    return dict(per)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("profile_dir")
    ap.add_argument("--junit", nargs="*", default=[])
    ap.add_argument("--prefix", default="test_torch_", help="files to sum ('' for all)")
    args = ap.parse_args(argv)
    files: dict = collections.defaultdict(collections.Counter)
    for path in glob.glob(os.path.join(args.profile_dir, "*.json")):
        with open(path) as f:
            for nodeid, row in json.load(f).items():
                name = nodeid.split("::")[0].rsplit("/", 1)[-1]
                if name.startswith(args.prefix):
                    files[name].update(row)
                    files[name]["tests"] += 1
    junits = [junit_seconds(p) for p in args.junit]
    cols = ["tests", "wall", "trace", "lower", "backend", "compile %", "cache_saved"]
    print(f"{'file':40s} " + " ".join(f"{c:>11s}" for c in cols)
          + "".join(f" {os.path.basename(p):>14s}" for p in args.junit))
    total = collections.Counter()
    for name, row in sorted(files.items(), key=lambda kv: -kv[1]["wall"]):
        compile_s = row["trace"] + row["lower"] + row["backend"]
        total.update(row)
        share = 100.0 * compile_s / row["wall"] if row["wall"] else 0.0
        vals = [row["tests"], row["wall"], row["trace"], row["lower"], row["backend"], share,
                row["cache_saved"]]
        print(f"{name:40s} " + " ".join(f"{v:11.1f}" for v in vals)
              + "".join(f" {j.get(name, 0.0):14.1f}" for j in junits))
    compile_s = total["trace"] + total["lower"] + total["backend"]
    print(f"{'total':40s} " + " ".join(f"{v:11.1f}" for v in (
        total["tests"], total["wall"], total["trace"], total["lower"], total["backend"],
        100.0 * compile_s / max(total["wall"], 1e-9), total["cache_saved"]))
        + "".join(f" {sum(v for k, v in j.items() if k.startswith(args.prefix)):14.1f}"
                  for j in junits))


if __name__ == "__main__":
    main()
