"""Run one file of the PyTorch port's test cases in a child process.

The port's cases live in ``tests/torch_cases/cases_*.py``, which pytest does
not collect by itself. Each ``tests/test_torch_*.py`` holds one test that
runs one such file in a fresh ``python -m pytest`` process and passes when
every case there passed. Two facts of the suite's runtime shape this:

- XLA:CPU (jaxlib 0.9.0) segfaults in some compiles late in a long-lived
  process, depending on which test files ran in it before: run in one
  process, ``test_dim2_queries``, ``test_narrowphase``, ``test_dim2``,
  ``test_scenes``, ``test_character`` and then ``test_trimesh`` crash in
  ``test_trimesh``. The suite runs under pytest-xdist with ``--dist
  loadfile``, which hands out whole files, the files with the most tests
  first. With one test per file, the port's files are handed out after
  every JAX file, so the JAX files share workers as they do without the
  port.
- No worker imports ``torch``: the child imports JAX and PyTorch, runs for
  well under a minute and exits.
"""

import os
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
CASES_DIR = os.path.join(TESTS, "torch_cases")
TIMEOUT_S = 600
# Plugins the cases never use, whose imports cost a child about a second:
# hypothesis's, jaxtyping's and anyio's.
UNUSED_PLUGINS = ("hypothesispytest", "jaxtyping", "anyio")


def _child_report(filename):
    """{case id: (outcome, message)} of one child run of ``filename``, and
    the end of the child's output."""
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "report.xml")
        cmd = [
            sys.executable, "-m", "pytest", os.path.join(CASES_DIR, filename),
            "-q", "-p", "no:cacheprovider", "-o", "addopts=", f"--junitxml={report}",
            *(f"-pno:{name}" for name in UNUSED_PLUGINS),
        ]
        try:
            proc = subprocess.run(
                cmd, cwd=os.path.dirname(TESTS), capture_output=True, text=True,
                timeout=TIMEOUT_S,
            )
        except subprocess.TimeoutExpired:
            return {}, f"no result within {TIMEOUT_S} s"
        log = (proc.stdout + proc.stderr)[-6000:]
        if not os.path.exists(report):
            return {}, log
        results = {}
        for case in ET.parse(report).getroot().iter("testcase"):
            outcome, message = "passed", ""
            for tag in ("failure", "error", "skipped"):
                el = case.find(tag)
                if el is not None:
                    outcome = tag
                    message = el.get("message", "") + "\n" + (el.text or "")
                    break
            results[case.get("name")] = (outcome, message)
    return results, log


def run_cases(filename):
    """Run ``torch_cases/filename`` in a child process. Fails, listing each
    failed case, unless every case passed; skips when every case skipped."""
    results, log = _child_report(filename)
    if not results:
        pytest.fail(f"the child run of {filename} reported no cases:\n{log}", pytrace=False)
    bad = {k: v for k, v in results.items() if v[0] in ("failure", "error")}
    if bad:
        pytest.fail(
            f"{len(bad)} of {len(results)} cases of {filename} failed:\n\n"
            + "\n\n".join(f"{k}: {outcome}\n{message}" for k, (outcome, message) in bad.items()),
            pytrace=False,
        )
    skipped = [v[1] for v in results.values() if v[0] == "skipped"]
    if len(skipped) == len(results):
        pytest.skip(skipped[0].strip().splitlines()[0])
