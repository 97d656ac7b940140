"""Record the JAX reference's outputs that a case file reads from its
``<name>_reference.npz`` (``port_common.Recording``), or, with ``--check``,
run the reference and compare it with the recording. The recording holds
only what this run asked for, so record a whole file at once.

    JAX_PLATFORMS=cpu python tests/torch_cases/record_references.py [--check] \\
        cases_ccd.py [cases_...py ...]
"""

import os
import subprocess
import sys

RECORD_ENV = "AVIAN_RECORD"  # port_common.RECORD_ENV
HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    check = "--check" in sys.argv
    files = [a for a in sys.argv[1:] if not a.startswith("--")]
    env = dict(os.environ, **{RECORD_ENV: "check" if check else "record"})
    failed = 0
    for name in files:
        cmd = [sys.executable, "-m", "pytest", os.path.join(HERE, name), "-q", "-o", "addopts=",
               "-p", "no:cacheprovider"]
        failed += subprocess.run(cmd, cwd=os.path.dirname(os.path.dirname(HERE)), env=env).returncode != 0
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
