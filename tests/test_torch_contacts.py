"""The port's contact persistence (Kernel F's twin on CPU) against the JAX
reference's narrowphase stage, on a pile and a pyramid over two steps: the cases of
``torch_cases/cases_contacts.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_contacts_cases():
    run_cases("cases_contacts.py")
