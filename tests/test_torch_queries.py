"""The port's ray casts (Kernel T's plain version on the CPU), filters and
predicates against the JAX reference: the cases of
``torch_cases/cases_queries.py``, run in a child process by
``torch_child.run_cases``."""

from torch_child import run_cases


def test_queries_cases():
    run_cases("cases_queries.py")
