"""The port's standalone pair queries and Kernel AI's plain version
(``avian_tpu_torch.contact_query``) against the JAX reference on seeded
pairs of every canonical shape pair, swapped and not, and the reference's
own contact-query cases: the cases of ``torch_cases/cases_contact_query.py``,
run in a child process by ``torch_child.run_cases``."""

from torch_child import run_cases


def test_contact_query_cases():
    run_cases("cases_contact_query.py")
