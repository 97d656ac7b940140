"""Record the JAX reference's pair queries on ``cases_contact_query.py``'s
seeded batches into ``contact_query_reference.npz`` beside this file (only
the batches named, where names are given), or, with ``--check``, compare a
fresh run of the reference with the recording bit for bit. Compiling the
reference for every batch takes some 10 minutes on 8 CPU cores, which is why
the case file reads a recording.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests:tests/torch_cases \\
        python tests/torch_cases/record_contact_query.py [--check] [batch ...]
"""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from cases_contact_query import BATCHES, OUTPUTS, RECORDING, batch, digest, recorded
from cases_contact_query import reference_outputs


def main():
    names = [a for a in sys.argv[1:] if not a.startswith("--")] or [b[0] for b in BATCHES]
    with ThreadPoolExecutor(8) as ex:
        outs = dict(zip(names, ex.map(reference_outputs, names)))
    if "--check" in sys.argv:
        for name in names:
            want_digest, r = recorded(name)
            assert digest(*batch(name)) == want_digest, name
            for k in OUTPUTS:
                np.testing.assert_array_equal(outs[name][k], r[k], err_msg=f"{name} {k}")
        print(f"the reference equals the recording on {len(names)} batches")
        return
    arrays = {}
    if len(names) < len(BATCHES):
        with np.load(RECORDING) as z:
            arrays = {k: z[k] for k in z.files}
    for name in names:
        arrays[f"{name}/digest"] = np.asarray(digest(*batch(name)))
        arrays.update({f"{name}/{k}": v for k, v in outs[name].items()})
    np.savez_compressed(RECORDING, **arrays)
    print(f"recorded {len(names)} batches into {RECORDING}")


if __name__ == "__main__":
    main()
