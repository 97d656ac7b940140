"""Record the JAX reference's outputs that ``cases_custom_shapes.py`` reads
from ``custom_shapes_reference.npz`` (each support-map pair of the ellipsoid
takes the reference some 20 s to compile), or, with ``--check``, run the
reference and compare it with the recording:

    JAX_PLATFORMS=cpu python tests/torch_cases/record_custom_shapes.py [--check]
"""

import sys

from record_references import main

if __name__ == "__main__":
    sys.argv[1:] = [a for a in sys.argv[1:] if a.startswith("--")] + ["cases_custom_shapes.py"]
    main()
