"""Where the port's entry points put their tensors.

Every function that builds state (``SceneBuilder.finalize``, the ``zeros``
and ``from_numpy`` constructors, the scenes) takes ``device=``. ``None``
means the card: the port is written for CUDA, and a world that lands on the
CPU by default would run every kernel's plain PyTorch version without
saying so. A caller that wants the CPU, as the parity tests do, passes
``device="cpu"``.
"""

import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises when there is no CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "avian_tpu_torch: no CUDA card (torch.cuda.is_available() is False); "
            'pass device="cpu" to run the plain PyTorch versions on the CPU'
        )
    return torch.device("cuda")


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``default_device()``."""
    return default_device() if device is None else torch.device(device)
