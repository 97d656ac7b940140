"""Character controller utilities (port of ``avian_tpu/character``, the
reference's ``src/character_controller/``)."""

from avian_tpu_torch.character.move_and_slide import (MoveAndSlideConfig, depenetrate,
                                                      move_and_slide, project_velocity)

__all__ = ["MoveAndSlideConfig", "move_and_slide", "depenetrate", "project_velocity"]
