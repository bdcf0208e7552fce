"""The logical mesh shape a config names (copy of the reference's
`cluster/mesh.py MeshSpec`). The ported serving path runs on one card and
reads no mesh; the field rides along so the config ladder stays equal to
the reference's field for field."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``data=-1`` means "all remaining devices"."""

    data: int = -1
    model: int = 1
    seq: int = 1
    pipe: int = 1
