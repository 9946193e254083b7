"""Architecture registry of the PyTorch port — one module per architecture.

    from repro_torch.configs import get, all_archs
    spec = get("granite-moe-1b-a400m")
    cfg = spec.make_config()
"""

from repro_torch.configs.base import ArchSpec, ShapeCell, all_archs, get  # noqa: F401
