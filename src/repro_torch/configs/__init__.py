"""Per-architecture configs + registry (--arch <id>). Port of
``repro/configs``: the same ids, configs and shape sets."""
from repro_torch.configs.base import ArchSpec, ShapeSpec, get_arch, list_archs  # noqa: F401
