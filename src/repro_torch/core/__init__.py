"""The accelerator models the port's compute model prices launches on (a
copy of the part of ``repro.core`` the port needs; the accfg IR is not
ported)."""

from .accelerators import REGISTRY, AcceleratorModel

__all__ = ["REGISTRY", "AcceleratorModel"]
