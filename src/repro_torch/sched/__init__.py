"""Runtime scheduler pieces the port needs: the configuration-state cache
behind the executor's descriptor dedup."""

from .state_cache import CacheStats, ConfigStateCache, WritePlan, elision_ratio, nbytes_of

__all__ = ["CacheStats", "ConfigStateCache", "WritePlan", "elision_ratio", "nbytes_of"]
