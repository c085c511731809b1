from .engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
