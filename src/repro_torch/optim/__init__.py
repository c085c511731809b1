from .adamw import AdamW, CosineSchedule

__all__ = ["AdamW", "CosineSchedule"]
