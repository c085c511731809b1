from .pipeline import PrefetchIterator, SyntheticLMDataset, make_train_iterator

__all__ = ["PrefetchIterator", "SyntheticLMDataset", "make_train_iterator"]
