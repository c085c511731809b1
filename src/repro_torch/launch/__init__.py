"""Entry points of the port: batched serving
(``python -m repro_torch.launch.serve``) and training
(``python -m repro_torch.launch.train``)."""
